"""One module per traffic ``kind``: ``run(ctx)`` builds the system under
test, warms it, measures one window and returns what the check needs."""
