"""Per-layer metric readers: ``read(trace, ctx)`` returns a number or None
(nothing to read). ``metrics/<name>.py`` is looked up first, then
``metrics/<name before the first dot>.py``, which reads every suffix."""
