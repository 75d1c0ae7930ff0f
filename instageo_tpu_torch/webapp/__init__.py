"""Web platform: the task API, the queue and its three stages, COGs, map tiles."""
