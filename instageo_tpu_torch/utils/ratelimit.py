"""Rate limiting and exponential backoff decorators.

The port's own copy of ``instageo_tpu/utils/ratelimit.py``: they stand in
for the ``ratelimit`` and ``backoff`` packages on the STAC and COG paths.
"""

from __future__ import annotations

import functools
import logging
import random
import threading
import time
from collections import deque
from typing import Callable, Tuple, Type

log = logging.getLogger(__name__)


def rate_limited(calls: int, period: float = 60.0) -> Callable:
    """Allow at most ``calls`` invocations per ``period`` seconds (blocking)."""

    def deco(fn):
        times: deque = deque()
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            while True:
                with lock:
                    now = time.monotonic()
                    while times and now - times[0] > period:
                        times.popleft()
                    if len(times) < calls:
                        times.append(now)
                        break
                    wait = period - (now - times[0])
                time.sleep(max(wait, 0.01))
            return fn(*args, **kwargs)

        return wrapper

    return deco


def retry_backoff(
    exceptions: Tuple[Type[BaseException], ...] = (Exception,),
    max_tries: int = 5,
    max_time: float = 300.0,
    base: float = 1.0,
    jitter: bool = True,
) -> Callable:
    """Exponential backoff with full jitter (like ``backoff.on_exception``)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            start = time.monotonic()
            for attempt in range(max_tries):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    elapsed = time.monotonic() - start
                    if attempt == max_tries - 1 or elapsed >= max_time:
                        raise
                    delay = base * (2 ** attempt)
                    if jitter:
                        delay = random.uniform(0, delay)
                    delay = min(delay, max(0.0, max_time - elapsed))
                    log.warning("%s failed (%s); retry %d/%d in %.1fs",
                                fn.__name__, e, attempt + 1, max_tries, delay)
                    time.sleep(delay)
            raise RuntimeError("unreachable")

        return wrapper

    return deco
