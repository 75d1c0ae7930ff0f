"""The environment a run sets before it imports torch or the program: the
program's compile caches at fixed paths inside the checkout, so that only a
cell's first run in a checkout builds (``INSTAGEO_COMPILE_CACHE_DIR`` for
the port's nvcc libraries, Triton's, torch's extensions' and Inductor's),
and no library that would load JAX on its own."""

import os

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def set_up() -> None:
    os.environ["INSTAGEO_COMPILE_CACHE"] = "1"
    os.environ["INSTAGEO_COMPILE_CACHE_DIR"] = os.path.join(CACHE, "instageo")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
