"""Shared helpers of the ``test_torch_*`` parity tests (JAX package vs port)."""

import jax
import jax.numpy as jnp
import numpy as np


def random_seg_variables(model, temporal_step: int, image_size: int, seed: int):
    """Seeded numpy variables for a JAX ``PrithviSeg`` without running its
    init: shapes from ``jax.eval_shape``, values drawn so that every leaf
    (biases and BatchNorm statistics included) carries information through
    the weight bridge. Kernels are N(0, 1/fan_in), the rest near their
    usual init."""
    x0 = jax.ShapeDtypeStruct((1, 6, temporal_step, image_size, image_size), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x0)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = shape[0] if "qkv" in str(path) or len(shape) == 2 \
                else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
