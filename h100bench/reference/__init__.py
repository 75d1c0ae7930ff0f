"""Plain PyTorch references, one module per architecture. They import
nothing of ``instageo_tpu_torch`` and nothing of JAX."""
