"""Data, ZeRO-1, FSDP, tensor, sequence and pipeline parallelism over
``torch.distributed`` (counterpart of ``instageo_tpu.parallel``)."""
