"""Training of the segmentation model (counterpart of ``instageo_tpu.train``)."""
