"""Training data (counterpart of ``keds_tpu.data``)."""
