"""Process groups and data parallelism (counterpart of ``keds_tpu.parallel``)."""
