"""Head training on precomputed CLIP features (counterpart of ``keds_tpu.train``)."""
