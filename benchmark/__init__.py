"""The benchmark of keds_tpu_torch: see run.py."""
