"""Checkpoint IO (counterpart of ``keds_tpu.io``)."""
