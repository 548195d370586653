"""Offline tools (counterpart of ``keds_tpu.tools``)."""
