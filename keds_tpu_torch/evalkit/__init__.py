"""Evaluation: metrics and the benchmark sweeps."""
