"""The yardstick: weights, traffic, plain reference, work counts, timing."""
