"""Engines: uniform and two-stage partitioned convolution."""
