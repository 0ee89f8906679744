"""Logging, profiling and numerics-debugging helpers of the port."""
