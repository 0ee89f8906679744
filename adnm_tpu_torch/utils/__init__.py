"""Logging and profiling helpers of the port."""
