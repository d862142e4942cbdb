"""Utilities: bit packing, serialization, profiling hooks."""
