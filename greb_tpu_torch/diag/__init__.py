"""Diagnostics, profiling, observability."""
