"""Kernel launches in the traced window over the calls completed."""
from benchmark.readers import launches_per_call as read  # noqa: F401
