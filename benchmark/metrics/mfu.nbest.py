"""Model FLOPs of the calls completed in the measured window over its
seconds and the peak (%)."""
from benchmark.readers import mfu as read  # noqa: F401
