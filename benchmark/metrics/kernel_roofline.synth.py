"""The hand kernels' least time over their traced device time (%)."""
from benchmark.readers import kernel_roofline as read  # noqa: F401
