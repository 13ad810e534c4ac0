"""Device ms an evaluation of the score U-Net: the kernels launched in the
program's ``gradtts.unet`` spans over the count of those spans."""
from benchmark.spans import unet_ms as read  # noqa: F401
