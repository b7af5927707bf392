"""Tensor ops of the port (counterpart of ``esn_tpu/ops``)."""
from .convolution import conv2d, conv_output_size, depthwise_conv2d  # noqa: F401
from .pooling import adaptive_avg_pool2d, avg_pool2d, global_avg_pool  # noqa: F401
from .resize import resize_bilinear  # noqa: F401
