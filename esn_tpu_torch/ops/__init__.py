"""Tensor ops of the port (counterpart of ``esn_tpu/ops``)."""
from .convolution import (conv2d, conv2d_transpose,  # noqa: F401
                          conv_output_size, depthwise_conv2d)
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      global_avg_pool, max_pool2d,
                      max_pool2d_with_indices_2x2, max_unpool2d_2x2)
from .resize import resize_bilinear, resize_nearest_cv2  # noqa: F401
