"""Module layer of the port: ``SegModel`` and the plain layers."""
from .core import SegModel  # noqa: F401
from .layers import (BatchNorm, Conv, ConvTranspose, Dense,  # noqa: F401
                     Dropout, PReLU, SpatialDropout, relu, relu6,
                     set_dropout_generator)
