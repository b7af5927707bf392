"""Module layer of the port: ``SegModel`` and the plain layers."""
from .core import SegModel  # noqa: F401
from .layers import (BatchNorm, Conv, Dropout, PReLU, relu,  # noqa: F401
                     relu6, set_dropout_generator)
