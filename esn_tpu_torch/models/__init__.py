"""Model zoo of the port: Fast-SCNN, ContextNet, CGNet, ENet, ERFNet,
EDANet, SegNet and LinkNet so far."""
from . import (cgnet, contextnet, edanet, enet, erfnet, fastscnn,  # noqa: F401
               linknet, segnet)  # (register the models)
from .registry import available_models, build_model, register  # noqa: F401
