"""Model zoo of the port: Fast-SCNN, ContextNet, CGNet, ENet, ERFNet,
EDANet, SegNet, LinkNet, ESPNetv2, DABNet, ESPNet-C and ESPNet so far."""
from . import (cgnet, contextnet, dabnet, edanet, enet, erfnet,  # noqa: F401
               espnet, espnetv2, fastscnn, linknet, segnet)  # (register them)
from .registry import available_models, build_model, register  # noqa: F401
