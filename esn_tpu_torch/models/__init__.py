"""Model zoo of the port, the reference's 18 models: Fast-SCNN,
ContextNet, CGNet, ENet, ERFNet, EDANet, SegNet, LinkNet, ESPNetv2,
DABNet, ESPNet-C, ESPNet, LEDNet, ESNet, FPENet, FSSNet, SQNet and
UNet."""
from . import (cgnet, contextnet, dabnet, edanet, enet, erfnet,  # noqa: F401
               esnet, espnet, espnetv2, fastscnn, fpenet, fssnet, lednet,
               linknet, segnet, sqnet, unet)  # (register them)
from .registry import available_models, build_model, register  # noqa: F401
