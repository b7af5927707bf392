"""Model zoo of the port: Fast-SCNN, CGNet and ENet so far."""
from . import cgnet, enet, fastscnn  # noqa: F401  (register the models)
from .registry import available_models, build_model, register  # noqa: F401
