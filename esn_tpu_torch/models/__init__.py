"""Model zoo of the port: Fast-SCNN and CGNet so far."""
from . import cgnet, fastscnn  # noqa: F401  (register the models)
from .registry import available_models, build_model, register  # noqa: F401
