"""Model zoo of the port; Fast-SCNN so far."""
from . import fastscnn  # noqa: F401  (registers the model)
from .registry import available_models, build_model, register  # noqa: F401
