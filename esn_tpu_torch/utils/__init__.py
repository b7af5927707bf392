"""Utilities of the port."""
from .params import count_params  # noqa: F401
