"""Utilities of the PyTorch port: device selection and JAX weight loading."""

from .device import resolve_device
from .jax_weights import load_jax_params

__all__ = ["resolve_device", "load_jax_params"]
