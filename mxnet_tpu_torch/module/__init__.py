"""Module API (parity: mxnet_tpu/module)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
