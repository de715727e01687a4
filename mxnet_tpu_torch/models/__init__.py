"""Model zoo of the port (parity: mxnet_tpu/models)."""
from . import resnet
from .resnet import get_resnet

__all__ = ["resnet", "get_resnet"]
