"""Operator library of the port: importing this package registers every op."""
from . import registry
from . import tensor
from . import nn
from . import optim_ops
from .registry import OP_REGISTRY, get_op, register

__all__ = ["registry", "OP_REGISTRY", "get_op", "register"]
