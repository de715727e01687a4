"""Weight initializers (parity: mxnet_tpu/initializer.py).

Initializers sample on the host from ``HOST_RNG`` (one numpy RandomState)
and cast to float32 before the copy, exactly as the JAX package does, so
one seed and one drawing order give bit-identical parameters in both.
"""
from __future__ import annotations

import json
import math

import numpy as _np

from .base import MXNetError
from .ops.random_ops import HOST_RNG

__all__ = ["InitDesc", "Initializer", "Uniform", "Zero", "One", "Xavier", "register"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs descriptor for initialization (parity: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            arr[:] = 0.0
        elif name.endswith("moving_var") or name.endswith("running_var"):
            arr[:] = 1.0
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s. Default initialization "
                "is limited to *_weight/*_bias/*_gamma/*_beta." % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError()


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = HOST_RNG.uniform(-self.scale, self.scale, arr.shape).astype(_np.float32)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Xavier(Initializer):
    """Xavier/Glorot (parity: initializer.py Xavier).  A weight whose
    ``__layout__`` attr ends in "IO" is a channel-last conv kernel
    (spatial..., I, O): its fans are taken over those dims."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2: %s" % str(name))
        layout = getattr(name, "attrs", {}).get("__layout__", "")
        if layout.endswith("IO"):
            hw_scale = _np.prod(shape[:-2]) if len(shape) > 2 else 1.0
            fan_in, fan_out = shape[-2] * hw_scale, shape[-1] * hw_scale
        else:
            if len(shape) > 2:
                hw_scale = _np.prod(shape[2:])
            fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = HOST_RNG.uniform(-scale, scale, arr.shape).astype(_np.float32)
        else:
            arr[:] = HOST_RNG.normal(0.0, scale, arr.shape).astype(_np.float32)
