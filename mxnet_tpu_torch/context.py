"""Device contexts (parity: mxnet_tpu/context.py, reference python/mxnet/context.py).

Every Context carries an explicit ``torch.device``.  ``gpu(i)`` is CUDA
device ``i`` and nothing else: when that device does not exist it raises
``MXNetError`` instead of quietly running on the CPU.  ``tpu()`` is an
alias of ``gpu()`` so scripts written for mxnet_tpu run unchanged.  The
default context is ``gpu(0)``; a caller that wants the CPU says so with
``mx.cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context"]

_NO_CUDA = ("no CUDA device %d is available (this process sees %d); "
            "pass context=mx.cpu() to run on the CPU")


class Context:
    """Execution device context.

    Parameters
    ----------
    device_type : str
        'cpu', 'gpu' or 'tpu' ('tpu' is an alias of 'gpu').
    device_id : int
        Device ordinal.
    """

    # device type ids as in the reference ABI (cpu=1, gpu=2)
    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2}

    _current = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        if self.device_typeid == 2:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if not 0 <= self.device_id < count:
                raise MXNetError(_NO_CUDA % (self.device_id, count))
            self.device = torch.device("cuda", self.device_id)
        else:
            self.device = torch.device("cpu")
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._current, "value", None)
        Context._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._current.value = self._old_ctx


def cpu(device_id=0):
    """Return a CPU context (parity: mx.cpu())."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return CUDA device ``device_id``; raises MXNetError if it does not exist."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, kept so mxnet_tpu scripts run unchanged."""
    return gpu(device_id)


def current_context():
    """The innermost ``with Context(...)`` scope, else ``gpu(0)``."""
    cur = getattr(Context._current, "value", None)
    if cur is not None:
        return cur
    return gpu(0)
