"""NDArray over a ``torch.Tensor`` (parity: mxnet_tpu/ndarray.py NDArray).

The port has no dependency engine and no lazy chains: PyTorch already
orders work on a device through its stream, and ``asnumpy`` is the sync
point.  An NDArray owns one tensor on its context's device; ``arr[:] = v``
copies into that tensor in place.
"""
from __future__ import annotations

import numpy as _np
import torch

from .context import current_context

__all__ = ["NDArray", "array", "zeros", "empty", "to_torch_dtype"]

_NP_TO_TORCH = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def to_torch_dtype(dtype):
    """torch dtype for a numpy dtype, a dtype name ('bfloat16' included) or
    a torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[_np.dtype(dtype)]


def _as_tensor(value, device, dtype=None):
    """`value` (NDArray, tensor, numpy array, list or scalar) as a tensor on
    `device`."""
    if isinstance(value, NDArray):
        value = value.data
    if not isinstance(value, torch.Tensor):
        arr = _np.asarray(value)
        if arr.dtype == _np.float64 and dtype is None:
            arr = arr.astype(_np.float32)
        value = torch.from_numpy(_np.ascontiguousarray(arr))
    return value.to(device=device, dtype=dtype)


class NDArray:
    """Multi-dimensional array on a device (parity: python/mxnet/ndarray.py NDArray)."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        self._ctx = ctx if ctx is not None else current_context()
        self._data = data

    @property
    def data(self):
        """The underlying torch.Tensor."""
        return self._data

    def _set_data(self, value):
        self._data = value

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype of the payload (``torch.bfloat16`` for bf16, which
        numpy lacks)."""
        return _TORCH_TO_NP.get(self._data.dtype, self._data.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)), self._ctx)

    def asnumpy(self):
        """A host numpy copy (bf16 payloads come back as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def astype(self, dtype):
        return NDArray(self._data.to(to_torch_dtype(dtype)), self._ctx)

    def __setitem__(self, key, value):
        """In-place write, converted to this array's dtype and device."""
        tgt = self._data[key]
        if isinstance(value, (int, float)):
            tgt.fill_(value)
            return
        with torch.no_grad():
            tgt.copy_(_as_tensor(value, self._data.device, self._data.dtype))


def array(source_array, ctx=None, dtype=None):
    """NDArray copy of `source_array`; float64 host data becomes float32."""
    ctx = ctx or current_context()
    return NDArray(_as_tensor(source_array, ctx.device,
                              None if dtype is None else to_torch_dtype(dtype)), ctx)


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=to_torch_dtype(dtype), device=ctx.device), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)
