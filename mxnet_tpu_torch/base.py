"""Foundation types for mxnet_tpu_torch (parity: mxnet_tpu/base.py)."""
from __future__ import annotations

__all__ = ["MXNetError", "string_types", "numeric_types"]


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (parity: reference python/mxnet/base.py MXNetError)."""


string_types = (str,)
numeric_types = (float, int)
