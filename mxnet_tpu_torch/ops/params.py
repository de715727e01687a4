"""Declarative operator parameters — the dmlc::Parameter analog
(parity: mxnet_tpu/ops/params.py).

An op may attach ``params={name: spec}`` at registration; attrs are
validated and coerced from their string forms when the symbol is built,
so a typo'd or out-of-range attribute raises a clear MXNetError naming
the op and field.
"""
from __future__ import annotations

from ..base import MXNetError
from .tensor import _bool, _lit, _shape

__all__ = ["Int", "Float", "Bool", "Shape", "Enum", "validate_attrs"]


class _Spec:
    kind = "value"

    def __init__(self, default=None, required=False, desc="", low=None, high=None):
        self.default = default
        self.required = required
        self.desc = desc
        self.low = low
        self.high = high

    def _range_check(self, op, key, v):
        if self.low is not None and v < self.low:
            raise MXNetError("%s: parameter %s=%r must be >= %r (%s)"
                             % (op, key, v, self.low, self.desc or self.kind))
        if self.high is not None and v > self.high:
            raise MXNetError("%s: parameter %s=%r must be <= %r (%s)"
                             % (op, key, v, self.high, self.desc or self.kind))
        return v

    def coerce(self, op, key, value):
        raise NotImplementedError


class Int(_Spec):
    kind = "int"

    def coerce(self, op, key, value):
        v = _lit(value)
        if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v:
            raise MXNetError("%s: parameter %s expects an int, got %r"
                             % (op, key, value))
        return self._range_check(op, key, int(v))


class Float(_Spec):
    kind = "float"

    def coerce(self, op, key, value):
        v = _lit(value)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise MXNetError("%s: parameter %s expects a float, got %r"
                             % (op, key, value))
        return self._range_check(op, key, float(v))


class Bool(_Spec):
    kind = "bool"

    def coerce(self, op, key, value):
        try:
            return _bool(value)
        except (ValueError, TypeError):
            raise MXNetError("%s: parameter %s expects a bool, got %r"
                             % (op, key, value))


class Shape(_Spec):
    kind = "shape"

    def __init__(self, ndim=None, **kw):
        super().__init__(**kw)
        self.ndim = ndim

    def coerce(self, op, key, value):
        try:
            v = _shape(value)
        except (ValueError, TypeError):
            v = None
        if v is None:
            raise MXNetError("%s: parameter %s expects a shape tuple, got %r"
                             % (op, key, value))
        if self.ndim is not None and len(v) not in (
                (self.ndim,) if isinstance(self.ndim, int) else tuple(self.ndim)):
            raise MXNetError("%s: parameter %s=%r must have %s dims"
                             % (op, key, v, self.ndim))
        for d in v:
            self._range_check(op, key, d)
        return v


class Enum(_Spec):
    kind = "enum"

    def __init__(self, choices, **kw):
        super().__init__(**kw)
        self.choices = tuple(choices)

    def coerce(self, op, key, value):
        v = str(value)
        if v not in self.choices:
            raise MXNetError("%s: parameter %s=%r must be one of %s"
                             % (op, key, v, list(self.choices)))
        return v


def validate_attrs(op, attrs):
    """Validate/coerce declared attrs in-place; raise MXNetError on bad or
    missing-required parameters.  Undeclared attrs pass through untouched."""
    specs = getattr(op, "params", None)
    if not specs:
        return attrs
    for key, spec in specs.items():
        if key in attrs and attrs[key] is not None:
            attrs[key] = spec.coerce(op.name, key, attrs[key])
        elif spec.required:
            raise MXNetError("%s: required parameter %s is missing (%s)"
                             % (op.name, key, spec.desc or spec.kind))
    return attrs
