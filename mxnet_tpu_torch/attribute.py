"""Attribute scoping (parity: mxnet_tpu/attribute.py, reference python/mxnet/attribute.py)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        if attr:
            ret = self._attr.copy()
            ret.update(attr)
            return ret
        return self._attr.copy()

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope


def current():
    if not hasattr(AttrScope._current, "value") or AttrScope._current.value is None:
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
