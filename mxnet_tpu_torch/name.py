"""Automatic symbol naming (parity: mxnet_tpu/name.py, reference python/mxnet/name.py)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "current"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        self._old_manager = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


def current():
    if not hasattr(NameManager._current, "value") or NameManager._current.value is None:
        NameManager._current.value = NameManager()
    return NameManager._current.value
