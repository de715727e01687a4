"""Tensor operators of the training slice (parity: mxnet_tpu/ops/tensor.py).

Holds the attribute-normalization helpers every op uses, plus the two
tensor ops ResNet needs: ``elemwise_add`` (what ``Symbol.__add__`` emits
for ``conv3 + shortcut``) and ``Flatten``.
"""
from __future__ import annotations

import ast

from .registry import register

# ----------------------------------------------------------------------
# attr normalization helpers (attrs may arrive as strings from saved JSON,
# parity: reference symbol JSON attrs are all strings)
# ----------------------------------------------------------------------


def _lit(v):
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _shape(v):
    v = _lit(v)
    if v is None:
        return None
    if isinstance(v, int):
        return (v,)
    return tuple(int(x) for x in v)


def _bool(v):
    v = _lit(v)
    if isinstance(v, str):
        return v in ("True", "true", "1")
    return bool(v)


# ----------------------------------------------------------------------
# elementwise add
# ----------------------------------------------------------------------


def _infer_binary_unify(in_shapes, attrs):
    """Broadcast-unify two shapes treating 0 dims as unknown (MXNet shape
    convention: 0 = infer me)."""
    a, b = in_shapes
    if a is None or b is None:
        return list(in_shapes), None
    la, lb = list(a), list(b)
    n = max(len(la), len(lb))
    pa = [1] * (n - len(la)) + la
    pb = [1] * (n - len(lb)) + lb
    out = []
    for da, db in zip(pa, pb):
        if da == 0 and db == 0:
            out.append(0)
        elif da == 0:
            out.append(db)
        elif db == 0:
            out.append(da)
        elif da == db or db == 1:
            out.append(da)
        elif da == 1:
            out.append(db)
        else:
            raise ValueError("incompatible shapes %s, %s" % (a, b))
    ra = tuple(o if d == 0 else d for d, o in zip(pa, out))[n - len(la):]
    rb = tuple(o if d == 0 else d for d, o in zip(pb, out))[n - len(lb):]
    if 0 in out:
        return [ra, rb], None
    return [ra, rb], [tuple(out)]


@register("elemwise_add", inputs=("lhs", "rhs"), infer_shape=_infer_binary_unify,
          aliases=("_plus", "_Plus", "broadcast_add", "broadcast_plus"))
def elemwise_add(lhs, rhs, **kw):
    return lhs + rhs


@register("Flatten", aliases=("flatten",))
def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)
