"""Operator registry (parity: mxnet_tpu/ops/registry.py).

Each op is registered once as a plain function on ``torch.Tensor``s plus
metadata:
  * ``fn(*inputs, **attrs)`` computes the op; gradients come from
    torch.autograd, and ops whose backward differs from the derivative of
    their forward (SoftmaxOutput ignores head gradients) wrap a
    ``torch.autograd.Function``.
  * ``inputs`` / ``aux`` name lists let Symbol auto-create variable nodes.
  * ``infer_shape`` gives bidirectional parameter-shape inference; ops
    without one are inferred forward-only on the ``meta`` device.
  * ``need_is_train``: fn takes ``is_train=``.
  * ``num_aux_out``: ops that update auxiliary state in training
    (BatchNorm moving stats) return that many extra tensors, which the
    executor threads back into the aux arrays.
"""
from __future__ import annotations

__all__ = ["Op", "register", "get_op", "OP_REGISTRY"]

OP_REGISTRY = {}


class Op:
    """Metadata for one registered operator."""

    __slots__ = ("name", "fn", "inputs", "aux", "num_outputs", "infer_shape",
                 "aliases", "need_is_train", "num_aux_out", "variadic", "doc",
                 "params")

    def __init__(self, name, fn, inputs=("data",), aux=(), num_outputs=1,
                 infer_shape=None, aliases=(), need_is_train=False,
                 num_aux_out=0, variadic=False, doc="", params=None):
        self.name = name
        self.fn = fn
        self.inputs = tuple(inputs)
        self.aux = tuple(aux)
        self.num_outputs = num_outputs
        self.infer_shape = infer_shape
        self.aliases = tuple(aliases)
        self.need_is_train = need_is_train
        self.num_aux_out = num_aux_out
        self.variadic = variadic
        self.doc = doc
        # declarative parameter specs (dmlc::Parameter analog, ops/params.py)
        self.params = params


def register(name, **kwargs):
    """Decorator registering `fn` as operator `name`.

    Extra keyword arguments are forwarded to :class:`Op`.
    """

    def _reg(fn):
        op = Op(name, fn, doc=fn.__doc__ or "", **kwargs)
        OP_REGISTRY[name] = op
        for alias in op.aliases:
            OP_REGISTRY[alias] = op
        return fn

    return _reg


def get_op(name):
    if name not in OP_REGISTRY:
        raise KeyError("Operator %s is not registered" % name)
    return OP_REGISTRY[name]
