"""Symbol — declarative graph construction (parity: mxnet_tpu/symbol.py).

A Symbol is a DAG of ``_Node``s.  Binding it (executor.py) interprets the
graph with PyTorch ops; autograd supplies the backward pass.

Shape inference: per-op ``infer_shape`` hooks (≙ FInferShape) give
bidirectional parameter-shape inference; an op without one is run
forward-only on the ``meta`` device, which computes shapes and allocates
nothing (the role ``jax.eval_shape`` plays in the JAX package).
"""
from __future__ import annotations

import torch

from . import attribute, name as _name_mod
from .base import MXNetError
from .ops.params import validate_attrs
from .ops.registry import OP_REGISTRY, get_op
from .ops.tensor import _bool, _shape

__all__ = ["Symbol", "Variable", "var"]


class _Node:
    """One graph node: a registered op application or a variable."""

    __slots__ = ("op", "name", "attrs", "inputs", "aux_vars", "is_aux")

    def __init__(self, op, name, attrs=None, inputs=(), aux_vars=(), is_aux=False):
        self.op = op  # Op instance or None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # list of (_Node, out_index)
        self.aux_vars = list(aux_vars)  # _Node list for ops with aux state
        self.is_aux = is_aux

    @property
    def num_outputs(self):
        if self.op is None:
            return 1
        n = self.op.num_outputs
        return n(self.attrs) if callable(n) else n


def _topo_order(entries):
    """Post-order DFS over (node, idx) output entries."""
    order, visited = [], set()
    stack = [e[0] for e in entries]
    while stack:
        node = stack[-1]
        if id(node) in visited:
            stack.pop()
            continue
        pending = [n for (n, _) in node.inputs if id(n) not in visited]
        pending += [n for n in node.aux_vars if id(n) not in visited]
        if pending:
            # push in reverse so the FIRST input is visited first — keeps
            # list_arguments() in composition order (parity: nnvm DFSVisit)
            stack.extend(reversed(pending))
        else:
            visited.add(id(node))
            order.append(node)
            stack.pop()
    return order


class Symbol:
    """Symbolic graph handle over one or more output entries."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def list_arguments(self):
        return [n.name for n in _topo_order(self._entries) if n.op is None and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in _topo_order(self._entries) if n.op is None and n.is_aux]

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.op is None:
                out.append(node.name)
            elif node.num_outputs == 1:
                out.append(node.name + "_output")
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "grouped")

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    # attributes
    # ------------------------------------------------------------------
    def attr_dict(self):
        ret = {}
        for node in _topo_order(self._entries):
            if node.attrs:
                ret[node.name] = {k: str(v) for k, v in node.attrs.items()}
        return ret

    # ------------------------------------------------------------------
    # composition arithmetic: ResNet's `conv3 + shortcut`
    # ------------------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("mxnet_tpu_torch: Symbol + %s is not supported; "
                             "only Symbol + Symbol" % type(other).__name__)
        return _create("elemwise_add", [self, other], {})

    __radd__ = __add__

    # ------------------------------------------------------------------
    # shape inference
    # ------------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input shapes."""
        arg_names = self.list_arguments()
        known = {n: tuple(s) for n, s in zip(arg_names, args) if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        try:
            node_shapes, var_shapes = _infer_graph_shapes(self._entries, known)
        except MXNetError:
            raise
        except Exception as e:  # parity: a failed inference reports MXNetError
            raise MXNetError("infer_shape error: %s" % e)
        arg_shapes = [var_shapes.get(n) for n in arg_names]
        aux_shapes = [var_shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [node_shapes[(id(nd), ix)] for nd, ix in self._entries]
        return arg_shapes, out_shapes, aux_shapes

    # ------------------------------------------------------------------
    # binding (executor.py; imported lazily to avoid a cycle)
    # ------------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", **kwargs):
        from .executor import Executor

        return Executor.simple_bind(self, ctx, grad_req=grad_req, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write", aux_states=None):
        from .executor import Executor

        return Executor.bind(self, ctx, args, args_grad, grad_req, aux_states)


# ----------------------------------------------------------------------
# graph-wide shape inference
# ----------------------------------------------------------------------


def _infer_graph_shapes(entries, known_var_shapes):
    """Topological forward inference with per-op FInferShape hooks.

    Returns ({(node_id, out_idx): shape}, {var_name: shape}).
    """
    order = _topo_order(entries)
    node_shapes = {}
    var_shapes = dict(known_var_shapes)
    for node in order:
        if node.op is None:
            shp = var_shapes.get(node.name)
            if shp is None and "__shape__" in node.attrs:
                shp = _shape(node.attrs["__shape__"])
                var_shapes[node.name] = shp
            node_shapes[(id(node), 0)] = shp
            continue
        in_shapes = [node_shapes.get((id(src), idx)) for src, idx in node.inputs]
        aux_shapes_in = [var_shapes.get(a.name) for a in node.aux_vars]
        out_shapes = None
        if node.op.infer_shape is not None and any(s is not None for s in in_shapes):
            res = node.op.infer_shape(in_shapes, node.attrs)
            if len(res) == 3:
                full_in, out_shapes, aux_shapes = res
            else:
                full_in, out_shapes = res
                aux_shapes = []
            for (src, idx), s in zip(node.inputs, full_in):
                if s is not None:
                    node_shapes[(id(src), idx)] = tuple(s)
                    if src.op is None:
                        var_shapes[src.name] = tuple(s)
            for a, s in zip(node.aux_vars, aux_shapes):
                var_shapes[a.name] = tuple(s)
        elif all(s is not None for s in in_shapes):
            out_shapes = _meta_shape_infer(node, in_shapes, aux_shapes_in)
        if out_shapes is None:
            missing = [src.name for (src, idx), s in zip(node.inputs, in_shapes) if s is None]
            raise MXNetError(
                "Cannot infer shapes for node %s (op %s); unknown inputs: %s"
                % (node.name, node.op.name, missing)
            )
        for i, s in enumerate(out_shapes):
            node_shapes[(id(node), i)] = tuple(s)
    return node_shapes, var_shapes


def _op_kwargs(node):
    """The attrs an op's fn receives: dunder bookkeeping attrs and ctx_group
    placement hints never reach it."""
    return {k: v for k, v in node.attrs.items()
            if not k.startswith("__") and k != "ctx_group"}


def _meta_shape_infer(node, in_shapes, aux_shapes):
    """Output shapes of `node` from one forward on the meta device."""
    shapes = list(in_shapes)
    if aux_shapes and all(s is not None for s in aux_shapes):
        shapes += aux_shapes
    xs = [torch.empty(s, dtype=torch.float32, device="meta") for s in shapes]
    kwargs = _op_kwargs(node)
    if node.op.need_is_train:
        kwargs["is_train"] = False
    res = node.op.fn(*xs, **kwargs)
    if not isinstance(res, tuple):
        res = (res,)
    return [tuple(r.shape) for r in res[:node.num_outputs]]


# ----------------------------------------------------------------------
# construction API
# ----------------------------------------------------------------------


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None, init=None, **kwargs):
    """Create a variable symbol (parity: symbol.py Variable)."""
    attrs = attribute.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def _create(op_name, input_syms, attrs, name=None, aux_syms=None):
    """Create an op node (parity: mxnet_tpu symbol._create)."""
    op = get_op(op_name)
    hint = op.name.lower().lstrip("_")
    name = _name_mod.current().get(name, hint)
    full_attrs = dict(attribute.current().get(None))
    full_attrs.update(attrs)
    validate_attrs(op, full_attrs)
    inputs = []
    for s in input_syms:
        if len(s._entries) != 1:
            raise MXNetError("Cannot use grouped symbol as op input")
        inputs.append(s._entries[0])
    # auto-create missing weight/bias/label variables (parity: nnvm Symbol
    # compose auto-creating named variable nodes for unbound op inputs)
    if not op.variadic:
        declared = op.inputs
        while len(inputs) < len(declared):
            slot = declared[len(inputs)]
            if slot == "bias" and _bool(full_attrs.get("no_bias", False)):
                break
            var_node = _Node(None, "%s_%s" % (name, slot))
            if slot == "weight" and op.name == "Convolution":
                lay = str(full_attrs.get("layout", ""))
                if lay.endswith("C"):  # channel-last: kernel stored spatial+IO
                    var_node.attrs["__layout__"] = lay[1:-1] + "IO"
            inputs.append((var_node, 0))
    aux_vars = []
    if aux_syms:
        for s in aux_syms:
            aux_vars.append(s._entries[0][0])
            aux_vars[-1].is_aux = True
    else:
        for aux_name in op.aux:
            aux_vars.append(_Node(None, "%s_%s" % (name, aux_name), is_aux=True))
    node = _Node(op, name, full_attrs, inputs, aux_vars)
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _make_sym_function(op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        input_syms = list(args)
        aux_syms = None
        sym_kwargs = {}
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            elif isinstance(v, (list, tuple)) and v and all(isinstance(x, Symbol) for x in v):
                input_syms.extend(v)
            else:
                attrs[k] = v
        if sym_kwargs:
            # map keyword symbols onto declared input slots
            if not input_syms and not op.variadic:
                ordered = []
                for in_name in op.inputs:
                    if in_name in sym_kwargs:
                        ordered.append(sym_kwargs.pop(in_name))
                    elif sym_kwargs:
                        break
                input_syms = ordered
            aux_named = [sym_kwargs.pop(a) for a in op.aux if a in sym_kwargs]
            if aux_named:
                aux_syms = aux_named
            input_syms.extend(sym_kwargs.values())
        if attr:
            merged = dict(attribute.current().get(attr))
            merged.update(attrs)
            attrs = merged
        return _create(op.name, input_syms, attrs, name=name, aux_syms=aux_syms)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _populate(module):
    import sys

    seen = {}
    mod = sys.modules[module]
    for reg_name, op in OP_REGISTRY.items():
        if id(op) not in seen:
            seen[id(op)] = _make_sym_function(op)
        if not hasattr(mod, reg_name):
            setattr(mod, reg_name, seen[id(op)])


_populate(__name__)
