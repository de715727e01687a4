"""Executor — binds a Symbol to a device and runs it (parity: mxnet_tpu/executor.py).

The graph is interpreted node by node with PyTorch ops (``_run_graph``);
torch.autograd supplies the backward pass.  Loss ops carry their own
``torch.autograd.Function`` so ``backward()`` without head gradients
matches the reference.

Mixed precision: with ``compute_dtype`` set, float arguments are cast to
it on entry to the graph (labels and other names in the keep set stay
fp32) and outputs are cast back to fp32 on exit.  Because the cast sits
inside the differentiated function, autograd returns fp32 gradients for
the fp32 master parameters.  Aux states (BatchNorm moving statistics)
stay in their fp32 storage dtype throughout.

Training step: ``forward(is_train=True)`` defers; ``backward()`` runs
forward and backward together.  Once ``install_fused_update`` armed an
updater, ``backward()`` defers too and ``fused_update()`` runs forward,
backward and the optimizer update in one call, writing parameters and
optimizer state in place.  Reading ``outputs`` while that step is pending
runs its forward and backward there and keeps the gradients for
``fused_update()``, so a step runs one forward whatever order the caller
reads outputs and updates in.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import current_context
from .ndarray import NDArray, to_torch_dtype, zeros
from .ops.random_ops import HOST_RNG
from .optimizer import _state_leaves
from .symbol import _op_kwargs, _topo_order

__all__ = ["Executor"]


def _run_graph(order, entries, free_after, arg_names, aux_names, arg_vals, aux_vals,
               is_train, cast=None):
    """Interpret the graph; returns (outputs tuple, aux_updates tuple ordered
    like aux_names).  `cast` is (compute_dtype, keep_fp32_names) or None.
    `free_after[i]` lists the node ids whose values no node after position
    i reads: they leave the environment there, so a tensor lives only as
    long as a consumer or autograd needs it."""

    def _to_compute(name, v):
        if cast is None:
            return v
        cdt, keep = cast
        if name in keep or not v.is_floating_point():
            return v
        return v.to(cdt)

    aux_dtypes = {n: v.dtype for n, v in zip(aux_names, aux_vals)}
    arg_env = {n: _to_compute(n, v) for n, v in zip(arg_names, arg_vals)}
    aux_env = dict(zip(aux_names, aux_vals))
    env = {}
    aux_updates = dict(aux_env)
    for i, node in enumerate(order):
        if node.op is None:
            env[id(node)] = (aux_env[node.name] if node.is_aux else arg_env[node.name],)
            continue
        op = node.op
        ins = [env[id(src)][idx] for src, idx in node.inputs]
        ins += [aux_updates[a.name] for a in node.aux_vars]
        kwargs = _op_kwargs(node)
        if op.need_is_train:
            kwargs["is_train"] = is_train
        res = op.fn(*ins, **kwargs)
        if not isinstance(res, tuple):
            res = (res,)
        if op.num_aux_out:
            main = res[:len(res) - op.num_aux_out]
            for a, upd in zip(node.aux_vars, res[len(res) - op.num_aux_out:]):
                aux_updates[a.name] = upd
            res = main
        env[id(node)] = res
        for dead in free_after[i]:
            del env[dead]
    outputs = tuple(env[id(nd)][ix] for nd, ix in entries)
    aux_out = tuple(aux_updates[n] for n in aux_names)
    if cast is not None:
        outputs = tuple(o.float() if o.is_floating_point() else o for o in outputs)
        aux_out = tuple(a.to(aux_dtypes[n]) for n, a in zip(aux_names, aux_out))
    return outputs, aux_out


def _free_plan(order, entries):
    """Per node position, the op-node ids whose last reader sits there
    (graph outputs and variables are never freed)."""
    last = {}
    for i, node in enumerate(order):
        for src, _ in node.inputs:
            if src.op is not None:
                last[id(src)] = i
    keep = {id(nd) for nd, _ in entries}
    plan = [[] for _ in order]
    for nid, i in last.items():
        if nid not in keep:
            plan[i].append(nid)
    return plan


def _norm_grad_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        reqs = dict(zip(arg_names, grad_req))
    else:
        reqs = {n: "null" for n in arg_names}
        reqs.update(grad_req)
    bad = sorted({r for r in reqs.values() if r not in ("write", "null")})
    if bad:
        raise MXNetError("grad_req %s is not supported by mxnet_tpu_torch "
                         "(only 'write' and 'null')" % bad)
    return reqs


def _advance_host_rng():
    """The JAX executor draws a per-step seed from HOST_RNG when it is built
    and at every forward.  Drawing the same here keeps the host stream in
    step with it, so one seed gives identical initial parameters in both
    packages whatever order bind, forward and init_params run in."""
    HOST_RNG.randint(0, 2 ** 31)


class Executor:
    """Bound computation graph (parity: python/mxnet/executor.py Executor)."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict,
                 compute_dtype=None, fp32_names=()):
        self._compute_dtype = to_torch_dtype(compute_dtype) if compute_dtype else None
        # names kept fp32 under compute_dtype (labels)
        self._fp32_names = frozenset(fp32_names)
        self._ctx = ctx
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._grad_req = grad_req
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._diff_names = [n for n in self._arg_names if grad_req.get(n, "null") != "null"]
        self._entries = symbol._entries
        self._order = _topo_order(self._entries)
        self._free_after = _free_plan(self._order, self._entries)
        self._outputs_cache = None
        self._last_is_train = False
        self._aux_applied = False
        self._fused_updater = None
        self._fused_index_of_name = {}
        self._pending_fused = False
        self._pending_grads = None
        _advance_host_rng()

    # ------------------------------------------------------------------
    # construction (parity: Executor::SimpleBind / Bind)
    # ------------------------------------------------------------------
    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", compute_dtype=None,
                    fp32_names=(), **kwargs):
        """Allocate all arrays from the inferred shapes and bind."""
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        arg_names = symbol.list_arguments()
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        if missing:
            raise MXNetError("simple_bind: cannot infer shapes of %s from %s"
                             % (missing, kwargs))
        req_dict = _norm_grad_req(grad_req, arg_names)
        arg_dict, grad_dict = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            arg_dict[name] = zeros(shape, ctx)
            if req_dict[name] != "null":
                grad_dict[name] = zeros(shape, ctx)
        aux_dict = {n: zeros(s, ctx)
                    for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
        return Executor(symbol, ctx, arg_dict, grad_dict, req_dict, aux_dict,
                        compute_dtype=compute_dtype, fp32_names=fp32_names)

    @staticmethod
    def bind(symbol, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             compute_dtype=None, fp32_names=()):
        """Bind with user-provided arrays (reference Executor::Bind)."""
        ctx = ctx or current_context()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError("bind: missing arguments %s" % missing)
            arg_dict = {n: args[n] for n in arg_names}
        else:
            if len(args) != len(arg_names):
                raise MXNetError("bind: expected %d args, got %d" % (len(arg_names), len(args)))
            arg_dict = dict(zip(arg_names, args))
        req_dict = _norm_grad_req(grad_req, arg_names)
        if args_grad is None:
            grad_dict = {}
        elif isinstance(args_grad, dict):
            grad_dict = dict(args_grad)
        else:
            grad_dict = dict(zip(arg_names, args_grad))
        for n in arg_names:
            if n not in grad_dict:
                req_dict[n] = "null"
        if aux_states is None:
            _, _, aux_shapes = symbol.infer_shape(**{n: arg_dict[n].shape for n in arg_names})
            aux_dict = {n: zeros(s, ctx) for n, s in zip(aux_names, aux_shapes)}
        elif isinstance(aux_states, dict):
            aux_dict = dict(aux_states)
        else:
            aux_dict = dict(zip(aux_names, aux_states))
        return Executor(symbol, ctx, arg_dict, grad_dict, req_dict, aux_dict,
                        compute_dtype=compute_dtype, fp32_names=fp32_names)

    # ------------------------------------------------------------------
    # forward / backward
    # ------------------------------------------------------------------
    def _cast(self):
        if self._compute_dtype is None:
            return None
        return (self._compute_dtype, self._fp32_names)

    def _run(self, arg_vals, is_train):
        return _run_graph(self._order, self._entries, self._free_after,
                          self._arg_names, self._aux_names, arg_vals,
                          [self.aux_dict[n].data for n in self._aux_names],
                          is_train, cast=self._cast())

    def forward(self, is_train=False, **kwargs):
        """Set inputs and run forward.  A training-mode forward defers: the
        following backward() (or fused_update()) computes it together with
        the gradients; reading `outputs` first runs a forward-only pass,
        unless a fused step is pending (see `outputs`)."""
        for name, value in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("Unknown argument %s" % name)
            shape = tuple(value.shape)
            if shape != self.arg_dict[name].shape:
                raise MXNetError("Shape mismatch for argument %s: bound %s, got %s"
                                 % (name, self.arg_dict[name].shape, shape))
            self.arg_dict[name][:] = value
        self._last_is_train = bool(is_train)
        self._outputs_cache = None
        self._aux_applied = False
        self._pending_fused = False
        self._pending_grads = None
        _advance_host_rng()
        if not is_train:
            self._compute_forward(False)
            return self.outputs
        return None

    def _compute_forward(self, is_train):
        with torch.no_grad():
            outs, aux_upd = self._run([self.arg_dict[n].data for n in self._arg_names],
                                      is_train)
        self._finish(outs, aux_upd if is_train else None)

    def _finish(self, outs, aux_upd):
        """Publish a step's outputs and, once per step, its aux updates."""
        self._outputs_cache = [NDArray(o, self._ctx) for o in outs]
        if aux_upd is not None and not self._aux_applied:
            for n, v in zip(self._aux_names, aux_upd):
                self.aux_dict[n]._set_data(v)
            self._aux_applied = True

    @property
    def outputs(self):
        """The step's outputs.  With a fused step pending, the read runs the
        step's forward and backward now and keeps the gradients, so
        fused_update() applies them without a second forward."""
        if self._outputs_cache is None:
            if self._pending_fused:
                outs, aux_upd, self._pending_grads = self._grad_core(None)
                self._finish(outs, aux_upd)
            else:
                self._compute_forward(self._last_is_train)
        return self._outputs_cache

    def _grad_core(self, head_grads):
        """Training forward + backward: (outputs, aux updates, gradients
        ordered like the differentiable args), all detached."""
        leaves = {n: self.arg_dict[n].data.detach().requires_grad_(True)
                  for n in self._diff_names}
        vals = [leaves[n] if n in leaves else self.arg_dict[n].data
                for n in self._arg_names]
        with torch.enable_grad():
            outs, aux_upd = self._run(vals, True)
            if head_grads is None:
                head_grads = [torch.ones_like(o) for o in outs]
            pairs = [(o, g) for o, g in zip(outs, head_grads) if o.requires_grad]
            wrt = [leaves[n] for n in self._diff_names]
            grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                        grad_outputs=[g for _, g in pairs],
                                        allow_unused=True) if pairs else [None] * len(wrt)
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
        return ([o.detach() for o in outs], [a.detach() for a in aux_upd], grads)

    def backward(self, out_grads=None):
        """Forward + backward in one pass; gradients land in grad_dict.

        With a fused update armed and no head gradients, backward defers:
        update() then runs the whole step in one call (grad_dict is not
        written on that path)."""
        if self._fused_updater is not None and out_grads is None:
            self._pending_fused = True
            return
        if not self._diff_names:
            return
        heads = None
        if out_grads is not None:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [g.data.to(self._ctx.device) if isinstance(g, NDArray)
                     else torch.as_tensor(g, device=self._ctx.device) for g in out_grads]
        outs, aux_upd, grads = self._grad_core(heads)
        self._finish(outs, aux_upd)
        with torch.no_grad():
            for n, g in zip(self._diff_names, grads):
                tgt = self.grad_dict.get(n)
                if tgt is not None:
                    tgt.data.copy_(g)

    def forward_backward(self, out_grads=None, **kwargs):
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    # ------------------------------------------------------------------
    # single-call training step: forward + backward + optimizer update
    # ------------------------------------------------------------------
    def install_fused_update(self, updater, index_of_name):
        """Arm the single-call step: after this, backward() with no head
        grads defers and fused_update() runs fwd+bwd+update.
        `index_of_name` maps arg name -> optimizer key."""
        self._fused_updater = updater
        self._fused_index_of_name = dict(index_of_name)
        self._pending_fused = False
        self._pending_grads = None

    def fused_update(self):
        """Run the armed step; parameters and optimizer state update in place.
        Gradients an earlier read of `outputs` computed are used as they are."""
        updater = self._fused_updater
        opt = updater.optimizer
        grads = self._pending_grads
        if grads is None:
            outs, aux_upd, grads = self._grad_core(None)
            self._finish(outs, aux_upd)
        with torch.no_grad():
            for n, g in zip(self._diff_names, grads):
                key = self._fused_index_of_name[n]
                weight = self.arg_dict[n]
                if key not in updater.states:
                    updater.states[key] = opt.create_state(key, weight)
                lr, wd, t = opt.step_scalars(key)
                opt._fused(weight.data, g,
                           tuple(l.data for l in _state_leaves(updater.states[key])),
                           lr, wd, t)
        self._pending_fused = False
        self._pending_grads = None

    def copy_params_from(self, arg_params, aux_params=None, allow_extra_params=False):
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Unknown param %s" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Unknown aux %s" % name)
