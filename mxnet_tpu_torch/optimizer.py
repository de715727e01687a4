"""Optimizers (parity: mxnet_tpu/optimizer.py, reference python/mxnet/optimizer.py).

Each update rule is ``_fused(w, g, states, lr, wd, t)`` over tensors.
Unlike the JAX package's pure kernels it updates ``w`` and the state
tensors IN PLACE — the training step holds no second copy of the
parameters — with the same arithmetic in the same order.  SGD's rule is
``ops/optim_ops.py:sgd_step_``, the arithmetic of the registered
``sgd_mom_update`` ops.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray, zeros
from .ops.optim_ops import sgd_step_

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create", "register"]


def _state_leaves(state):
    """Flatten a create_state result to its non-None NDArray leaves."""
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    return [s for s in state if s is not None]


class Optimizer:
    """Base optimizer (parity: optimizer.py Optimizer)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    _fused = None  # subclasses set an in-place (w, g, states, lr, wd, t) rule

    @property
    def fused_supported(self):
        return self._fused is not None

    def step_scalars(self, index):
        """(lr, wd, t) of the next update of `index`: lr and wd are read
        BEFORE the update count advances, as in the reference."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        return lr, wd, self._index_update_count[index]

    def update(self, index, weight, grad, state):
        """Per-key update through the in-place rule."""
        if self._fused is None:
            raise NotImplementedError()
        lr, wd, t = self.step_scalars(index)
        with torch.no_grad():
            self._fused(weight.data, grad.data,
                        tuple(l.data for l in _state_leaves(state)), lr, wd, t)

    def set_lr_mult(self, args_lr_mult):
        """Per-arg lr multipliers incl. __lr_mult__ attrs."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum and optional multi-precision (parity: optimizer.py SGD).

    State layout: [momentum?] + [fp32 master copy?] for float16 weights."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        if self.multi_precision and weight.data.dtype == torch.float16:
            master = weight.astype("float32")
            if self.momentum != 0.0:
                return (zeros(weight.shape, weight.context, dtype="float32"), master)
            return (None, master)
        if self.momentum != 0.0:
            return zeros(weight.shape, weight.context, dtype=weight.data.dtype)
        return None

    def _fused(self, w, g, states, lr, wd, t):
        use_mp = self.multi_precision and w.dtype == torch.float16
        w32 = states[-1] if use_mp else w
        clip = -1.0 if self.clip_gradient is None else self.clip_gradient
        sgd_step_(w32, g, states[0] if self.momentum != 0.0 else None, lr,
                  self.momentum, wd, self.rescale_grad, clip)
        if use_mp:
            w.copy_(w32)


create = Optimizer.create_optimizer


class Updater:
    """Apply an optimizer with per-key state (parity: optimizer.py get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
