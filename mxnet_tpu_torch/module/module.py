"""Module — concrete single-symbol module (parity: mxnet_tpu/module/module.py)."""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import InitDesc, Uniform
from ..ndarray import zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """Single-symbol module on one context.  With no `context` it runs on
    ``gpu(0)`` and raises MXNetError when there is none; pass
    ``context=mx.cpu()`` to run on the CPU."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, fixed_param_names=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if not isinstance(context, list):
            context = [context]
        self._context = context
        self._compute_dtype = compute_dtype
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param", True)
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._exec_group = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_params needs a bound, initialized Module")
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize the host copy of every parameter, in sorted name order
        (the order the JAX package draws in), then copy it to the device."""
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and force_init=False. "
                            "init_params call ignored.")
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    if cache[name] is not arr:
                        arr[:] = cache[name]
                    return
                if not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name) or {}), arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, grad_req="write"):
        """Bind the executor (parity: module.py bind)."""
        if force_rebind:
            if self.binded and self.params_initialized and self._params_dirty:
                self._sync_params_from_devices()
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.binded = True
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes, self._param_names,
            for_training, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            compute_dtype=self._compute_dtype)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            exe = self._exec_group.execs[0]
            self._arg_params = {n: zeros(exe.arg_dict[n].shape, cpu(), exe.arg_dict[n].dtype)
                                for n in self._param_names}
            self._aux_params = {n: zeros(exe.aux_dict[n].shape, cpu(), exe.aux_dict[n].dtype)
                                for n in self._aux_names}
        if self.optimizer_initialized:
            self._maybe_install_fused_update()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """Create the optimizer with rescale_grad = 1/batch (parity: module.py
        init_optimizer).  One context needs no kvstore: "local"/"device"/None
        are accepted and mean the same."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer needs a bound, initialized Module")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore not in (None, "local", "device"):
            raise MXNetError("kvstore %r is not supported by mxnet_tpu_torch" % (kvstore,))
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=dict(enumerate(self._exec_group.param_names)),
                                   **optimizer_params)
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad=%s != "
                "1.0/batch=%s. Is this intended?", optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._maybe_install_fused_update()
        self.optimizer_initialized = True

    def _maybe_install_fused_update(self):
        """Arm the single-call fwd+bwd+update step when safe: a fused-capable
        optimizer and every trainable param with grad_req 'write' (fixed
        params ride along with 'null')."""
        exe = self._exec_group.execs[0]
        fixed = set(self._fixed_param_names)
        reqs = {n: exe._grad_req.get(n) for n in self._param_names}
        if (self._optimizer.fused_supported
                and all(r == "write" or (r == "null" and n in fixed) for n, r in reqs.items())
                and any(r == "write" for r in reqs.values())):
            # optimizer state is keyed by parameter NAME
            exe.install_fused_update(self._updater,
                                     {n: n for n in self._exec_group.param_names})

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward needs a bound, initialized Module")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward needs a bound, initialized Module")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer (parity: module.py update): the armed single-call
        step when backward deferred to it, else one update per parameter from
        the materialized gradients."""
        if not (self.binded and self.params_initialized and self.optimizer_initialized):
            raise MXNetError("update needs a bound, initialized Module with an optimizer")
        self._params_dirty = True
        exe = self._exec_group.execs[0]
        if exe._pending_fused:
            exe.fused_update()
            return
        for name, weights, grads in zip(self._exec_group.param_names,
                                        self._exec_group.param_arrays,
                                        self._exec_group.grad_arrays):
            if grads[0] is not None:
                self._updater(name, grads[0], weights[0])

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False
