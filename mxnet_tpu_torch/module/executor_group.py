"""DataParallelExecutorGroup over one context (parity: mxnet_tpu/module/executor_group.py).

This slice binds a single executor on a single device; data-parallel
meshes come with the distributed slice.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..executor import Executor
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    """One executor on one context (parity class name/API: executor_group.py)."""

    def __init__(self, symbol, contexts, data_shapes, label_shapes, param_names,
                 for_training, logger=logging, fixed_param_names=None,
                 grad_req="write", compute_dtype=None):
        if len(contexts) != 1:
            raise MXNetError("mxnet_tpu_torch binds one context per Module "
                             "(got %d)" % len(contexts))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.fixed_param_names = fixed_param_names or []
        self.logger = logger
        self.compute_dtype = compute_dtype
        self.grad_req_spec = grad_req
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes):
        descs = [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1]) for s in data_shapes]
        self.batch_size = None
        for d in descs:
            axis = DataDesc.get_batch_axis(getattr(d, "layout", "NCHW"))
            if axis == -1:
                continue
            if self.batch_size is not None and d.shape[axis] != self.batch_size:
                raise MXNetError("all data must have the same batch size: %d, but %s "
                                 "has shape %s" % (self.batch_size, d.name, d.shape))
            self.batch_size = d.shape[axis]
        self.data_names = [s.name for s in descs]
        self.data_shapes = descs
        label_descs = [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
                       for s in (label_shapes or [])]
        self.label_names = [s.name for s in label_descs]
        self.label_shapes = label_descs or None
        shape_kwargs = {s.name: s.shape for s in descs + label_descs}
        input_names = set(self.data_names) | set(self.label_names)
        grad_req = {}
        for name in self.arg_names:
            if not self.for_training or name in input_names \
                    or name in self.fixed_param_names:
                grad_req[name] = "null"
            elif isinstance(self.grad_req_spec, str):
                grad_req[name] = self.grad_req_spec
            else:
                grad_req[name] = self.grad_req_spec.get(name, "write")
        exe = Executor.simple_bind(
            self.symbol, self.contexts[0], grad_req=grad_req,
            compute_dtype=self.compute_dtype,
            # labels keep fp32: class ids above 256 are not bf16-exact
            fp32_names=tuple(self.label_names), **shape_kwargs)
        self.execs = [exe]

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params, allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            arg_params[name][:] = self.execs[0].arg_dict[name]
        for name in self.aux_names:
            aux_params[name][:] = self.execs[0].aux_dict[name]

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        kwargs = dict(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            kwargs.update(zip(self.label_names, data_batch.label))
        self.execs[0].forward(is_train=is_train, **kwargs)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)

    @property
    def grad_arrays(self):
        return [[self.execs[0].grad_dict.get(n)] for n in self.param_names]

    @property
    def param_arrays(self):
        return [[self.execs[0].arg_dict[n]] for n in self.param_names]

    @property
    def aux_arrays(self):
        return [[self.execs[0].aux_dict[n]] for n in self.aux_names]
