"""BaseModule — the high-level training interface (parity: mxnet_tpu/module/base_module.py).

The epoch body lives in ``_run_epoch`` and runs one training step per
batch: ``forward_backward`` then ``update``.  The K-step block, telemetry,
checkpointing and frozen-BN fine-tuning of the JAX package are not part
of this slice.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

from .. import metric
from ..initializer import Uniform

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, param):
    for cb in _as_list(callbacks):
        cb(param)


def _check_input_names(symbol, names, typename, throw):
    """Validate declared input names against the symbol's arguments."""
    args = symbol.list_arguments()
    bad = [n for n in names if n not in args]
    if not bad:
        return
    candidates = [a for a in args if not a.endswith(("_weight", "_bias", "_gamma", "_beta"))]
    msg = ("You created Module with Module(..., %s_names=%s) but input with name "
           "'%s' is not found in symbol.list_arguments(). Did you mean one of:\n\t%s"
           % (typename, str(names), bad[0], "\n\t".join(candidates)))
    if throw:
        raise ValueError(msg)
    logging.warning(msg)


class BaseModule:
    """Base class for all modules (parity: base_module.py BaseModule)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------------
    # high-level interface
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """One training step's forward and backward (parity: base_module.py:188)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              reset=True, epoch=0):
        """Evaluate on eval_data (parity: base_module.py score)."""
        if reset:
            eval_data.reset()
        eval_metric = metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def _run_epoch(self, train_data, epoch, eval_metric, batch_end_callback):
        """Train one epoch, one step per batch; returns the batch count."""
        eval_metric.reset()
        nbatch = -1
        for nbatch, data_batch in enumerate(train_data):
            self.forward_backward(data_batch)
            self.update()
            self.update_metric(eval_metric, data_batch.label)
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=eval_metric, locals=locals()))
        return nbatch + 1

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """Full training loop (parity: base_module.py fit)."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        validation_metric = validation_metric or eval_metric
        eval_metric = metric.create(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            self._run_epoch(train_data, epoch, eval_metric, batch_end_callback)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            # pull params to the host copy, so epoch-end callbacks see them
            trained_args, trained_aux = self.get_params()
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, trained_args, trained_aux)
            if eval_data:
                for name, val in self.score(eval_data, validation_metric, epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()

    # ------------------------------------------------------------------
    # symbol/params accessors
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True,
                   allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init,
                         allow_extra=allow_extra)
