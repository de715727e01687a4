"""Carry trained weights from mxnet_tpu into the port.

The port keeps the JAX package's parameter names and layouts at its
surface (HWIO conv weights for NHWC graphs), so converting is a checked
copy.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import array

__all__ = ["from_jax_params"]


def from_jax_params(arg_params, aux_params, module=None):
    """``{name: numpy array}`` dicts (what mxnet_tpu's ``Module.get_params()``
    gives after ``.asnumpy()``) -> the port's ``{name: NDArray}`` dicts on
    the host, ready for ``Module.set_params``.

    Given a bound `module`, every name and shape is checked against its
    parameters and auxiliary states; a missing, unknown or misshapen
    entry raises MXNetError."""
    if module is not None:
        if not module.binded:
            raise MXNetError("from_jax_params: bind the module first")
        exe = module._exec_group.execs[0]
        for kind, given, want in (
                ("arg", arg_params, {n: exe.arg_dict[n].shape for n in module._param_names}),
                ("aux", aux_params, {n: a.shape for n, a in exe.aux_dict.items()})):
            missing = sorted(set(want) - set(given))
            unknown = sorted(set(given) - set(want))
            if missing or unknown:
                raise MXNetError("from_jax_params: %s names differ from the module: "
                                 "missing %s, unknown %s" % (kind, missing, unknown))
            for name, value in given.items():
                if tuple(_np.shape(value)) != tuple(want[name]):
                    raise MXNetError("from_jax_params: %s %s has shape %s, the module "
                                     "holds %s" % (kind, name, tuple(_np.shape(value)),
                                                   tuple(want[name])))
    return ({n: array(_np.asarray(v), ctx=cpu()) for n, v in arg_params.items()},
            {n: array(_np.asarray(v), ctx=cpu()) for n, v in aux_params.items()})
