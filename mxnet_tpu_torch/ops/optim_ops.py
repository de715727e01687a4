"""Optimizer-update ops (parity: mxnet_tpu/ops/optim_ops.py, reference
src/operator/optimizer_op.cc).

``sgd_step_`` is the one copy of the SGD arithmetic: it updates the weight
and momentum IN PLACE, and ``optimizer.py``'s training step calls it.  The
registered ops wrap it the way the JAX package's ops behave: they return
every updated tensor, weight first — ``w, mom = sgd_mom_update(w, g, mom,
lr=...)`` — and leave their inputs untouched.
"""
from __future__ import annotations

import torch

from .registry import register
from .tensor import _lit


def _prep_grad_sgd(weight, grad, wd, rescale_grad, clip_gradient):
    """SGD-family preamble: clip rescale*grad alone, THEN add wd*weight —
    the reference SGD kernels apply wd outside the clipped quantity."""
    g = rescale_grad * grad
    if clip_gradient >= 0.0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def sgd_step_(weight, grad, mom, lr, momentum, wd, rescale_grad, clip_gradient):
    """In place: mom = momentum*mom - lr*grad'; weight += mom.  With `mom`
    None, weight -= lr*grad'.  `grad` is cast to the weight's dtype;
    clip_gradient < 0 means no clipping."""
    g = _prep_grad_sgd(weight, grad.to(weight.dtype), wd, rescale_grad, clip_gradient)
    if mom is None:
        weight.sub_(lr * g)
    else:
        mom.mul_(momentum).sub_(lr * g)
        weight.add_(mom)


def _f(v, default=None):
    return float(_lit(v)) if v is not None else default


@register("sgd_mom_update", inputs=("weight", "grad", "mom"), num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """mom = momentum*mom - lr*grad'; weight += mom.  Returns (weight, mom)."""
    weight, mom = weight.clone(), mom.clone()
    sgd_step_(weight, grad, mom, _f(lr), _f(momentum), _f(wd), _f(rescale_grad),
              _f(clip_gradient))
    return weight, mom


@register("mp_sgd_mom_update", inputs=("weight", "grad", "mom", "weight32"),
          num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """Multi-precision momentum SGD: the fp32 master `weight32` and `mom`
    update in fp32, the low-precision weight is its cast.
    Returns (weight, mom, weight32)."""
    w32, mom = weight32.clone(), mom.clone()
    sgd_step_(w32, grad, mom, _f(lr), _f(momentum), _f(wd), _f(rescale_grad),
              _f(clip_gradient))
    return w32.to(weight.dtype), mom, w32
