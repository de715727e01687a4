"""Every op of the port's training slice against the JAX package's registered
op: the same numpy inputs through both, forward outputs compared, and the
input gradients of a random cotangent compared through jax.vjp and
torch.autograd.  Tolerance: fp32 throughout; convolutions and reductions
sum in another order on each side (XLA vs PyTorch CPU kernels), so 1e-4
relative / 1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-4, 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(op, inputs, diff, attrs, n_main=1, seed=100):
    """Compare op `op` on `inputs` (numpy); `diff[i]` marks the inputs
    gradients are compared for.  The cotangent covers the first `n_main`
    outputs; further outputs (aux updates) get zero cotangents."""
    fj = jreg.get_op(op).fn
    ft = treg.get_op(op).fn

    def as_tuple(r):
        return r if isinstance(r, tuple) else (r,)

    outs_j, vjp = jax.vjp(lambda *xs: as_tuple(fj(*xs, **attrs)),
                          *[jnp.asarray(x) for x in inputs])
    cots = [_rand(o.shape, seed + i) if i < n_main else np.zeros(o.shape, np.float32)
            for i, o in enumerate(outs_j)]
    grads_j = vjp(tuple(jnp.asarray(c) for c in cots))

    ts = [torch.from_numpy(x.copy()).requires_grad_(d) for x, d in zip(inputs, diff)]
    outs_t = as_tuple(ft(*ts, **attrs))
    assert len(outs_t) == len(outs_j)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    wrt = [t for t, d in zip(ts, diff) if d]
    grads_t = torch.autograd.grad(
        [o for o in outs_t[:n_main]], wrt,
        [torch.from_numpy(c) for c in cots[:n_main]], allow_unused=True)
    for w, gj, gt in zip(wrt, [g for g, d in zip(grads_j, diff) if d], grads_t):
        gt = torch.zeros_like(w) if gt is None else gt  # unused input: zero grad
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [
    # NHWC data + HWIO weights, strided and padded, with bias
    dict(data=(2, 9, 9, 5), weight=(3, 3, 5, 4), bias=(4,),
         attrs=dict(kernel=(3, 3), num_filter=4, stride=(2, 2), pad=(1, 1), layout="NHWC")),
    # NHWC 1x1, no bias (the bottleneck projection form)
    dict(data=(2, 6, 6, 8), weight=(1, 1, 8, 16), bias=None,
         attrs=dict(kernel=(1, 1), num_filter=16, stride=(2, 2), no_bias=True, layout="NHWC")),
    # NCHW data + OIHW weights, dilated, with bias
    dict(data=(2, 5, 9, 9), weight=(4, 5, 3, 3), bias=(4,),
         attrs=dict(kernel=(3, 3), num_filter=4, pad=(2, 2), dilate=(2, 2))),
])
def test_convolution(case):
    ins = [_rand(case["data"], 0), _rand(case["weight"], 1)]
    if case["bias"] is not None:
        ins.append(_rand(case["bias"], 2))
    _check("Convolution", ins, [True] * len(ins), case["attrs"])


@pytest.mark.parametrize("shape,attrs", [
    ((2, 9, 9, 4), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max", layout="NHWC")),
    ((2, 4, 8, 8), dict(kernel=(2, 2), stride=(2, 2), pool_type="avg")),
    ((2, 7, 7, 6), dict(kernel=(7, 7), global_pool=True, pool_type="avg", layout="NHWC")),
    ((2, 6, 6, 3), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
                        layout="NHWC")),
])
def test_pooling(shape, attrs):
    _check("Pooling", [_rand(shape, 3)], [True], attrs)


@pytest.mark.parametrize("shape,attrs,is_train", [
    ((4, 5, 5, 6), dict(axis=-1, fix_gamma=False, eps=2e-5, momentum=0.9), True),
    ((4, 6, 5, 5), dict(axis=1, fix_gamma=False, eps=2e-5, momentum=0.9), True),
    ((4, 5, 5, 6), dict(axis=-1, fix_gamma=True, eps=2e-5, momentum=0.9), True),
    ((4, 5, 5, 6), dict(axis=-1, fix_gamma=False, eps=1e-3, momentum=0.9), False),
])
def test_batch_norm(shape, attrs, is_train):
    c = shape[attrs["axis"]]
    rng = np.random.RandomState(5)
    ins = [_rand(shape, 4) * 2.0 + 0.5, _rand((c,), 6), _rand((c,), 7),
           rng.randn(c).astype(np.float32) * 0.1,
           rng.rand(c).astype(np.float32) + 0.5]
    _check("BatchNorm", ins, [True, True, True, False, False],
           dict(attrs, is_train=is_train), n_main=1)


def test_activation():
    _check("Activation", [_rand((3, 4, 5), 8)], [True], dict(act_type="relu"))


@pytest.mark.parametrize("data,weight,bias,attrs", [
    ((3, 2, 4), (5, 8), (5,), dict(num_hidden=5)),
    ((3, 2, 4), (6, 4), None, dict(num_hidden=6, flatten=False, no_bias=True)),
])
def test_fully_connected(data, weight, bias, attrs):
    ins = [_rand(data, 9), _rand(weight, 10)] + ([_rand(bias, 11)] if bias else [])
    _check("FullyConnected", ins, [True] * len(ins), attrs)


@pytest.mark.parametrize("attrs", [dict(), dict(grad_scale=0.5)])
def test_softmax_output_ignores_head_grads(attrs):
    label = np.array([0, 2, 5, 1], np.float32)
    # random cotangents on both sides: the loss gradient must not depend on them
    _check("SoftmaxOutput", [_rand((4, 6), 12), label], [True, False], attrs)


@pytest.mark.parametrize("op,shapes,attrs", [
    ("Activation", [(3, 4)], dict(act_type="sigmoid")),
    ("Activation", [(3, 4)], dict(act_type="tanh")),
    ("SoftmaxOutput", [(4, 6), (4,)], dict(normalization="batch")),
    ("SoftmaxOutput", [(4, 6), (4,)], dict(use_ignore=True, ignore_label=2)),
    ("SoftmaxOutput", [(4, 6, 3), (4, 3)], dict(multi_output=True)),
    ("Pooling", [(2, 3, 6, 6)], dict(kernel=(3, 3), pool_type="sum")),
    ("Pooling", [(2, 3, 6, 6)], dict(kernel=(3, 3), pooling_convention="full")),
    ("Pooling", [(2, 3, 8)], dict(kernel=(3,), pool_type="max")),
    ("Convolution", [(2, 3, 8), (4, 3, 3)], dict(kernel=(3,), num_filter=4, no_bias=True)),
])
def test_unported_forms_raise(op, shapes, attrs):
    """Forms of the reference ops that the ResNet path does not use are not
    ported: they raise instead of computing something else."""
    ins = [torch.from_numpy(_rand(s, 20 + i)) for i, s in enumerate(shapes)]
    with pytest.raises(MXNetError, match="not ported"):
        treg.get_op(op).fn(*ins, **attrs)


def test_elemwise_add_and_flatten():
    _check("elemwise_add", [_rand((2, 3, 4), 13), _rand((2, 3, 4), 14)], [True, True], {})
    _check("Flatten", [_rand((2, 3, 4), 15)], [True], {})


@pytest.mark.parametrize("op,n_in", [("sgd_mom_update", 3), ("mp_sgd_mom_update", 4)])
def test_sgd_mom_update(op, n_in):
    ins = [_rand((4, 5), 16 + i) for i in range(n_in)]
    attrs = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=0.25, clip_gradient=0.3)
    outs_j = jreg.get_op(op).fn(*[jnp.asarray(x) for x in ins], **attrs)
    outs_t = treg.get_op(op).fn(*[torch.from_numpy(x) for x in ins], **attrs)
    assert len(outs_j) == len(outs_t)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-7)
