"""Neural-network layer operators of the training slice (parity: mxnet_tpu/ops/nn.py).

Each layer is a plain function on ``torch.Tensor``s.  Convolutions and the
FullyConnected product go to PyTorch (cuDNN / cuBLAS on the card), as the
JAX package left them to XLA.  BatchNorm's training statistics over a
channel-last input come from the hand-written ``bn_stats`` kernel
(ops/kernels.py).

Layout: NCHW / OIHW by default, as in the reference; ``layout="NHWC"`` keeps
channel-last activations and spatial+IO (HWIO) weights at the op's surface,
exactly like the JAX package.  Internally a channel-last conv hands
``F.conv2d`` permuted views: the NCHW view of a contiguous NHWC tensor is
``channels_last`` in memory, so no activation is copied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import params as P
from .kernels import bn_stats, bn_stats_reference
from .registry import register
from .tensor import _bool, _lit, _shape

# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------


def _pair(v, n=2):
    v = _shape(v)
    if v is None or v == ():
        return (1,) * n if n else ()
    if len(v) == 1:
        return v * n
    return v


def _channel_last(layout):
    """True for NHWC (reference ConvolutionParam.layout)."""
    return str(layout) == "NHWC"


def _to_channel_first(x):
    """NCHW-ordered view of an NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def _to_channel_last(x):
    return x.permute(0, 2, 3, 1)


def _kernel_2d(kernel, op):
    """The (h, w) window; the slice ports 2-D convolution and pooling only."""
    kernel = _shape(kernel)
    if len(kernel) != 2:
        raise MXNetError("%s: kernel=%s is not ported to mxnet_tpu_torch "
                         "(2-D windows only)" % (op, kernel))
    return kernel


_LAYOUTS = ("NCHW", "NHWC", "None")

# ----------------------------------------------------------------------
# FullyConnected (reference src/operator/fully_connected-inl.h:55-87:
# out = dot(data, W.T) + bias)
# ----------------------------------------------------------------------


def _infer_fc(in_shapes, attrs):
    data = in_shapes[0]
    num_hidden = int(_lit(attrs["num_hidden"]))
    no_bias = _bool(attrs.get("no_bias", False))
    flatten = _bool(attrs.get("flatten", True))
    if flatten:
        in_dim = 1
        for d in data[1:]:
            in_dim *= d
        out = (data[0], num_hidden)
    else:
        in_dim = data[-1]
        out = tuple(data[:-1]) + (num_hidden,)
    shapes = [data, (num_hidden, in_dim)]
    if not no_bias:
        shapes.append((num_hidden,))
    return shapes, [out]


@register(
    "FullyConnected",
    inputs=("data", "weight", "bias"),
    infer_shape=_infer_fc,
    params={"num_hidden": P.Int(required=True, low=1, desc="output dimension"),
            "no_bias": P.Bool(), "flatten": P.Bool()},
)
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False, flatten=True, **kw):
    if _bool(flatten):
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not _bool(no_bias):
        out = out + bias
    return out


# ----------------------------------------------------------------------
# Convolution (reference src/operator/convolution-inl.h)
# ----------------------------------------------------------------------


def _conv_out_dim(x, k, s, p, d):
    return (x + 2 * p - (d * (k - 1) + 1)) // s + 1


def _infer_conv(in_shapes, attrs):
    data = in_shapes[0]
    kernel = _kernel_2d(attrs["kernel"], "Convolution")
    n = len(kernel)
    nf = int(_lit(attrs["num_filter"]))
    stride = _pair(attrs.get("stride"), n)
    pad = _pair(attrs.get("pad", (0,) * n), n)
    if _shape(attrs.get("pad")) is None:
        pad = (0,) * n
    dilate = _pair(attrs.get("dilate"), n)
    groups = int(_lit(attrs.get("num_group", 1)))
    no_bias = _bool(attrs.get("no_bias", False))
    cl = _channel_last(attrs.get("layout"))
    c_in = data[-1] if cl else data[1]
    in_spatial = data[1:1 + n] if cl else data[2:2 + n]
    spatial = tuple(
        _conv_out_dim(in_spatial[i], kernel[i], stride[i], pad[i], dilate[i]) for i in range(n)
    )
    if cl:
        wshape = kernel + (c_in // groups, nf)
        out = (data[0],) + spatial + (nf,)
    else:
        wshape = (nf, c_in // groups) + kernel
        out = (data[0], nf) + spatial
    shapes = [data, wshape]
    if not no_bias:
        shapes.append((nf,))
    return shapes, [out]


@register("Convolution", inputs=("data", "weight", "bias"), infer_shape=_infer_conv,
          aliases=("Convolution_v1",),
          params={"kernel": P.Shape(required=True, low=1, desc="conv kernel (h, w)"),
                  "num_filter": P.Int(required=True, low=1, desc="number of output filters"),
                  "stride": P.Shape(low=1), "pad": P.Shape(low=0),
                  "dilate": P.Shape(low=1), "num_group": P.Int(default=1, low=1),
                  "no_bias": P.Bool(), "layout": P.Enum(_LAYOUTS)})
def convolution(data, weight, bias=None, kernel=None, num_filter=None, stride=None,
                pad=None, dilate=None, num_group=1, no_bias=False, layout=None, **kw):
    """2-D convolution.  NCHW data takes OIHW weights; NHWC data takes HWIO
    weights (the JAX package's channel-last convention)."""
    _kernel_2d(kernel, "Convolution")
    stride = _pair(stride)
    dilate = _pair(dilate)
    pad = _shape(pad) or (0, 0)
    b = bias if bias is not None and not _bool(no_bias) else None
    groups = int(_lit(num_group))
    if _channel_last(layout):
        w = weight.permute(3, 2, 0, 1)  # HWIO -> OIHW
        out = F.conv2d(_to_channel_first(data), w, b, stride, pad, dilate, groups)
        return _to_channel_last(out)
    return F.conv2d(data, weight, b, stride, pad, dilate, groups)


# ----------------------------------------------------------------------
# Pooling (reference src/operator/pooling-inl.h + src/operator/nn/pool.h)
# ----------------------------------------------------------------------


def _pool_out_dim(x, k, s, p):
    return (x + 2 * p - k) // s + 1  # the "valid" convention


def _infer_pool(in_shapes, attrs):
    data = in_shapes[0]
    cl = _channel_last(attrs.get("layout"))
    n = len(data) - 2
    if _bool(attrs.get("global_pool", False)):
        one = (1,) * n
        return [data], [(data[0],) + one + (data[-1],) if cl
                        else tuple(data[:2]) + one]
    kernel = _kernel_2d(attrs["kernel"], "Pooling")
    n = len(kernel)
    stride = _pair(attrs.get("stride"), n)
    pad = _shape(attrs.get("pad")) or (0,) * n
    in_spatial = data[1:1 + n] if cl else data[2:2 + n]
    spatial = tuple(_pool_out_dim(in_spatial[i], kernel[i], stride[i], pad[i]) for i in range(n))
    out = (data[0],) + spatial + (data[-1],) if cl else tuple(data[:2]) + spatial
    return [data], [out]


@register("Pooling", infer_shape=_infer_pool, aliases=("Pooling_v1",),
          params={"kernel": P.Shape(low=1), "stride": P.Shape(low=1),
                  "pad": P.Shape(low=0), "global_pool": P.Bool(),
                  "pool_type": P.Enum(("max", "avg")),
                  "pooling_convention": P.Enum(("valid",)),
                  "layout": P.Enum(_LAYOUTS)})
def pooling(data, kernel=None, pool_type="max", stride=None, pad=None, global_pool=False,
            pooling_convention="valid", layout=None, **kw):
    """2-D max/avg pooling with symmetric padding and the "valid" output
    size: max pads with -inf, avg divides by the full window (padding
    counted), as the JAX package does."""
    if data.dim() != 4:
        raise MXNetError("Pooling: data of shape %s is not ported to mxnet_tpu_torch "
                         "(2-D pooling only)" % (tuple(data.shape),))
    if str(pooling_convention) != "valid":
        raise MXNetError("Pooling: pooling_convention=%r is not ported to "
                         "mxnet_tpu_torch" % (pooling_convention,))
    cl =_channel_last(layout)
    x = _to_channel_first(data) if cl else data
    if _bool(global_pool):
        kernel, stride, pad = tuple(x.shape[2:]), (1, 1), (0, 0)
    else:
        kernel = _kernel_2d(kernel, "Pooling")
        stride = _pair(stride)
        pad = _shape(pad) or (0, 0)
    pt = str(pool_type)
    if pt == "max":
        out = F.max_pool2d(x, kernel, stride, pad)
    elif pt == "avg":
        out = F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True)
    else:
        raise MXNetError("Pooling: pool_type %r is not ported to mxnet_tpu_torch" % pt)
    return _to_channel_last(out) if cl else out


# ----------------------------------------------------------------------
# BatchNorm (reference src/operator/batch_norm-inl.h) — aux moving stats
# returned as extra outputs and threaded back by the executor.
# ----------------------------------------------------------------------


def _infer_bn(in_shapes, attrs):
    data = in_shapes[0]
    axis = int(_lit(attrs.get("axis", 1)))
    c = (data[axis],)
    return [data, c, c], [data], [c, c]


@register(
    "BatchNorm",
    inputs=("data", "gamma", "beta"),
    aux=("moving_mean", "moving_var"),
    infer_shape=_infer_bn,
    need_is_train=True,
    num_aux_out=2,
    aliases=("BatchNorm_v1", "CuDNNBatchNorm"),
    params={"eps": P.Float(default=1e-3, low=0.0),
            "momentum": P.Float(default=0.9, low=0.0, high=1.0),
            "fix_gamma": P.Bool(), "use_global_stats": P.Bool()},
)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3, momentum=0.9,
               fix_gamma=True, use_global_stats=False, axis=1, is_train=False, **kw):
    """Batch normalization.  Returns (out, new_moving_mean, new_moving_var).

    Training statistics are one-pass E[x] and E[x^2], accumulated in fp32
    even under bf16 compute; var = max(E[x^2] - E[x]^2, 0).  Moving stats
    update from detached statistics and stay in their fp32 storage dtype.
    The normalization folds into one per-channel affine whose output keeps
    the data dtype.  fix_gamma pins gamma to 1."""
    eps = float(_lit(eps))
    momentum = float(_lit(momentum))
    ax = int(_lit(axis)) % data.dim()
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    if _bool(fix_gamma):
        gamma = torch.ones_like(gamma)
    if is_train and not _bool(use_global_stats):
        if ax == data.dim() - 1:
            # the kernel reads a contiguous [M, C]; when the producer handed
            # back another memory format, the copy happens here, in sight
            data = data.contiguous()
            mean, mean_sq = bn_stats(data, ax)
        else:
            # channel-first: no kernel here in either package (the TPU
            # kernel took channel-last input only; the JAX package reduces
            # with jnp), so the plain fp32 reduction is the op itself
            mean, mean_sq = bn_stats_reference(data, ax)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        new_mm = moving_mean * momentum + mean.detach().to(moving_mean.dtype) * (1 - momentum)
        new_mv = moving_var * momentum + var.detach().to(moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float()
    w = (g32 * inv).to(data.dtype)
    b = (beta.float() - mean * inv * g32).to(data.dtype)
    out = data * w.reshape(bshape) + b.reshape(bshape)
    return out, new_mm, new_mv


# ----------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------


@register("Activation")
def activation(data, act_type="relu", **kw):
    """Activation (reference src/operator/activation-inl.h); the slice
    ports relu, the one ResNet uses."""
    if str(act_type) != "relu":
        raise MXNetError("Activation: act_type %r is not ported to "
                         "mxnet_tpu_torch" % (act_type,))
    return torch.relu(data)


# ----------------------------------------------------------------------
# SoftmaxOutput — backward ignores head gradients (reference
# src/operator/softmax_output-inl.h writes (p - label) directly)
# ----------------------------------------------------------------------

# attrs of the reference op whose non-default forms are not ported yet
_SOFTMAX_DEFAULTS = {"multi_output": False, "use_ignore": False, "normalization": "null"}


def _check_softmax_attrs(attrs):
    for key, default in _SOFTMAX_DEFAULTS.items():
        value = attrs.get(key, default)
        if (_bool(value) if isinstance(default, bool) else str(value)) != default:
            raise MXNetError("SoftmaxOutput: %s=%r is not ported to mxnet_tpu_torch"
                             % (key, value))


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis; d(loss)/d(data) = (p - onehot(label)) *
    grad_scale, with the default null normalization."""

    @staticmethod
    def forward(ctx, data, label, grad_scale):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(label, out)
        ctx.grad_scale = grad_scale
        return out

    @staticmethod
    def backward(ctx, head_grad):
        label, out = ctx.saved_tensors
        classes = torch.arange(out.shape[-1], device=out.device)
        onehot = (label.long().unsqueeze(-1) == classes).to(out.dtype)
        return (out - onehot) * ctx.grad_scale, None, None


def _infer_softmax_out(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return in_shapes, None
    return [data, tuple(data[:-1])], [data]


@register("SoftmaxOutput", inputs=("data", "label"), aliases=("Softmax",),
          infer_shape=_infer_softmax_out)
def softmax_output(data, label, grad_scale=1.0, **attrs):
    """Softmax with integrated CE gradient (reference src/operator/softmax_output-inl.h)."""
    _check_softmax_attrs(attrs)
    return _SoftmaxOutput.apply(data, label, float(_lit(grad_scale)))
