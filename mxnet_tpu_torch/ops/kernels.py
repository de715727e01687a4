"""Hand-written Hopper kernels of the port, each beside its plain version.

  * bn_stats — per-channel fp32 (E[x], E[x^2]) over a channel-last
    activation, the statistics behind BatchNorm in training.  Replaces the
    TPU kernel ``mxnet_tpu/ops/pallas_kernels.py:bn_stats`` (the
    ``pl.pallas_call`` in ``_stats_fwd_impl``).  The CUDA source is
    ``csrc/bn_stats.cu``; its header says how the two-stage design meets
    the memory bound.

A wrapper takes its plain version only for a tensor that lies on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
Each wrapper counts its launches in a plain integer attribute
(``bn_stats.launches``), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from . import build

__all__ = ["bn_stats", "bn_stats_reference"]

# threads per block of stats_partial (kThreads in csrc/bn_stats.cu)
_THREADS = 256
# blocks to aim for: four per SM of a 132-SM H100 keeps enough loads in
# flight for a memory-bound sweep
_TARGET_BLOCKS = 4 * 132
# each thread sums at least this many rows, so the per-block reduction and
# the partial sums stay small beside the sweep itself
_MIN_SWEEPS = 16

_DTYPE_TAG = {torch.float32: 0, torch.bfloat16: 1}


def _launch_plan(m, c):
    """(bc, splits, rows_per_split) for an [m, c] input: channel tile width,
    number of M splits (grid.y) and rows per split.  Every row falls in
    exactly one split and no split is empty."""
    bc = min(c, _THREADS)
    rows_per_sweep = _THREADS // bc
    channel_tiles = -(-c // bc)
    splits = min(-(-_TARGET_BLOCKS // channel_tiles),
                 max(1, m // (rows_per_sweep * _MIN_SWEEPS)))
    rows_per_split = -(-m // splits)
    return bc, -(-m // rows_per_split), rows_per_split


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("bn_stats").bn_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_sums(x2):
    """fp32 [2, C] = (sum x, sum x^2) of a contiguous CUDA [M, C] tensor."""
    m, c = x2.shape
    bc, splits, rows_per_split = _launch_plan(m, c)
    partial = torch.empty((2, splits, c), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = _launcher()(x2.data_ptr(), partial.data_ptr(), out.data_ptr(),
                          m, c, bc, splits, rows_per_split, _DTYPE_TAG[x2.dtype],
                          torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise MXNetError("bn_stats kernel launch failed with CUDA error %d "
                         "(M=%d, C=%d, %s)" % (err, m, c, x2.dtype))
    bn_stats.launches += 1
    return out


class _BnStatsSums(torch.autograd.Function):
    """(sum, sum_sq) per channel of [M, C]; the kernel has no backward of its
    own — d(sum)/dx = 1 and d(sum_sq)/dx = 2x make it elementwise, exactly
    the JAX custom_vjp's backward."""

    @staticmethod
    def forward(ctx, x2):
        ctx.save_for_backward(x2)
        return _launch_sums(x2)

    @staticmethod
    def backward(ctx, g):
        (x2,) = ctx.saved_tensors
        return (g[0][None, :] + 2.0 * x2.float() * g[1][None, :]).to(x2.dtype)


def bn_stats_reference(x, channel_axis):
    """Plain version of :func:`bn_stats`: fp32 means over the non-channel axes."""
    ax = channel_axis % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != ax)
    xf = x.float()
    return xf.mean(dims), (xf * xf).mean(dims)


def bn_stats(x, channel_axis):
    """Per-channel (mean, mean_sq) in fp32 over all non-channel axes.

    Same signature and result as the JAX ``bn_stats``.  A CPU tensor takes
    :func:`bn_stats_reference`.  A CUDA tensor must be bf16 or f32,
    channel-last and contiguous; anything else raises MXNetError."""
    if x.device.type == "cpu":
        return bn_stats_reference(x, channel_axis)
    if x.device.type != "cuda":
        raise MXNetError("bn_stats: unsupported device %s" % x.device)
    if channel_axis % x.dim() != x.dim() - 1:
        raise MXNetError("bn_stats: the kernel takes channel-last input only "
                         "(channel_axis=%d of a %d-d tensor)"
                         % (channel_axis, x.dim()))
    if x.dtype not in _DTYPE_TAG:
        raise MXNetError("bn_stats: dtype %s is not bfloat16 or float32" % x.dtype)
    if not x.is_contiguous():
        raise MXNetError("bn_stats: input of shape %s is not contiguous"
                         % (tuple(x.shape),))
    c = x.shape[-1]
    m = x.numel() // c if c else 0
    if m == 0:
        raise MXNetError("bn_stats: empty input of shape %s" % (tuple(x.shape),))
    sums = _BnStatsSums.apply(x.view(m, c))
    return sums[0] / m, sums[1] / m


bn_stats.launches = 0
