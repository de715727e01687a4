"""The port's bn_stats (mxnet_tpu_torch/ops/kernels.py) against the JAX
package's: the Pallas kernel in interpret mode where its gate accepts the
shape, the jnp reduction BatchNorm uses where it refuses, and jax.grad for
the gradient.  On the CPU the wrapper takes its plain version; the CUDA
kernel itself is held against that plain version by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import kernels as tk


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) + 0.25


def _port(x, axis=3):
    mean, msq = tk.bn_stats(torch.from_numpy(x), axis)
    return mean.numpy(), msq.numpy()


# tolerance: both sides sum fp32 values in fp32, in different orders
@pytest.mark.parametrize("shape", [(16, 14, 14, 256), (32, 8, 8, 128),
                                   (64, 4, 4, 64)])
def test_bn_stats_matches_pallas_interpret(interpret_mode, shape):
    assert pk.bn_stats_supported(shape, 3)
    x = _x(shape, 0)
    mean_j, msq_j = pk.bn_stats(jnp.asarray(x), 3)
    mean_t, msq_t = _port(x)
    np.testing.assert_allclose(mean_t, np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(msq_t, np.asarray(msq_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 3, 3, 384), (8, 5, 5, 3)])
def test_bn_stats_matches_jnp_where_pallas_refuses(interpret_mode, shape):
    # ragged M and the C=3 input layer: the TPU gate refuses both, the
    # port's kernel takes any [M, C]
    assert not pk.bn_stats_supported(shape, 3)
    x = _x(shape, 1)
    axes = (0, 1, 2)
    mean_t, msq_t = _port(x)
    np.testing.assert_allclose(mean_t, np.asarray(jnp.mean(x, axis=axes, dtype=jnp.float32)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        msq_t, np.asarray(jnp.mean(jnp.square(x), axis=axes, dtype=jnp.float32)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,via_pallas", [((32, 8, 8, 128), True),
                                              ((8, 5, 5, 3), False)])
def test_bn_stats_grad_matches_jax(interpret_mode, shape, via_pallas):
    x = _x(shape, 2)
    w = np.random.RandomState(3).randn(shape[-1]).astype(np.float32)

    def loss_j(xj):
        if via_pallas:
            m, s = pk.bn_stats(xj, 3)
        else:
            m = jnp.mean(xj, axis=(0, 1, 2))
            s = jnp.mean(xj * xj, axis=(0, 1, 2))
        return jnp.sum(m * w) + jnp.sum(s * w * w)

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    m, s = tk.bn_stats(xt, 3)
    (torch.sum(m * wt) + torch.sum(s * wt * wt)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=1e-5, atol=1e-6)


def test_bn_stats_cpu_tensor_takes_plain_version():
    x = torch.from_numpy(_x((4, 3, 3, 8), 4))
    before = tk.bn_stats.launches
    for dtype in (torch.float32, torch.bfloat16):
        mean, msq = tk.bn_stats(x.to(dtype), 3)
        ref_mean, ref_msq = tk.bn_stats_reference(x.to(dtype), 3)
        assert mean.dtype == msq.dtype == torch.float32
        assert torch.equal(mean, ref_mean) and torch.equal(msq, ref_msq)
    assert tk.bn_stats.launches == before


@pytest.mark.parametrize("m,c", [(3211264, 3), (802816, 64), (200704, 256),
                                 (3136, 2048), (36, 384), (1, 5), (7, 300)])
def test_launch_plan_covers_every_row_once(m, c):
    bc, splits, rows = tk._launch_plan(m, c)
    assert 1 <= bc <= tk._THREADS and bc == min(c, tk._THREADS)
    assert 1 <= splits <= 65535                      # CUDA grid.y limit
    assert (splits - 1) * rows < m <= splits * rows  # no empty split, no gap
    channel_tiles = -(-c // bc)
    assert channel_tiles * splits <= tk._TARGET_BLOCKS + channel_tiles
