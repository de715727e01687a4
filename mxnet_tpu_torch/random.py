"""Random seeding (parity: mxnet_tpu/random.py seed)."""
from __future__ import annotations

from .ops.random_ops import HOST_RNG

__all__ = ["seed"]


def seed(seed_state):
    """Seed the host-side generator used by initializers (parity: mx.random.seed)."""
    if not isinstance(seed_state, int):
        raise ValueError("seed_state must be int")
    HOST_RNG.seed(seed_state % (2 ** 32))
