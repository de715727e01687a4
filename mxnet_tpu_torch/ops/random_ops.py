"""Host-side random state (parity: mxnet_tpu/ops/random_ops.py HOST_RNG).

Initializers sample on the host with one numpy ``RandomState``, exactly as
the JAX package does, so one seed gives bit-identical initial parameters
in both packages as long as both draw in the same order.  Seeded 0 so a
default run is deterministic without an explicit seed.
"""
from __future__ import annotations

import numpy as _np

HOST_RNG = _np.random.RandomState(0)
