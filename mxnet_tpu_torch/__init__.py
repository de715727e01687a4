"""mxnet_tpu_torch — the mxnet_tpu framework on PyTorch and CUDA.

The same Python surface as mxnet_tpu (``mx.sym``, ``mx.mod.Module``,
``mx.io``, ``mx.init``, ``mx.optimizer``, ``mx.metric``), so a script
moves over by changing its import line::

    import mxnet_tpu_torch as mx

Entry points run on the card: with no context they use ``mx.gpu(0)`` and
raise MXNetError when there is no CUDA device.  Pass ``context=mx.cpu()``
to run on the CPU.  The package imports neither JAX nor mxnet_tpu.
"""
from . import base
from .base import MXNetError
from . import context
from .context import Context, cpu, current_context, gpu, tpu
from . import name
from . import attribute
from .attribute import AttrScope
from . import ops
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import random
from . import initializer
from . import initializer as init
from . import optimizer
from . import executor
from . import io
from . import metric
from . import module
from . import module as mod
from . import models
from .convert import from_jax_params

__version__ = "0.1.0"
