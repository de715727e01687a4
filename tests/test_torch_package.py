"""Hygiene of the port: mxnet_tpu_torch and chip_smoke.py import neither JAX
nor the JAX package, and the port never falls back to the CPU on its own."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch as mx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module_name):
    root = module_name.split(".")[0]
    return root in FORBIDDEN or root.startswith("jax")


def test_import_pulls_in_no_jax():
    code = ("import sys, mxnet_tpu_torch\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120, check=True).stdout.split()
    assert "mxnet_tpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


def _port_sources():
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += ["%s: %s" % (os.path.relpath(path, REPO), n) for n in names if _forbidden(n)]
    assert bad == []


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2, name="fc")
    for entry in (lambda: mx.gpu(0), lambda: mx.tpu(), mx.current_context,
                  lambda: mx.mod.Module(net, label_names=None)):
        with pytest.raises(mx.MXNetError, match=re.escape("context=mx.cpu()")):
            entry()
    # asking for the CPU works and says so
    mod = mx.mod.Module(net, label_names=None, context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
    assert mod._exec_group.execs[0].arg_dict["fc_weight"].data.device == torch.device("cpu")
