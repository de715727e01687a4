#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 64]

Needs one CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them.  Each phase prints one JSON line; any failure raises and ends the
run with a non-zero exit code.

  1. device  — the card's name and power limit as nvidia-smi reports them.
  2. build   — compiles the package's CUDA kernel from its source with nvcc.
  3. kernel  — bn_stats against its plain PyTorch version on the card, at
               every (M, C) that ResNet-50 NHWC gives it at the smoke batch,
               in float32 and bfloat16, values and gradient; then its time
               beside the plain version, one library call and the bound.
  4. main    — ResNet-50 NHWC 224x224 at full width, bf16 compute over fp32
               master weights, trained through Module: STEPS
               forward_backward + update steps on one batch, then one fit
               epoch over an NDArrayIter of FIT_BATCHES batches.  Launch
               counts are reset before each and must equal 51 BatchNorms x
               steps after it.
  5. parity  — a small NHWC ResNet takes one fp32 step on the card and on
               the CPU from the same parameters and batch (TF32 off).

The last two lines are the kernels table and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models.resnet import get_resnet, resnet
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.symbol import _infer_graph_shapes, _topo_order

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
IMAGE = (224, 224, 3)
STEPS, WARM = 10, 2  # steps on the repeated batch; the first WARM are not timed
FIT_BATCHES = 3
# kernel vs plain version: both sum the same fp32 values (bf16 converts to
# fp32 exactly) in different orders, so values agree to fp32 rounding; a
# bf16 gradient is rounded to bf16 once on each side (one bf16 ulp)
TOL = {"values": 1e-5, "grad": {torch.float32: 1e-5, torch.bfloat16: 1e-2}}
# card vs CPU after one fp32 step, TF32 off: cuDNN and the CPU kernels sum
# convolutions in different orders, amplified through BatchNorm
PARITY_ATOL, PARITY_RTOL = 1e-4, 1e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def timed_ms(fn, iters=20):
    """Mean ms per call over `iters` calls, CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bn_input_shapes(net, data_shape):
    """{(M, C): number of BatchNorm nodes} of a channel-last symbol."""
    node_shapes, _ = _infer_graph_shapes(net._entries, {"data": data_shape})
    counts = Counter()
    for node in _topo_order(net._entries):
        if node.op is not None and node.op.name == "BatchNorm":
            src, idx = node.inputs[0]
            shape = node_shapes[(id(src), idx)]
            counts[(math.prod(shape[:-1]), shape[-1])] += 1
    return counts


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch_device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build():
    t0 = time.time()
    kernels._launcher()  # compiles csrc/bn_stats.cu with nvcc and loads it
    emit("build", seconds=round(time.time() - t0, 3), kernels=["bn_stats"])


def _grad(fn, x, g):
    xg = x.detach().clone().requires_grad_(True)
    mean, msq = fn(xg, 1)
    (mean * g[0] + msq * g[1]).sum().backward()
    return xg.grad.float()


def phase_kernel(shapes):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # max abs error, and max abs error over the largest reference value
    max_err = {"values": 0.0, "grad": 0.0, "values_rel": 0.0, "grad_rel": 0.0}
    rows = []
    totals = Counter()
    for (m, c), n_nodes in sorted(shapes.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(m, c, generator=gen, device=dev) + 0.25).to(dtype)
            got, want = kernels.bn_stats(x, 1), kernels.bn_stats_reference(x, 1)
            for a, b in zip(got, want):
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
                require(err <= TOL["values"] * scale + 1e-7,
                        "bn_stats values off at M=%d C=%d %s: %g" % (m, c, dtype, err))
                max_err["values"] = max(max_err["values"], err)
                max_err["values_rel"] = max(max_err["values_rel"], err / scale)
            g = torch.randn(2, c, generator=gen, device=dev)
            ga, gb = _grad(kernels.bn_stats, x, g), _grad(kernels.bn_stats_reference, x, g)
            err, scale = (ga - gb).abs().max().item(), gb.abs().max().item()
            require(err <= TOL["grad"][dtype] * scale,
                    "bn_stats gradient off at M=%d C=%d %s: %g" % (m, c, dtype, err))
            max_err["grad"] = max(max_err["grad"], err)
            max_err["grad_rel"] = max(max_err["grad_rel"], err / scale)
        # times at the main path's dtype
        x = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            row = {"M": m, "C": c, "nodes": n_nodes,
                   "kernel_ms": timed_ms(lambda: kernels._launch_sums(x)),
                   "plain_ms": timed_ms(lambda: kernels.bn_stats_reference(x, 1)),
                   "library_ms": timed_ms(lambda: torch.var_mean(x, dim=0, correction=0)),
                   "bound_ms": (m * c * x.element_size() + 2 * c * 4) / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
            totals[key] += row[key] * n_nodes
    torch.cuda.synchronize()
    emit("kernel", name="bn_stats", tolerance=dict(values=TOL["values"],
                                                   grad_f32=TOL["grad"][torch.float32],
                                                   grad_bf16=TOL["grad"][torch.bfloat16]),
         max_abs_err=max_err["values"], max_rel_err=max_err["values_rel"],
         grad_max_abs_err=max_err["grad"], grad_max_rel_err=max_err["grad_rel"],
         timed_dtype="bfloat16", shapes=rows)
    return max_err, dict(totals)


def _ce(out, label):
    p = out.data.gather(1, label.data.long().view(-1, 1).to(out.data.device))
    return -(p + 1e-8).log().mean()


def phase_main(batch_size, card, n_bn):
    mx.random.seed(0)
    net = resnet(50, layout="NHWC")
    mod = mx.mod.Module(net, context=mx.gpu(0), compute_dtype="bfloat16")
    mod.bind(data_shapes=[("data", (batch_size,) + IMAGE)],
             label_shapes=[("softmax_label", (batch_size,))])
    t0 = time.time()
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2))
    init_s = time.time() - t0
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    rng = np.random.RandomState(0)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.randn(batch_size, *IMAGE).astype("float32"), ctx=mx.gpu(0))],
        label=[mx.nd.array(rng.randint(0, 1000, batch_size).astype("float32"),
                           ctx=mx.gpu(0))])
    torch.cuda.reset_peak_memory_stats()
    kernels.bn_stats.launches = 0
    losses = []
    for step in range(STEPS):
        if step == WARM:
            torch.cuda.synchronize()
            t0 = time.time()
        mod.forward_backward(batch)
        mod.update()
        losses.append(_ce(mod.get_outputs()[0], batch.label[0]))
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    step_launches = kernels.bn_stats.launches
    losses = [v.item() for v in losses]
    require(all(math.isfinite(v) for v in losses), "non-finite loss: %s" % losses)
    require(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    require(step_launches == n_bn * STEPS,
            "bn_stats launched %d times in %d steps, want %d"
            % (step_launches, STEPS, n_bn * STEPS))
    img_s = batch_size * (STEPS - WARM) / elapsed
    emit("main", model="resnet50", layout="NHWC", batch=batch_size,
         compute_dtype="bfloat16", steps=STEPS, losses=losses,
         bn_stats_launches=step_launches, img_per_s=img_s,
         step_ms=elapsed / (STEPS - WARM) * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         init_params_s=init_s, card=card)

    n_fit = FIT_BATCHES * batch_size
    it = mx.io.NDArrayIter(rng.randn(n_fit, *IMAGE).astype("float32"),
                           rng.randint(0, 1000, n_fit).astype("float32"),
                           batch_size=batch_size)
    fit_losses = []
    kernels.bn_stats.launches = 0
    t0 = time.time()
    mod.fit(it, num_epoch=1, eval_metric="ce",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            batch_end_callback=lambda p: fit_losses.append(float(p.eval_metric.get()[1])))
    torch.cuda.synchronize()
    fit_launches = kernels.bn_stats.launches
    require(len(fit_losses) == FIT_BATCHES and all(map(math.isfinite, fit_losses)),
            "fit losses: %s" % fit_losses)
    require(fit_launches == n_bn * FIT_BATCHES,
            "bn_stats launched %d times in a %d-batch fit epoch, want %d"
            % (fit_launches, FIT_BATCHES, n_bn * FIT_BATCHES))
    emit("fit", batches=FIT_BATCHES, running_ce=fit_losses,
         bn_stats_launches=fit_launches, seconds=time.time() - t0)
    return step_launches + fit_launches


def phase_parity():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    x = rng.randn(8, 64, 64, 3).astype("float32")
    y = rng.randint(0, 10, 8).astype("float32")
    res = []  # [card, CPU]
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(0)
        net = get_resnet([1, 1, 1, 1], [8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 64, 64), layout="NHWC")
        mod = mx.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("softmax_label", y.shape)])
        mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                             [mx.nd.array(y, ctx=ctx)]))
        mod.update()
        args, aux = mod.get_params()
        res.append(dict(out=mod.get_outputs()[0].asnumpy(),
                        **{k: v.asnumpy() for k, v in {**args, **aux}.items()}))
    card, host = res
    errs = {k: float(np.abs(card[k] - host[k]).max()) for k in host}
    bad = [k for k in host if not np.allclose(card[k], host[k],
                                              rtol=PARITY_RTOL, atol=PARITY_ATOL)]
    require(not bad, "card vs CPU mismatch in %s" % bad)
    emit("parity", tf32=False, atol=PARITY_ATOL, rtol=PARITY_RTOL,
         out_max_abs_err=errs["out"], param_max_abs_err=max(errs.values()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port "
              "and has no CPU mode", file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    shapes = bn_input_shapes(resnet(50, layout="NHWC"), (args.batch,) + IMAGE)
    n_bn = sum(shapes.values())
    require(n_bn == 51, "ResNet-50 has %d BatchNorm nodes, want 51" % n_bn)
    max_err, totals = phase_kernel(shapes)
    launches = phase_main(args.batch, card, n_bn)
    phase_parity()
    torch.cuda.synchronize()
    print(json.dumps({"kernels": [{
        "name": "bn_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/bn_stats.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:109",
        "launches": launches, "launches_per_step": n_bn,
        "max_abs_err": max_err["values"], "max_rel_err": max_err["values_rel"],
        "grad_max_abs_err": max_err["grad"], "grad_max_rel_err": max_err["grad_rel"],
        # per training step: the sum over its 51 BatchNorm call sites
        "ms": totals["kernel_ms"], "kernel_ms": totals["kernel_ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": "bytes", "library_ms": totals["library_ms"],
        "library_call": "torch.var_mean(x, dim=0, correction=0)",
        "dtype": "bfloat16", "batch": args.batch, "card": card}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
