"""A small NHWC ResNet trained through Module in both packages, from the same
seed and the same batch: identical initial parameters, matching steps in
fp32 and in bf16 compute, matching per-batch losses under fit, and JAX
weights carried into the port by from_jax_params."""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.models.resnet import get_resnet as get_resnet_j
from mxnet_tpu_torch.models.resnet import get_resnet as get_resnet_t

BATCH = 4
DATA = (BATCH, 64, 64, 3)
PKGS = {"jax": (mj, get_resnet_j), "torch": (mt, get_resnet_t)}

# fp32 tolerance: XLA's and PyTorch's CPU convolutions sum in different
# orders (~1e-7 relative per op); BatchNorm and two SGD steps with
# momentum amplify that to ~1e-4 absolute on the weights
F32_RTOL, F32_ATOL = 1e-3, 3e-4


def _net(pkg):
    mx, get = PKGS[pkg]
    return get([1, 1, 1, 1], [8, 16, 32, 64, 128], num_classes=10,
               image_shape=(3, 64, 64), layout="NHWC")


def _module(pkg, compute_dtype=None):
    mx = PKGS[pkg][0]
    mx.random.seed(0)
    mod = mx.mod.Module(_net(pkg), context=mx.cpu(), compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", DATA)], label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2))
    return mod


def _batch(pkg, x, y):
    mx = PKGS[pkg][0]
    ctx = {"ctx": mx.cpu()} if pkg == "torch" else {}
    return mx.io.DataBatch([mx.nd.array(x, **ctx)], [mx.nd.array(y, **ctx)])


def _inputs(seed=1, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *DATA[1:]).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _numpy(d):
    return {k: v.asnumpy().copy() for k, v in d.items()}


def _train(pkg, compute_dtype, steps=2):
    mod = _module(pkg, compute_dtype)
    init = _numpy(mod.get_params()[0])
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    batch = _batch(pkg, *_inputs())
    outs = []
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    args, aux = mod.get_params()
    moms = {k: v.asnumpy() for k, v in mod._updater.states.items()}
    return dict(mod=mod, init=init, outs=outs, args=_numpy(args), aux=_numpy(aux), moms=moms)


@pytest.fixture(scope="module")
def runs():
    return {(pkg, dt): _train(pkg, dt) for pkg in PKGS for dt in (None, "bfloat16")}


def _assert_dicts_close(a, b, rtol, atol):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)


def test_initial_params_identical(runs):
    for dt in (None, "bfloat16"):
        a, b = runs[("torch", dt)]["init"], runs[("jax", dt)]["init"]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_fp32_steps_match(runs):
    t, j = runs[("torch", None)], runs[("jax", None)]
    for ot, oj in zip(t["outs"], j["outs"]):
        np.testing.assert_allclose(ot, oj, rtol=1e-4, atol=2e-5)
    _assert_dicts_close(t["args"], j["args"], F32_RTOL, F32_ATOL)
    _assert_dicts_close(t["moms"], j["moms"], F32_RTOL, F32_ATOL)
    _assert_dicts_close(t["aux"], j["aux"], F32_RTOL, F32_ATOL)


def test_two_bf16_steps_track_jax(runs):
    """bf16 compute over fp32 masters.  The first forward agrees to bf16
    precision through ~20 layers (1e-2 on probabilities).  After the
    updates the two packages' bf16 rounding differs more: the JAX package
    reduces BatchNorm's parameter gradients in bf16, PyTorch accumulates
    them in fp32 (ROADMAP Queue C).  So the weights are held to 0.2
    absolute, and the port's bf16 run must land about as close to the fp32
    reference as the JAX package's own bf16 run: its L2 distance from the
    fp32 weights at most 1.25 times the JAX run's."""
    t, j = runs[("torch", "bfloat16")], runs[("jax", "bfloat16")]
    np.testing.assert_allclose(t["outs"][0], j["outs"][0], atol=1e-2)
    _assert_dicts_close(t["args"], j["args"], 0.0, 0.2)
    ref = runs[("jax", None)]["args"]

    def dist(run):
        return np.sqrt(sum(np.sum((run["args"][k] - ref[k]) ** 2) for k in ref))

    assert dist(t) <= 1.25 * dist(j)


def test_fit_per_batch_losses_match():
    x, y = _inputs(seed=2, n=3 * BATCH)
    losses = {}
    for pkg in PKGS:
        mx = PKGS[pkg][0]
        mx.random.seed(0)
        mod = mx.mod.Module(_net(pkg), context=mx.cpu())
        seen = []
        kw = {"steps_per_dispatch": 1} if pkg == "jax" else {}
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), eval_metric="ce",
                num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                           magnitude=2),
                batch_end_callback=lambda p: seen.append(p.eval_metric.get()[1]),
                **kw)
        losses[pkg] = seen
    assert len(losses["torch"]) == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4)


def test_from_jax_params_roundtrip(runs):
    """Weights trained by the JAX package, carried into the port, give the
    same inference forward (fp32 tolerance as above)."""
    jmod = runs[("jax", None)]["mod"]
    args, aux = (_numpy(d) for d in jmod.get_params())
    tmod = mt.mod.Module(_net("torch"), context=mt.cpu())
    tmod.bind(data_shapes=[("data", DATA)], label_shapes=[("softmax_label", (BATCH,))],
              for_training=False)
    tmod.set_params(*mt.from_jax_params(args, aux, module=tmod))
    x, y = _inputs(seed=3)
    jmod.forward(_batch("jax", x, y), is_train=False)
    tmod.forward(_batch("torch", x, y), is_train=False)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), rtol=1e-4, atol=2e-5)

    name = sorted(args)[0]
    with pytest.raises(mt.MXNetError, match="missing"):
        mt.from_jax_params({k: v for k, v in args.items() if k != name}, aux, module=tmod)
    with pytest.raises(mt.MXNetError, match="shape"):
        mt.from_jax_params(dict(args, **{name: args[name][..., :1]}), aux, module=tmod)


@pytest.mark.parametrize("read", ["get_outputs", "update_metric", "forward_backward"])
def test_outputs_read_before_update_runs_one_forward(runs, read, monkeypatch):
    """With the fused step armed, reading outputs before update() (a common
    order: update_metric, then update) computes the step's forward and
    backward once; update() applies the kept gradients.  Two steps give
    the outputs and parameters of the usual order."""
    from mxnet_tpu_torch.executor import Executor

    mod = _module("torch")
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    exe = mod._exec_group.execs[0]
    assert exe._fused_updater is not None
    graph_runs = []
    run = Executor._run
    monkeypatch.setattr(Executor, "_run",
                        lambda self, *a: graph_runs.append(1) or run(self, *a))
    batch = _batch("torch", *_inputs())
    metric = mt.metric.create("ce")
    outs = []
    for _ in range(2):
        if read == "forward_backward":
            exe.forward_backward(**{"data": batch.data[0], "softmax_label": batch.label[0]})
        else:
            mod.forward_backward(batch)
        if read == "update_metric":
            mod.update_metric(metric, batch.label)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
    assert len(graph_runs) == 2
    # the same arithmetic on the same CPU: equal up to summation order
    ref = runs[("torch", None)]
    for got, want in zip(outs, ref["outs"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    _assert_dicts_close(_numpy(mod.get_params()[0]), ref["args"], 1e-6, 1e-7)
