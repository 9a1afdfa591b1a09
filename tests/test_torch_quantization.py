"""The port's quantization (`quantization.py`) against the JAX package's
on the CPU.

`fake_quantize_dequantize` (its cases are in `tests/torch_op_cases.py`'s
`VISION_CASES`): the straight-through gradient, the dtype kept. QAT:
`ImperativeQuantAware().quantize` over a small conv net (the state-dict
keys, each weight listed once), then 3 Momentum steps of the port's
`jit.TrainStep` against the JAX TrainStep run in float64, in a process
of its own, by `tests/torch_quant_ref.py`, as `tests/torch_vision_ref.py`
runs its references (the port has no float64: its dtype rule is the JAX
package's x64-off rule; in float32 on both sides a rounding to the int8
grid can flip where the two packages' products differ in their last
bit, and the float64 reference sits off those boundaries). PTQ: the
scales of all four algorithms equal to JAX's, on a net whose weights
and inputs sit on a dyadic grid, so every product and sum is exact in
float32 and each layer sees the same input bit for bit in both
packages; the converted models' logits.
`convert_to_int8`: the int8 weights and scales bit-equal to JAX's, the
buffers loaded from a JAX state dict bit for bit and through `save` /
`load` in both packages.

Tolerances: the float32 QAT losses within 1e-6 relative of the float64
reference and every tensor within 1e-6 x max(1, |ref|); the STE
gradient exactly 1; PTQ scales, int8 weights and scales exactly;
float32 logits within 1e-5 x max(1, |ref|).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import quantization as jq
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.jit import TrainStep
import torch_quant_ref as qref

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _sd(model, seed, grid=None):
    """Seeded weights for `model`'s state dict: uniform in [-0.5, 0.5],
    or, with `grid`, multiples of 1/grid in [-1, 1]."""
    r = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        if grid:
            a = r.randint(-grid, grid + 1, tuple(v.shape)) / grid
        else:
            a = r.uniform(-0.5, 0.5, tuple(v.shape))
        out[k] = a.astype("f4")
    return out


def test_ste_gradient_is_the_identity_and_the_dtype_is_kept():
    x = np.linspace(-1, 1, 16).astype("f4")
    for P in (pj, pt):
        t = P.to_tensor(x, stop_gradient=False)
        y = P.quantization.fake_quantize_dequantize(t, bits=4)
        assert len(np.unique(np.round(y.numpy(), 5))) <= 17
        y.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.ones(16, "f4"))
    want = jq.fake_quantize_dequantize(pj.to_tensor(x), bits=4).numpy()
    got = tq.fake_quantize_dequantize(pt.to_tensor(x), bits=4).numpy()
    np.testing.assert_array_equal(got, want)
    b = tq.fake_quantize_dequantize(pt.to_tensor(x).astype("bfloat16"),
                                    bits=8, scale=0.9)
    assert str(b.dtype).endswith("bfloat16")


def test_quantize_wraps_every_quantizable_layer_and_lists_weights_once():
    jm = jq.ImperativeQuantAware().quantize(qref.qat_net(pj))
    tm = tq.ImperativeQuantAware().quantize(qref.qat_net(pt))
    assert list(tm.state_dict()) == list(jm.state_dict())
    wrapped = [k for k, v in tm._sub_layers.items()
               if isinstance(v, tq.FakeQuantWrapper)]
    assert wrapped == ["0", "2", "5"]
    ids = [id(p._data) for p in tm.parameters()]
    assert len(ids) == len(set(ids)) == 6
    assert [tuple(p.shape) for p in tm.parameters()] == \
        [tuple(p.shape) for p in jm.parameters()]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tq.ImperativeQuantAware().save_quantized_model(tm, "unused")


def test_qat_forward_and_gradients_reach_the_real_weights():
    """One eager QAT step in float32: the logits and every weight's
    gradient against JAX's (the fake-quantized weights' STE gradient
    lands on the wrapped layer's own Parameter)."""
    jm = jq.ImperativeQuantAware().quantize(qref.qat_net(pj))
    tm = tq.ImperativeQuantAware().quantize(qref.qat_net(pt))
    sd = _sd(jm, 1)
    jm.set_state_dict(sd)
    assert tm.set_state_dict(sd) == ([], [])
    x = np.random.RandomState(2).uniform(-1, 1, (4, 3, 8, 8)).astype("f4")
    cot = np.random.RandomState(3).uniform(-1, 1, (4, 5)).astype("f4")
    outs = {}
    for name, P, m in (("jax", pj, jm), ("port", pt, tm)):
        out = m(P.to_tensor(x))
        (out * P.to_tensor(cot)).sum().backward()
        outs[name] = (out.numpy(), {k: p.grad.numpy() for k, p in
                                    m.named_parameters()})
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=1e-5,
                               atol=1e-5)
    for k, want in outs["jax"][1].items():
        got = outs["port"][1][k]
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-4 * scale, k


def test_qat_trainstep_matches_the_jax_float64_reference(tmp_path):
    tm = tq.ImperativeQuantAware().quantize(qref.qat_net(pt))
    sd = _sd(tm, 0)
    r = np.random.RandomState(4)
    blobs = {f"sd/{k}": v for k, v in sd.items()}
    for i in range(qref.QAT_STEPS):
        blobs[f"x{i}"] = r.uniform(-1, 1, (4, 3, 8, 8)).astype("f4")
        blobs[f"y{i}"] = r.randint(0, 5, (4,)).astype("int64")
    np.savez(tmp_path / "in.npz", **blobs)
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                 "torch_quant_ref.py"),
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                   check=True, env=env, timeout=600)
    ref = dict(np.load(tmp_path / "out.npz"))
    assert tm.set_state_dict(sd) == ([], [])
    opt = pt.optimizer.Momentum(learning_rate=qref.QAT_LR,
                                momentum=qref.QAT_MOMENTUM,
                                parameters=tm.parameters())
    step = TrainStep(tm, lambda out, y: pt.nn.functional.cross_entropy(
        out, y), opt)
    losses = [float(step((pt.to_tensor(blobs[f"x{i}"]),),
                         (pt.to_tensor(blobs[f"y{i}"]),)))
              for i in range(qref.QAT_STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    assert losses[-1] < losses[0]
    for k, v in tm.state_dict().items():
        got = v.numpy()
        want = ref[f"sd/{k}"]
        assert got.dtype == np.float32 and want.dtype == np.float64, k
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-6 * scale, k
        assert not np.array_equal(want, sd[k]), f"{k} did not move"


def _dyadic_batches(k=4):
    r = np.random.RandomState(6)
    return [(r.randint(-4, 5, (2, 3, 8, 8)) / 4).astype("f4")
            for _ in range(k)]


@pytest.mark.parametrize("algo", ["abs_max", "avg", "hist", "KL"])
def test_ptq_scales_equal_jax(algo):
    models, scales, logits = {}, {}, {}
    data = _dyadic_batches()
    for name, P, Q in (("jax", pj, jq), ("port", pt, tq)):
        m = qref.qat_net(P)
        m.set_state_dict(_sd(m, 5, grid=8))
        ptq = Q.PostTrainingQuantization(m, algo=algo)
        scales[name] = ptq.calibrate([P.to_tensor(x) for x in data])
        models[name] = ptq.convert()
        logits[name] = models[name](P.to_tensor(data[0])).numpy()
    assert scales["port"] == scales["jax"]
    assert len(scales["jax"]) == 3 and min(scales["jax"].values()) > 0
    assert list(models["port"].state_dict()) == \
        list(models["jax"].state_dict())
    want = logits["jax"]
    assert np.abs(logits["port"] - want).max() <= \
        1e-5 * max(1.0, float(np.abs(want).max()))


def test_convert_to_int8_bit_equal_to_jax_and_loads_bit_for_bit(tmp_path):
    nets = {}
    for name, P in (("jax", pj), ("port", pt)):
        nets[name] = P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),
                                     P.nn.Linear(32, 4))
    sd = _sd(nets["jax"], 7)
    x = np.random.RandomState(8).randn(8, 16).astype("f4")
    ref, conv = {}, {}
    for name, P, Q in (("jax", pj, jq), ("port", pt, tq)):
        nets[name].set_state_dict(sd)
        ref[name] = nets[name](P.to_tensor(x)).numpy()
        model, n = Q.convert_to_int8(nets[name])
        assert n == 2 and isinstance(model[0], Q.QuantizedLinear)
        conv[name] = model
    jsd = {k: np.asarray(v.numpy()) for k, v in conv["jax"].state_dict()
           .items()}
    tsd = conv["port"].state_dict()
    assert list(tsd) == list(jsd)
    for k, want in jsd.items():
        got = tsd[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert str(tsd["0.w_int8"].dtype).endswith("int8")
    out = conv["port"](pt.to_tensor(x)).numpy()
    np.testing.assert_allclose(out, conv["jax"](pj.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    # int8 rounding: a small relative error on the logits
    assert np.max(np.abs(out - ref["port"])) / \
        (np.max(np.abs(ref["port"])) + 1e-9) < 0.02
    # a converted port model built from other weights takes the JAX
    # converted state dict bit for bit
    other = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                             pt.nn.Linear(32, 4))
    other, _ = tq.convert_to_int8(other)
    assert other.set_state_dict(jsd) == ([], [])
    for k, want in jsd.items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), want)
    # through save: the port's file read back by both packages
    path = str(tmp_path / "int8.pdparams")
    pt.save(conv["port"].state_dict(), path)
    for P in (pt, pj):
        back = P.load(path)
        for k, want in jsd.items():
            got = np.asarray(back[k].numpy() if hasattr(back[k], "numpy")
                             else back[k])
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want)


def test_qat_trains_eagerly_like_the_jax_test():
    """tests/test_opt_wrappers_quant.py's QAT check on the port: 30 eager
    Adam steps halve the loss."""
    class N(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(4, 8)
            self.fc2 = pt.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    pt.seed(0)
    m = tq.ImperativeQuantAware().quantize(N())
    assert isinstance(m._sub_layers["fc1"], tq.FakeQuantWrapper)
    opt = pt.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
    x = np.random.RandomState(0).randn(16, 4).astype("f4")
    y = (x[:, 0] > 0).astype("int64")
    losses = []
    for _ in range(30):
        loss = pt.nn.functional.cross_entropy(m(pt.to_tensor(x)),
                                              pt.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert losses[-1] < 0.5 * losses[0]
