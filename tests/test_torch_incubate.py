"""The port's `incubate` (recompute, auto-checkpoint, the segment ops, the
optimizer wrappers' aliases), `compat`, `sysconfig` and
`utils.cpp_extension`, against the JAX package's.

Recompute is held against the plain run of the same function: with
dropout on, both draw from the framework generator reseeded with one
seed, and the outputs, every gradient and the generator's next draw are
equal bit for bit (the recompute hands back the forward's draws). The
segment ops hold the JAX package's values and gradients within 1e-6 x
max(1, |ref|). The auto-checkpoint's kill and resume runs
`chip_smoke.resume_check` on the CPU at a tiny size (2 layers, 32 wide,
seq 32, vocab 64, AdamW): a child process dies after epoch 1's snapshot,
a second resumes, and their losses equal an uninterrupted run's bit for
bit; the JAX package reads the port's snapshot into a JAX model with
the port's weights exactly. `cpp_extension` is the twin of
`tests/test_op_suite.py:100-141`: a Python op with a custom backward and
a g++-built host op, values equal to the JAX package's.
"""
import importlib.util
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu_torch.incubate import recompute as trc
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.ops import dispatch as tdispatch

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=32, dropout=0.0, attn_dropout=0.0)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_incubate", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ recompute

def _leaves(seed=0):
    rng = np.random.RandomState(seed)
    return (pt.to_tensor(rng.randn(6, 8).astype("f4"), stop_gradient=False),
            pt.to_tensor(rng.randn(8, 8).astype("f4"), stop_gradient=False))


def _mixed(a, scale, b, bias=0.0):
    """Tensors, a float and a keyword; a tuple out; dropout inside."""
    h = pt.nn.functional.dropout(pt.matmul(a, b), p=0.3, training=True)
    return h * scale + bias, (h * h).sum()


def _run_mixed(wrap):
    pt.seed(11)
    a, b = _leaves()
    calls = []

    def fn(*args, **kw):
        calls.append(1)
        return _mixed(*args, **kw)
    out, sq = wrap(fn, a, 2.0, b, bias=0.5)
    cot = pt.to_tensor(np.random.RandomState(5).randn(6, 8).astype("f4"))
    ((out * cot).sum() + sq).backward()
    nxt = pt.rand([4]).numpy()
    return out.numpy(), float(sq), a.grad.numpy(), b.grad.numpy(), nxt, \
        len(calls)


def test_recompute_mixed_arguments_equals_the_plain_run_with_dropout():
    plain = _run_mixed(lambda f, *a, **k: f(*a, **k))
    again = _run_mixed(trc.recompute)
    assert plain[-1] == 1 and again[-1] == 2      # the backward recomputed
    for p, r in zip(plain[:-1], again[:-1]):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(p))


def test_recompute_keeps_torch_tensors_and_runs_plain_without_grad():
    x = torch.randn(3, 4, requires_grad=True)
    y = trc.recompute(lambda t: torch.tanh(t) * 2, x)
    assert isinstance(y, torch.Tensor) and y.grad_fn is not None
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               (2 * (1 - torch.tanh(x) ** 2)).detach()
                               .numpy(), rtol=1e-6)
    calls = []
    with torch.no_grad():
        trc.recompute(lambda t: calls.append(1) or t, x)
    assert calls == [1]


def test_recompute_without_rng_preservation_redraws():
    """preserve_rng_state=False lets the recompute draw afresh: the
    gradient then differs from the plain run's."""
    plain = _run_mixed(lambda f, *a, **k: f(*a, **k))
    fresh = _run_mixed(lambda f, *a, **k: trc.recompute(
        f, *a, preserve_rng_state=False, **k))
    np.testing.assert_array_equal(fresh[0], plain[0])
    assert not np.array_equal(fresh[2], plain[2])


def _stack(P, dropout):
    nn = P.nn
    P.seed(2)
    return [nn.Linear(8, 16), nn.Dropout(dropout), nn.Linear(16, 16),
            nn.ReLU(), nn.Dropout(dropout), nn.Linear(16, 8), nn.Tanh()]


@pytest.mark.parametrize("segments", [1, 2, 3, 7])
def test_recompute_sequential_equals_the_plain_stack(segments):
    layers = _stack(pt, 0.2)
    for layer in layers:
        layer.train()
    x0 = np.random.RandomState(3).randn(4, 8).astype("f4")
    res = []
    for wrap in ("plain", "recompute"):
        pt.seed(9)
        x = pt.to_tensor(x0, stop_gradient=False)
        if wrap == "plain":
            y = x
            for layer in layers:
                y = layer(y)
        else:
            y = trc.recompute_sequential(layers, x, segments=segments)
        (y * y).sum().backward()
        grads = [p.grad.numpy().copy() for layer in layers
                 for p in layer.parameters()]
        for layer in layers:
            for p in layer.parameters():
                p.clear_gradient()
        res.append((y.numpy(), x.grad.numpy(), grads))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][1], res[0][1])
    for g1, g0 in zip(res[1][2], res[0][2]):
        np.testing.assert_array_equal(g1, g0)


def test_recompute_sequential_matches_jax_without_dropout():
    jl, tl = _stack(pj, 0.0), _stack(pt, 0.0)
    for j, t in zip(jl, tl):
        t.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    x0 = np.random.RandomState(4).randn(4, 8).astype("f4")
    from paddle_tpu.incubate.recompute import recompute_sequential as jrs
    jy = jrs(jl, JTensor(jnp.asarray(x0)), segments=2)
    ty = trc.recompute_sequential(tl, pt.to_tensor(x0, stop_gradient=False),
                                  segments=2)
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), atol=1e-6)


# -------------------------------------------------------------- segment ops

SEG_DATA = np.random.RandomState(6).randn(8, 5).astype("f4")
SEG_IDS = np.array([0, 0, 1, 1, 1, 3, 3, 4], "int32")


@pytest.mark.parametrize("num", [6, None], ids=["num_segments", "from_ids"])
@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops_match_jax(op, num):
    jx = JTensor(jnp.asarray(SEG_DATA), stop_gradient=False)
    jy = getattr(pj.incubate, op)(jx, JTensor(jnp.asarray(SEG_IDS)),
                                  num_segments=num)
    tx = pt.to_tensor(SEG_DATA, stop_gradient=False)
    ty = getattr(pt.incubate, op)(tx, pt.to_tensor(SEG_IDS),
                                  num_segments=num)
    want = np.asarray(jy.numpy())
    assert ty.shape == list(want.shape)
    np.testing.assert_allclose(ty.numpy(), want,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    cot = np.random.RandomState(8).randn(*want.shape).astype("f4")
    (jy * JTensor(jnp.asarray(cot))).sum().backward()
    (ty * pt.to_tensor(cot)).sum().backward()
    jg = np.asarray(jx.grad.numpy())
    np.testing.assert_allclose(tx.grad.numpy(), jg,
                               atol=1e-6 * max(1.0, np.abs(jg).max()))
    assert getattr(pt.incubate, op).__name__ == op


def test_incubate_exports_match_the_jax_package():
    names = ("recompute", "checkpoint", "train_epoch_range",
             "TrainEpochRange", "ModelAverage", "LookAhead", "segment_sum",
             "segment_mean", "segment_max", "segment_min")
    for n in names:
        assert hasattr(pj.incubate, n) and hasattr(pt.incubate, n), n
    assert pt.incubate.LookAhead is pt.optimizer.wrappers.LookaheadOptimizer
    assert pt.incubate.ModelAverage is pt.optimizer.wrappers.ModelAverage
    assert pt.incubate.moe.MoELayer.__name__ == "MoELayer"
    with pytest.raises(AttributeError):
        pt.incubate.nothing_here


# ---------------------------------------------------------- auto-checkpoint

def test_killed_run_resumes_and_matches_the_uninterrupted_run(tmp_path):
    cs = _chip_smoke()
    out = cs.resume_check(str(ROOT), {
        "device": "cpu", "dtype": "float32", "config": TINY, "lr": 1e-2,
        "epochs": cs.RESUME_EPOCHS, "steps": cs.RESUME_STEPS, "batch": 2},
        str(tmp_path / "resume"), timeout=300)
    assert out["restored_from"] == cs.RESUME_DIE // cs.RESUME_STEPS - 1
    # the CPU's eager steps are deterministic: equal bit for bit
    assert out["bitwise_equal"] == {"child 1": True, "child 2": True}
    assert not (tmp_path / "resume").exists()


def _range(tmp_path, model=None, opt=None, epochs=3, **kw):
    return pt.incubate.train_epoch_range(epochs, str(tmp_path), model=model,
                                         optimizer=opt, name="job", **kw)


def _model(seed=3):
    return tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY), device="cpu",
                                  seed=seed)


def test_layout_newest_snapshot_only_and_restore(tmp_path):
    m = _model()
    opt = pt.optimizer.AdamW(1e-2, parameters=m.parameters())
    step = pt.jit.TrainStep(m, tgpt.gpt_pretrain_loss, opt)
    ids = torch.randint(0, 64, (2, 32), generator=torch.Generator()
                        .manual_seed(0))
    r = _range(tmp_path, m, opt, save_checkpoint_inter=2)
    assert r.restored_from is None
    for _ in r:
        step(ids, ids)
    root = tmp_path / "job"
    assert sorted(os.listdir(root)) == ["epoch_2", "range_meta.json"]
    assert sorted(os.listdir(root / "epoch_2")) == ["model.pdparams",
                                                    "opt.pdopt"]
    assert json.loads((root / "range_meta.json").read_text()) == {
        "last_completed_epoch": 2, "max_epoch_num": 3}
    # a fresh model and optimizer take the snapshot's state in place
    m2 = _model(seed=9)
    opt2 = pt.optimizer.AdamW(1e-2, parameters=m2.parameters())
    ptrs = [p._data.data_ptr() for p in m2.parameters()]
    r2 = _range(tmp_path, m2, opt2, epochs=5)
    assert r2.restored_from == 2 and list(r2) == [3, 4]
    assert [p._data.data_ptr() for p in m2.parameters()] == ptrs
    assert opt2._global_step == opt._global_step == 3
    for (n, p), p2 in zip(m.named_parameters(), m2.parameters()):
        np.testing.assert_array_equal(p2.numpy(), p.numpy(), err_msg=n)
    for i, st in opt._state.items():
        for k, t in st.items():
            assert torch.equal(opt2._state[i][k], t), (i, k)


def test_torn_meta_starts_fresh_and_orphans_are_swept(tmp_path):
    root = tmp_path / "job"
    (root / ".saving_abc").mkdir(parents=True)
    (root / ".saving_abc" / "model.pdparams").write_bytes(b"half")
    (root / "range_meta.json").write_text('{"last_completed_ep')
    r = _range(tmp_path, _model())
    assert r.restored_from is None and list(r.get())[:1] == [0]
    assert not (root / ".saving_abc").exists()
    # the JAX package starts fresh on the same torn file
    from paddle_tpu.incubate.checkpoint import TrainEpochRange as JRange
    (root / "range_meta.json").write_text('{"last_completed_ep')
    assert JRange(3, str(tmp_path), name="job").restored_from is None


def test_jax_package_reads_the_ports_snapshot(tmp_path):
    m = _model(seed=5)
    opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
    ids = torch.randint(0, 64, (2, 32), generator=torch.Generator()
                        .manual_seed(1))
    for _ in _range(tmp_path, m, opt, epochs=1):
        tgpt.gpt_pretrain_loss(m(ids), ids).backward()
        opt.step()
        opt.clear_grad()
    from paddle_tpu.incubate.checkpoint import TrainEpochRange as JRange
    from paddle_tpu.nlp import gpt as jgpt
    pj.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**TINY))
    jr = JRange(2, str(tmp_path), model=jm, name="job")
    assert jr.restored_from == 0
    got = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    want = {k: v.numpy() for k, v in m.state_dict().items()}
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checker_reads_the_job_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "env_job")
    monkeypatch.setenv("PADDLE_CKPT_DIR", str(tmp_path / "elsewhere"))
    c = pt.incubate.checkpoint.AutoCheckpointChecker()
    j = pj.incubate.checkpoint.AutoCheckpointChecker()
    assert (c.job_id, c.ckpt_dir, c.valid) == (j.job_id, j.ckpt_dir, j.valid)
    r = pt.incubate.train_epoch_range(1, str(tmp_path / "ignored"))
    assert r.root == str(tmp_path / "elsewhere" / "env_job")
    assert list(r) == [0]
    assert (tmp_path / "elsewhere" / "env_job" / "epoch_0").is_dir()


# ------------------------------------------------------- compat, sysconfig

@pytest.mark.parametrize("x,d", [(2.5, 0), (-2.5, 0), (0.5, 0), (1.5, 0),
                                 (0.125, 2), (-0.125, 2), (1234.5678, -2),
                                 (7, 0)])
def test_compat_round_is_half_away_from_zero_as_jax(x, d):
    assert pt.compat.round(x, d) == pj.compat.round(x, d)
    assert abs(pt.compat.round(x, d)) >= abs(round(x, d))


def test_compat_helpers_and_sysconfig_match_jax():
    for fn, args in (("to_text", (b"abc",)), ("to_text", (12,)),
                     ("to_bytes", ("hé",)), ("to_bytes", (b"x",)),
                     ("floor_division", (7, 2)),
                     ("floor_division", (-7, 2)),
                     ("get_exception_message", (ValueError("boom"),))):
        assert getattr(pt.compat, fn)(*args) == \
            getattr(pj.compat, fn)(*args), fn
    pkg = ROOT / "paddle_tpu_torch"
    assert pt.sysconfig.get_include() == str(pkg / "include")
    assert pt.sysconfig.get_lib() == str(pkg / "libs")
    assert Path(pj.sysconfig.get_include()).name == \
        Path(pt.sysconfig.get_include()).name


# ----------------------------------------------------------- cpp_extension

@pytest.fixture
def _registered():
    names = []
    yield names
    for n in names:
        tdispatch.OP_REGISTRY.pop(n, None)


def test_register_python_op_with_custom_backward(_registered):
    from paddle_tpu.utils.cpp_extension import register_op as jreg
    from paddle_tpu_torch.utils import cpp_extension as cpp
    _registered.append("port_triple_square")
    op = cpp.register_op("port_triple_square", lambda x: x * x * 3,
                         backward=lambda res, g: (g * 6 * res[0],))
    assert cpp.get_op("port_triple_square") is op.raw
    x = pt.to_tensor([2.0, -1.5], stop_gradient=False)
    y = op(x)
    y.sum().backward()
    jop = jreg("port_twin_triple_square", lambda a: jnp.square(a) * 3,
               backward=lambda res, g: (g * 6 * res[0],))
    jx = pj.to_tensor([2.0, -1.5], stop_gradient=False)
    jy = jop(jx)
    jy.sum().backward()
    np.testing.assert_allclose(y.numpy(), jy.numpy())
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy())
    np.testing.assert_allclose(y.numpy(), [12.0, 6.75])
    np.testing.assert_allclose(x.grad.numpy(), [12.0, -9.0])
    # without a backward, torch autograd differentiates the forward
    _registered.append("port_cube")
    cube = cpp.register_op("port_cube", lambda a: a * a * a)
    z = pt.to_tensor([2.0], stop_gradient=False)
    cube(z).backward()
    np.testing.assert_allclose(z.grad.numpy(), [12.0])


def test_cpp_extension_host_op(tmp_path, _registered):
    from paddle_tpu.utils import cpp_extension as jcpp
    from paddle_tpu_torch.utils import cpp_extension as cpp
    src = tmp_path / "my_relu.cc"
    src.write_text(
        'extern "C" void my_relu(float* out, const float* in, long long n)'
        '{ for (long long i = 0; i < n; ++i)'
        '  out[i] = in[i] > 0.f ? in[i] : 0.f; }')
    lib = cpp.load("port_relu_ext", str(src), build_directory=str(tmp_path))
    assert (tmp_path / "libport_relu_ext.so").exists()
    _registered.append("port_cpp_relu")
    op = cpp.host_op("port_cpp_relu", lib, "my_relu")
    x = np.array([-1.0, 2.0, -3.0, 4.0], dtype="f4")
    got = op(pt.to_tensor(x, stop_gradient=False))
    np.testing.assert_allclose(got.numpy(), [0, 2, 0, 4])
    assert got.stop_gradient and got._data.dtype == torch.float32
    jlib = jcpp.load("port_relu_jax_ext", str(src),
                     build_directory=str(tmp_path))
    jop = jcpp.host_op("port_twin_cpp_relu", jlib, "my_relu")
    np.testing.assert_array_equal(got.numpy(),
                                  jop(pj.to_tensor(x)).numpy())
    with pytest.raises(RuntimeError, match="build failed"):
        bad = tmp_path / "bad.cc"
        bad.write_text("this is not C++")
        cpp.load("port_bad_ext", str(bad), build_directory=str(tmp_path))
