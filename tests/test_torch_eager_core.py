"""The rest of the port's eager core against the JAX package: the
sequence ops' host edges, `save`/`load` of a file the JAX package wrote
(bf16 included) and the checkpoint manifest, `SelectedRows`, the AMP
white and black lists, the random ops (shape, dtype, range, moments,
replay under one seed), the optimizers over `Parameter`s, and a 2-layer,
64-wide GPT written once against a package argument
(`chip_smoke.tensor_gpt_loss`) and run on both packages, with the loss
and every gradient compared.

Tolerances: f32 values within 1e-5 x max(1, |ref|); gradients within
1e-4 x max(1, max|g|); integers, booleans and dtypes exactly; the random
ops' moments within the stated bounds (about 5 standard errors).
"""
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework import serialization as j_ser
from paddle_tpu.framework import state as j_state
from paddle_tpu.framework.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.framework import serialization as t_ser
from paddle_tpu_torch.framework import state as t_state
from paddle_tpu_torch.framework.selected_rows import SelectedRows as TRows

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def close(got, want, rtol=FWD_RTOL):
    got = np.asarray(got.numpy() if hasattr(got, "numpy") else got,
                     dtype="f8")
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want,
                      dtype="f8")
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (np.abs(got - want) <= rtol * np.maximum(1, np.abs(want))).all()


def gclose(got, want):
    got, want = np.asarray(got.numpy()), np.asarray(want.numpy())
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= GRAD_RTOL * scale


def test_sequence_pad_and_unpad_host_edges():
    seqs = [np.arange(6, dtype="f4").reshape(3, 2),
            np.ones((1, 2), "f4"), np.zeros((4, 2), "f4")]
    for maxlen in (None, 2):
        tp, tl = pt.ops.sequence.sequence_pad(seqs, -1.0, maxlen=maxlen)
        jp, jl = pj.ops.sequence.sequence_pad(seqs, -1.0, maxlen=maxlen)
        close(tp, jp)
        np.testing.assert_array_equal(tl.numpy(), jl.numpy())
        assert str(tl.dtype).endswith(str(jl.dtype))
        for a, b in zip(pt.ops.sequence.sequence_unpad(tp, tl),
                        pj.ops.sequence.sequence_unpad(jp, jl)):
            close(a, b)


def test_load_reads_a_jax_written_file(tmp_path):
    r = np.random.RandomState(0)
    w = r.randn(3, 4).astype("f4")
    obj = {"w": pj.to_tensor(w), "i": pj.to_tensor([1, 2, 3]),
           "h": pj.to_tensor(w, dtype="bfloat16"),
           "nested": [pj.to_tensor([True, False]), 7, "name"],
           "step": 3}
    path = tmp_path / "jax.pdparams"
    digest = pj.save(obj, str(path))
    got = pt.load(str(path))
    close(got["w"], w)
    assert got["w"].dtype == torch.float32
    assert got["i"].dtype == torch.int32 and got["i"].tolist() == [1, 2, 3]
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].numpy(), np.asarray(obj["h"].numpy(), dtype="f4"))
    assert got["nested"][0].tolist() == [True, False]
    assert got["nested"][1:] == [7, "name"] and got["step"] == 3
    assert got["w"].place == pt.CPUPlace()
    arrays = pt.load(str(path), return_numpy=True)
    assert arrays["h"].dtype == np.float32        # no ml_dtypes needed
    # the digest save returns is the file's own
    assert digest == t_ser._file_sha256(str(path))


def test_port_round_trip_and_the_direction_back(tmp_path):
    t = {"w": pt.to_tensor(np.arange(6, dtype="f4").reshape(2, 3)),
         "b": pt.to_tensor([1.5, -2.0], dtype="bfloat16"),
         "lst": (pt.to_tensor([4, 5]), 1.0)}
    path = tmp_path / "port.pdparams"
    pt.save(t, str(path))
    back = pt.load(str(path))
    close(back["w"], t["w"])
    assert back["b"].dtype == torch.bfloat16
    close(back["b"].astype("float32"), t["b"].astype("float32"))
    assert isinstance(back["lst"], tuple) and back["lst"][0].tolist() == \
        [4, 5]
    assert not list(tmp_path.glob("*.tmp.*"))        # atomic: no litter
    # the JAX package reads the port's file as its own tensors, bf16
    # included (its payload global, written without importing it)
    jl = pj.load(str(path))
    assert isinstance(jl["w"], pj.Tensor) and isinstance(jl["b"], pj.Tensor)
    close(jl["w"].numpy(), t["w"].numpy())
    assert str(jl["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jl["b"].numpy(), "f4"),
                                  t["b"].numpy())
    assert isinstance(jl["lst"], tuple) and jl["lst"][1] == 1.0
    assert jl["lst"][0].numpy().tolist() == [4, 5]
    assert str(jl["lst"][0].dtype) == "int32"
    jnp_arrays = pj.load(str(path), return_numpy=True)
    assert jnp_arrays["w"].dtype == np.float32


def test_manifest_matches_jax_and_detects_a_torn_pair(tmp_path):
    for pkg, ser in ((pj, j_ser), (pt, t_ser)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        prefix = str(d / "step3")
        files = {}
        for ext, val in ((".pdparams", [1.0]), (".pdopt", [2.0])):
            files["step3" + ext] = pkg.save({"v": pkg.to_tensor(val)},
                                            prefix + ext)
        doc = ser.write_manifest(prefix, step=3, files=files)
        assert doc["version"] == 3 and doc["step"] == 3
        assert ser.latest_checkpoint(str(d)) == prefix
    # each package reads and verifies the other's manifest
    jdir, tdir = tmp_path / "paddle_tpu", tmp_path / "paddle_tpu_torch"
    assert t_ser.latest_checkpoint(str(jdir)) == str(jdir / "step3")
    assert j_ser.latest_checkpoint(str(tdir)) == str(tdir / "step3")
    jdoc = json.loads((jdir / "latest.json").read_text())
    tdoc = json.loads((tdir / "latest.json").read_text())
    assert set(jdoc) == set(tdoc) and jdoc["files"].keys() == \
        tdoc["files"].keys()
    # re-saving one file of the pair tears it: both refuse it
    pt.save({"v": pt.to_tensor([9.0])}, str(tdir / "step3.pdparams"))
    assert t_ser.latest_checkpoint(str(tdir)) is None
    assert j_ser.latest_checkpoint(str(tdir)) is None
    assert t_ser.latest_checkpoint(str(tdir), verify=False) is not None
    assert t_ser.read_manifest(str(tmp_path)) is None


def test_selected_rows_match_jax():
    rows = np.array([3, 1, 3, 0], "int32")
    vals = np.random.RandomState(0).randn(4, 2).astype("f4")
    t, j = TRows(rows, vals, 5), JRows(rows, vals, 5)
    assert t.shape == j.shape == [5, 2]
    close(t.to_dense(), np.asarray(j.to_dense()))
    tm, jm = t.merge(), j.merge()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    close(tm.values, np.asarray(jm.values))
    both = t + TRows(np.array([1], "int32"), vals[:1], 5)
    jboth = j + JRows(np.array([1], "int32"), vals[:1], 5)
    close(both.to_dense(), np.asarray(jboth.to_dense()))
    dense = np.ones((5, 2), "f4")
    close(t + torch.from_numpy(dense), np.asarray(j + dense))
    assert t.astype("bfloat16").dtype == torch.bfloat16
    assert repr(t) == repr(j)
    with pytest.raises(ValueError):
        TRows(rows, vals[:2], 5)


def test_amp_lists_cast_like_jax():
    import jax.numpy as jnp
    a = np.random.RandomState(0).randn(4, 4).astype("f4")
    for P, st, low in ((pt, t_state, torch.bfloat16),
                       (pj, j_state, jnp.bfloat16)):
        x = P.to_tensor(a)
        with st.amp_guard_ctx({"level": "O1", "dtype": low}):
            mm = P.matmul(x, x)                   # white: low precision
            e = P.exp(mm)                         # black: back to f32
            s = mm + mm                           # gray: follows inputs
            lse = P.logsumexp(mm, axis=1)
        assert st.get_amp_state() is None
        got = [str(t.dtype).replace("torch.", "") for t in (mm, e, s, lse)]
        assert got == ["bfloat16", "float32", "bfloat16", "float32"], \
            (P.__name__, got)


def test_random_ops_shapes_ranges_moments_and_replay():
    n = 20000

    def draws():
        pt.seed(7)
        return {"rand": pt.rand([n]), "randn": pt.randn([n]),
                "normal": pt.normal(1.0, 2.0, [n]),
                "uniform": pt.uniform([n], min=-3.0, max=1.0),
                "randint": pt.randint(2, 9, [n]), "randperm": pt.randperm(50),
                "bernoulli": pt.bernoulli(pt.full([n], 0.3)),
                "multinomial": pt.multinomial(pt.to_tensor([0.2, 0.8]),
                                              n, replacement=True),
                "shuffle": pt.ops.creation.shuffle(pt.arange(50)),
                "standard_normal": pt.standard_normal([n])}
    a, b = draws(), draws()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
        assert a[k].place == pt.CPUPlace()
    se = 5 / np.sqrt(n)
    r = a["rand"].numpy()
    assert a["rand"].dtype == torch.float32 and 0 <= r.min() and r.max() < 1
    assert abs(r.mean() - 0.5) < se * 0.3
    z = a["randn"].numpy()
    assert abs(z.mean()) < se and abs(z.std() - 1) < se
    g = a["normal"].numpy()
    assert abs(g.mean() - 1) < 2 * se and abs(g.std() - 2) < 2 * se
    u = a["uniform"].numpy()
    assert -3 <= u.min() and u.max() < 1 and abs(u.mean() + 1) < 2 * se
    i = a["randint"]
    assert i.dtype == torch.int32 and 2 <= int(i.min()) and int(i.max()) < 9
    assert sorted(a["randperm"].tolist()) == list(range(50))
    assert a["randperm"].dtype == torch.int32
    assert pj.randperm(5).numpy().dtype == np.int32
    assert abs(a["bernoulli"].numpy().mean() - 0.3) < se
    assert a["multinomial"].dtype == torch.int32
    assert abs(a["multinomial"].numpy().mean() - 0.8) < se
    assert sorted(a["shuffle"].tolist()) == list(range(50))
    assert pt.multinomial(pt.to_tensor([[0.5, 0.5, 0.0]]), 2).shape == [1, 2]
    pt.seed(8)
    assert not np.array_equal(pt.rand([n]).numpy(), r)
    # the generator's state round-trips
    st = t_state.rng_state()
    x1 = pt.randn([4]).numpy()
    t_state.set_rng_state(st)
    np.testing.assert_array_equal(pt.randn([4]).numpy(), x1)


def test_optimizers_step_parameters_like_jax():
    """AdamW over Parameters: step, clear_grad and the weights against the
    JAX package's eager step."""
    r = np.random.RandomState(0)
    wa, xa = r.randn(4, 3).astype("f4"), r.randn(5, 4).astype("f4")
    out = {}
    for P, opt_mod in ((pt, "paddle_tpu_torch.optimizer"),
                       (pj, "paddle_tpu.optimizer")):
        mod = importlib.import_module(opt_mod)
        w = P.Parameter(wa)
        b = P.to_tensor(np.zeros(3, "f4"), stop_gradient=False)
        opt = mod.AdamW(learning_rate=0.1, parameters=[w, b])
        for _ in range(3):
            loss = ((P.matmul(P.to_tensor(xa), w) + b) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        assert w.grad is None and b.grad is None
        out[P] = (w, b)
    for t, j in zip(out[pt], out[pj]):
        close(t, j, rtol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_gpt_written_once_runs_on_both_packages():
    """chip_smoke's Tensor-surface GPT (`tensor_gpt_loss`), 2 layers, 64
    wide (one head of 64), seq 128 (the flash kernels' route: JAX's
    Pallas K1-K3 in interpret mode, the port's plain blocks), on both
    packages from the same weights: loss and every gradient."""
    cs = _chip_smoke()
    from paddle_tpu_torch.nlp import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops import flash_attention as t_fa
    j_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2, num_heads=1,
                    max_seq_len=128, dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device="cpu", seed=3)
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    ids = np.random.RandomState(2).randint(0, 96, (2, 128)).astype("int32")
    res = {}
    for P, fa in ((pt, t_fa), (pj, j_fa)):
        params = {k: P.Parameter(v) for k, v in weights.items()}
        loss = cs.tensor_gpt_loss(P, fa.flash_attention, params,
                                  P.to_tensor(ids), 1, 2)
        loss.backward()
        res[P] = (loss, params)
    close(res[pt][0], res[pj][0])
    for k in weights:
        gclose(res[pt][1][k].grad, res[pj][1][k].grad)
    # and the port's nn.Module model agrees (the chip check's reference)
    from paddle_tpu_torch.nlp import gpt_pretrain_loss
    ref = gpt_pretrain_loss(model(torch.from_numpy(ids)),
                            torch.from_numpy(ids))
    close(res[pt][0], float(ref.detach()))


def test_create_parameter_and_top_level_surface():
    p = pt.create_parameter([2, 3], "float32", is_bias=True)
    assert isinstance(p, pt.Parameter) and p.numpy().sum() == 0
    q = pt.create_parameter([2], "float32", default_initializer=lambda s, d:
                            np.full(s, 0.5, "f4"))
    close(q, [0.5, 0.5])
    # the default is Xavier-normal (fans 300 and 200), as in the JAX
    # package
    pt.seed(0)
    x = pt.create_parameter([300, 200], "float32").numpy()
    std = np.sqrt(2.0 / 500)
    assert abs(x.mean()) < 4 * std / np.sqrt(x.size)
    assert abs(x.std() - std) < 4 * std / np.sqrt(2 * x.size)
    for name in ("to_tensor", "grad", "save", "load", "set_device",
                 "no_grad", "matmul", "gather", "logsumexp",
                 "take_along_axis", "cholesky", "equal_all", "zeros"):
        assert callable(getattr(pt, name)), name
    assert pt.in_dynamic_mode() and pt.tensor.matmul is pt.matmul
    assert pt.framework.state.get_flag("FLAGS_check_nan_inf") is False


def test_check_nan_inf_flag_names_the_op():
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(pt.errors.PreconditionNotMetError, match="log"):
            pt.log(pt.to_tensor([-1.0]))
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    with pytest.raises(RuntimeError, match="operator < reshape >"):
        pt.reshape(pt.to_tensor([1.0, 2.0]), [3])


def test_flash_attention_dropout_draws_from_the_framework_generator():
    from paddle_tpu_torch.ops import flash_attention as t_fa
    q = pt.to_tensor(np.random.RandomState(0).randn(1, 2, 16, 8)
                     .astype("f4"), stop_gradient=False)

    def draw():
        pt.seed(5)
        return t_fa.flash_attention(q, q, q, causal=True, dropout_p=0.5)
    a, b = draw(), draw()
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    a.sum().backward()
    assert q.grad is not None and not a.stop_gradient
    assert not np.array_equal(a.numpy(), t_fa.flash_attention(
        q, q, q, causal=True).numpy())
