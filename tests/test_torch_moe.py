"""The port's Mixture-of-Experts (`paddle_tpu_torch.incubate.moe` and the
GPT's `moe_experts` config) against the JAX package's
(`paddle_tpu.incubate.moe`, `paddle_tpu.nlp.gpt`).

Inputs and weights are seeded numpy arrays (the JAX layer's and model's
weights carried into the port by `set_state_dict` / `load_jax_state`).
The models are `tests/test_moe.py`'s: vocab 64, 32 wide, 2 layers, 2
heads, seq 16, 4 experts, top-2, capacity factor 4.0, dropout 0.

Tolerances: `moe_dispatch`'s plan (the dispatch one-hots) equal bit for
bit; the combine weights (the gate probabilities) within 1e-7 absolute,
one f32 ulp of a value below 1: XLA's and torch's CPU exp differ by an
ulp on some inputs; aux within 1e-6. Layer outputs atol 1e-5 and every
gradient within 1e-4 x max(1, max|g|) (f32, summed in different orders).
GPT losses within 1e-5 relative, gradients as above; the 3-step AdamW
TrainStep trajectories within rtol 1e-3 (AdamW's first steps move a
weight by about lr whatever its gradient, so a near-zero gradient's
rounding moves one weight by up to 2 lr); the port's recompute run equal
to its plain run within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

MOE_GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=16, dropout=0.0, attn_dropout=0.0,
               moe_experts=4, moe_k=2, moe_capacity_factor=4.0)
IDS = np.random.RandomState(0).randint(0, 64, (2, 16)).astype("int32")


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _tied_logits():
    """Logits with exact ties: every token's top two experts tie at the
    first round, and the lowest index must win."""
    lg = np.zeros((24, 4), "f4")
    lg[:, 1] = lg[:, 3] = 2.0
    lg[::3, 2] = 2.0
    lg[::4, 0] = 2.0
    return lg


@pytest.mark.parametrize("case", [
    ("ample", 64, 4, 2, 64), ("overflow", 64, 4, 2, 5),
    ("top1 overflow", 48, 4, 1, 3), ("wide", 256, 8, 2, 80),
    ("ties", None, 4, 2, 7)], ids=lambda c: c[0])
def test_dispatch_plan_equals_jax(case):
    _, n, e, k, cap = case
    lg = _tied_logits() if n is None else \
        np.random.RandomState(n + cap).randn(n, e).astype("f4") * 2
    jd, jc, ja = (np.asarray(a) for a in
                  jmoe.moe_dispatch(jnp.asarray(lg), k, cap))
    td, tc, ta = (a.numpy() for a in
                  tmoe.moe_dispatch(torch.from_numpy(lg), k, cap))
    assert td.shape == (lg.shape[0], e, cap)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc != 0, jc != 0)
    np.testing.assert_allclose(tc, jc, atol=1e-7, rtol=0)
    assert abs(float(ta) - float(ja)) <= 1e-6
    # no expert buffer holds more than C tokens, no slot holds two, and
    # a token past capacity has no row at all
    assert (td.sum(axis=(0, 2)) <= cap).all()
    assert (td.sum(axis=0) <= 1).all()
    assert (td.sum(axis=(1, 2)) <= k).all()
    if case[0] == "overflow":
        assert (td.sum(axis=(1, 2)) < k).any()


def test_ties_go_to_the_lowest_expert():
    d, _, _ = tmoe.moe_dispatch(torch.from_numpy(_tied_logits()), 2, 24)
    first = d.numpy().sum(axis=2)
    # row 0 ties experts 0, 1, 2, 3: the two rounds take 0 then 1
    np.testing.assert_array_equal(first[0], [1, 1, 0, 0])
    # row 1 ties 1 and 3: 1 then 3
    np.testing.assert_array_equal(first[1], [0, 1, 0, 1])


def _layers(k=2, cf=1.25):
    pj.seed(4)
    jm = jmoe.MoELayer(16, 32, 4, k=k, capacity_factor=cf)
    tm = tmoe.MoELayer(16, 32, 4, k=k, capacity_factor=cf)
    state = {n: v.numpy() for n, v in jm.state_dict().items()}
    assert list(tm.state_dict()) == list(state)
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


@pytest.mark.parametrize("k,cf", [(1, 8.0), (2, 1.25), (2, 0.5)])
def test_layer_output_and_every_gradient_equal_jax(k, cf):
    jm, tm = _layers(k, cf)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 16).astype("f4")
    cot = rng.randn(2, 12, 16).astype("f4")
    jx = JTensor(jnp.asarray(x), stop_gradient=False)
    jy, jaux = jm(jx)
    (jy * JTensor(jnp.asarray(cot))).sum().__add__(jaux * 10.0).backward()
    tx = pt.to_tensor(x, stop_gradient=False)
    ty, taux = tm(tx)
    (ty * pt.to_tensor(cot)).sum().__add__(taux * 10.0).backward()
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), atol=1e-5)
    assert abs(float(taux) - float(jaux.numpy())) <= 1e-6
    grads = {"x": (tx.grad.numpy(), jx.grad.numpy())}
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        grads[n] = (p.grad.numpy(), jp[n].grad.numpy())
    assert set(grads) == {"x", "gate.weight", "w1", "b1", "w2", "b2"}
    for n, (got, want) in grads.items():
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=lim, rtol=0, err_msg=n)


def _pair(**over):
    cfg = dict(MOE_GPT, **over)
    pj.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu", seed=1)
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm.train()


@pytest.mark.parametrize("head", ["dense", "fused"])
@pytest.mark.parametrize("kind", ["tensor", "torch"])
def test_gpt_loss_holds_the_aux_once_and_every_gradient(kind, head):
    jm, tm = _pair(fused_head_loss=head == "fused")
    ji = JTensor(jnp.asarray(IDS))
    jlogits = jm(ji)
    jaux = float(jlogits._moe_aux_loss.numpy())
    jl = jgpt.gpt_pretrain_loss(jlogits, ji)
    jl.backward()
    ids = pt.to_tensor(IDS) if kind == "tensor" else \
        torch.from_numpy(IDS).long()
    logits = tm(ids)
    assert isinstance(logits, pt.Tensor if kind == "tensor"
                      else torch.Tensor)
    raw = logits._data if kind == "tensor" else logits
    assert isinstance(raw, tgpt.FusedHeadLogits) == (head == "fused")
    aux = float(raw._moe_aux_loss)
    assert aux > 0 and aux == pytest.approx(jaux, abs=1e-6)
    loss = tgpt.gpt_pretrain_loss(logits, ids)
    assert float(loss) == pytest.approx(float(jl.numpy()), rel=1e-5)
    # the aux is in the loss once: the cross entropy alone is loss - aux
    ce = tgpt.gpt_pretrain_loss(raw.dense() if head == "fused"
                                else raw.detach(), torch.from_numpy(IDS))
    assert float(loss) == pytest.approx(float(ce) + aux, rel=1e-6)
    (loss._data if kind == "tensor" else loss).backward()
    jp = dict(jm.named_parameters())
    names = [n for n, _ in tm.named_parameters()]
    assert "gpt.blocks.0.mlp.w1" in names and \
        "gpt.blocks.1.mlp.gate.weight" in names
    for n, p in tm.named_parameters():
        want = jp[n].grad.numpy()
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=lim, rtol=0,
                                   err_msg=n)


def test_state_dict_keys_shapes_and_strict_load():
    jm, tm = _pair()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd)
    for n, v in jsd.items():
        assert tuple(tsd[n].shape) == tuple(v.shape), n
    assert tuple(tsd["gpt.blocks.0.mlp.b1"].shape) == (4, 1, 128)
    state = {k: v.numpy() for k, v in jsd.items()}
    for k, v in state.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        tgpt.load_jax_state(tm, {k: v for k, v in state.items()
                                 if not k.endswith("mlp.w2")})
    with pytest.raises(KeyError, match="unexpected"):
        tgpt.load_jax_state(tm, dict(state, **{"gpt.blocks.0.mlp.w3":
                                               state["gpt.blocks.0.mlp.w2"]}))


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_adamw_trainstep_trajectory_matches_jax(recompute):
    jm, tm = _pair(use_recompute=recompute)
    jstep = JTrainStep(jm, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, pt.optimizer.AdamW(
        1e-3, parameters=tm.parameters()))
    ids = torch.from_numpy(IDS).long()
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(3)]
    tl = [float(tstep(ids, ids)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_recompute_equals_the_plain_run_and_carries_the_aux():
    """use_recompute checkpoints each block with its (x, aux) outputs:
    the loss, the aux and every gradient equal the plain run's."""
    out = []
    for recompute in (False, True):
        _, tm = _pair(use_recompute=recompute)
        logits = tm(torch.from_numpy(IDS).long())
        loss = tgpt.gpt_pretrain_loss(logits, torch.from_numpy(IDS))
        loss.backward()
        out.append((float(loss), float(logits._moe_aux_loss),
                    {n: p.grad.numpy() for n, p in tm.named_parameters()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-6)
    for n, g in out[0][2].items():
        np.testing.assert_allclose(out[1][2][n], g, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("bucket,max_seq_len,route", [
    (12, 16, "dense"),          # 128 > max_seq_len: both dense
    (24, 128, "k1"),            # the port pads 24 -> 128; the MoE routes 24
])
def test_prefill_matches_jax_and_drops_the_aux(bucket, max_seq_len, route):
    jm, tm = _pair(max_seq_len=max_seq_len)
    assert tm.prefill_route(bucket) == route
    ids = np.random.default_rng(bucket).integers(
        0, 64, (2, bucket)).astype(np.int32)
    jl, jc = jm.prefill(JTensor(jnp.asarray(ids)), max_seq_len,
                        dtype=jnp.float32)
    tl, tc = tm.prefill(torch.from_numpy(ids).long(), max_seq_len)
    assert isinstance(tl, torch.Tensor) and tl.shape == (2, bucket, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               atol=1e-4)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[:, :, :bucket],
                                   np.asarray(jk)[:, :, :bucket], atol=1e-5)
        np.testing.assert_allclose(tv.numpy()[:, :, :bucket],
                                   np.asarray(jv)[:, :, :bucket], atol=1e-5)


def test_decode_step_raises_as_the_jax_one_fails():
    """The JAX GPTBlock.decode adds the MoE (out, aux) tuple to x and
    fails (ROADMAP Queue 3's reference caveat); the port raises a clear
    NotImplementedError instead."""
    jm, tm = _pair()
    jm.eval()
    ids = IDS[:, :4]
    _, jc = jm.prefill(JTensor(jnp.asarray(ids)), 16, dtype=jnp.float32)
    with pytest.raises(Exception):
        jm.decode_step(JTensor(jnp.asarray(ids[:, :1])), jc, 4)
    _, tc = tm.prefill(torch.from_numpy(ids).long(), 16)
    with pytest.raises(NotImplementedError, match="MoE"):
        tm.decode_step(torch.from_numpy(ids[:, :1]).long(), tc, 4)


def test_generate_without_cache_runs_and_with_cache_raises():
    _, tm = _pair()
    out = tgpt.generate(tm, IDS[:, :4], max_new_tokens=3)
    assert out.shape == (2, 7)
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt.generate(tm, IDS[:, :4], max_new_tokens=3, use_cache=True)
