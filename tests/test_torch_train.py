"""The port's training step against the JAX package: GPT forward, loss,
every gradient and multi-step TrainStep trajectories
(paddle_tpu_torch.nlp.gpt / .optimizer / .jit against paddle_tpu.nlp.gpt
/ .optimizer / .jit), and the optimizers' per-step updates.

Model: bench.py's CPU smoke config (vocab 512, hidden 128, 2 layers, 4
heads, seq 128, dropout 0) with initializer_range 0.2 so the logits are
O(1..10); weights carried across by `load_jax_state`. Batch 2 of seeded
numpy ids, fed to both packages. Tolerances (f32 throughout, both sides
sum in different orders): logits atol 1e-4; loss rtol 1e-5; gradients
within 1e-4 * max(1, max|g|); SGD trajectories rtol 1e-5; AdamW
trajectories rtol 1e-3 — AdamW's first steps move every weight by about
+-lr whatever the gradient's size, so a gradient near 0 whose sign
differs between summation orders moves one weight by 2 lr.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.tensor import Parameter as JParameter
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nlp.gpt import gpt_pretrain_loss as jloss
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)
IDS = np.random.RandomState(0).randint(0, 512, (2, 128)).astype("int32")


def _pair(**over):
    cfg = dict(SMALL, **over)
    pt.seed(3)
    jm = JGPT(JConfig(**cfg))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm.train()


def _ids():
    return torch.tensor(IDS, dtype=torch.long)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_forward_logits_and_loss_match(pair):
    jm, tm = pair
    jl = jm(Tensor(jnp.asarray(IDS)))
    tl = tm(_ids())
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), atol=1e-4)
    assert float(np.abs(jl.numpy()).max()) > 1.0
    jv = float(jloss(jl, Tensor(jnp.asarray(IDS))).numpy())
    tv = float(tgpt.gpt_pretrain_loss(tl, _ids()).detach())
    assert tv == pytest.approx(jv, rel=1e-5)


def test_loss_shifts_labels_and_averages_valid_rows():
    logits = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 7, (2, 5))
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 7), labels[:, 1:].reshape(-1))
    got = tgpt.gpt_pretrain_loss(logits, labels)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _grads_close(jm, tm, tag=""):
    tg = {n: p.grad for n, p in tm.named_parameters()}
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for n, want in jg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tg[n].numpy(), want, atol=lim, rtol=0,
                                   err_msg=f"{tag} {n}")


@pytest.mark.parametrize("over", [{}, {"attn_window": 32},
                                  {"attn_layout": "bhsd"},
                                  {"use_recompute": True}],
                         ids=["causal", "window", "bhsd", "recompute"])
def test_step1_gradients_match_every_parameter(over):
    jm, tm = _pair(**over)
    ids = Tensor(jnp.asarray(IDS))
    jloss(jm(ids), ids).backward()
    tgpt.gpt_pretrain_loss(tm(_ids()), _ids()).backward()
    _grads_close(jm, tm, str(over))


def _trajectories(jopt, topt_fn, steps, **over):
    jm, tm = _pair(**over)
    jstep = JTrainStep(jm, jloss, jopt(jm.parameters()))
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, topt_fn(tm.parameters()))
    ids = _ids()
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(steps)]
    tl = [float(tstep(ids, ids)) for _ in range(steps)]
    return jl, tl, jstep, tstep


@pytest.mark.parametrize("over", [{}, {"attn_window": 32},
                                  {"use_recompute": True}],
                         ids=["causal", "window", "recompute"])
def test_sgd_trajectory_matches_tightly(over):
    jl, tl, jstep, tstep = _trajectories(
        lambda p: pt.optimizer.SGD(learning_rate=0.05, parameters=p),
        lambda p: topt.SGD(0.05, parameters=p), 4, **over)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert tstep.last_grad_norm() == pytest.approx(jstep.last_grad_norm(),
                                                   rel=1e-4)
    assert tstep.last_nonfinite() is False


@pytest.mark.parametrize("over", [{}, {"attn_window": 32}],
                         ids=["causal", "window"])
def test_adamw_trajectory_matches_loosely(over):
    jl, tl, _, _ = _trajectories(
        lambda p: pt.optimizer.AdamW(learning_rate=1e-3, parameters=p),
        lambda p: topt.AdamW(1e-3, parameters=p), 4, **over)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_trained_weights_and_adam_state_carry_across():
    """Train 2 AdamW steps in JAX, carry the weights (`load_jax_state`)
    and the moments (`load_jax_optimizer_state`) into the port: the
    logits agree, and 2 further steps on each side give the same
    losses."""
    jm, tm = _pair()
    jstep = JTrainStep(jm, jloss, pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    for _ in range(2):
        jstep(IDS, IDS)
    jstep.sync()
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    ids = _ids()
    np.testing.assert_allclose(
        tm(ids).detach().numpy(), jm(Tensor(jnp.asarray(IDS))).numpy(),
        atol=1e-4)
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    tgpt.load_jax_optimizer_state(
        opt, {n: {k: np.asarray(v) for k, v in st.items()}
              for n, st in jstep.opt_state.items()}, tm, jstep._step_i)
    assert opt._global_step == 2
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, opt)
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(2)]
    tl = [float(tstep(ids, ids)) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    with pytest.raises(KeyError, match="unknown"):
        tgpt.load_jax_optimizer_state(opt, {"nope": {}}, tm, 0)


def test_fused_head_loss_raises_and_names_the_roadmap():
    """The fused head is ported (tests/test_torch_chunked_ce.py): its
    loss equals the dense head's; what is still unported raises and
    names the ROADMAP."""
    _, tm = _pair(fused_head_loss=True)
    logits = tm(_ids())
    assert isinstance(logits, tgpt.FusedHeadLogits)
    fused = float(tgpt.gpt_pretrain_loss(logits, _ids()).detach())
    dense = float(tgpt.gpt_pretrain_loss(logits.dense(), _ids()).detach())
    assert fused == pytest.approx(dense, rel=1e-5)
    assert not tgpt._use_fused_head(tm.cfg.__class__(**SMALL), (8, 1024,
                                                               32768))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.GPTConfig(**dict(SMALL, sequence_parallel=True))


def test_recompute_replays_the_dropout_masks():
    """With dropout on, use_recompute gives the gradients of the plain
    run: the backward's recompute draws the masks of the forward (both
    runs draw from the framework generator reseeded with one seed)."""
    grads = []
    for recompute in (False, True):
        tpt.seed(5)
        cfg = tgpt.GPTConfig(**dict(SMALL, dropout=0.1, attn_dropout=0.1,
                                    use_recompute=recompute))
        m = tgpt.GPTForPretraining(cfg, device="cpu", seed=5).train()
        tgpt.gpt_pretrain_loss(m(_ids()), _ids()).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=n)


def test_dropout_trains_reproducibly_from_the_seed():
    """The model's `seed` draws the weights and `paddle.seed` the dropout
    masks: the same seeds replay a run, another seed changes it."""
    def run(seed):
        tpt.seed(seed)
        cfg = tgpt.GPTConfig(**dict(SMALL, dropout=0.1, attn_dropout=0.1))
        m = tgpt.GPTForPretraining(cfg, device="cpu", seed=seed)
        step = TrainStep(m, tgpt.gpt_pretrain_loss,
                         topt.SGD(0.05, parameters=m.parameters()))
        return [float(step(_ids(), _ids())) for _ in range(2)]
    assert run(1) == run(1)
    assert run(1) != run(2)


# ---------------------------------------------------------------------------
# optimizers: per-step updates against the JAX package's rules
# ---------------------------------------------------------------------------

SHAPES = [(6, 5), (7,), (3, 4, 2)]


def _opt_pair(name, dtype, multi_precision, clip):
    rng = np.random.RandomState(11)
    arrs = [rng.randn(*s).astype("f4") for s in SHAPES]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jps = [JParameter(jnp.asarray(a, jdt)) for a in arrs]
    tps = [torch.nn.Parameter(torch.tensor(a).to(getattr(torch, dtype)))
           for a in arrs]
    jclip = JClip(0.5) if clip else None
    tclip = tnn.ClipGradByGlobalNorm(0.5) if clip else None
    kw = {} if name == "SGD" else {"beta1": 0.8, "beta2": 0.95}
    if name == "Adam":
        kw["weight_decay"] = 0.01
    if name == "AdamW":
        kw["weight_decay"] = 0.1
    if name != "SGD":       # the JAX package's SGD has no master copy
        kw["multi_precision"] = multi_precision
    jo = getattr(pt.optimizer, name)(
        learning_rate=0.01, parameters=jps, grad_clip=jclip, **kw)
    to = getattr(topt, name)(0.01, parameters=tps, grad_clip=tclip, **kw)
    return jo, to, jps, tps


OPT_CASES = [(n, dt, mp) for n in ("SGD", "Adam", "AdamW")
             for dt, mp in (("float32", False), ("bfloat16", False),
                            ("bfloat16", True)) if not (n == "SGD" and mp)]


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("name,dtype,mp", OPT_CASES,
                         ids=[f"{n}-{d}{'-mp' if m else ''}"
                              for n, d, m in OPT_CASES])
def test_optimizer_updates_match_jax(name, dtype, mp, clip):
    jo, to, jps, tps = _opt_pair(name, dtype, mp, clip)
    rng = np.random.RandomState(12)
    # f32: the rules' roundings agree to a few ulps; bf16: one bf16 ulp
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-2, rtol=1e-2)
    for _ in range(3):
        grads = [rng.randn(*s).astype("f4") for s in SHAPES]
        for jp, tp, g in zip(jps, tps, grads):
            jp.grad = Tensor(jnp.asarray(g, jp._data.dtype))
            tp.grad = torch.tensor(g).to(tp.dtype)
        jo.step()
        to.step()
        for jp, tp in zip(jps, tps):
            assert tp.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(
                tp.detach().float().numpy(),
                np.asarray(jp._data, np.float32), **tol)
    for i, jp in enumerate(jps):
        jst = jo._accumulators.get(id(jp), {})
        tst = to._state.get(i, {})
        assert sorted(jst) == sorted(tst)
        for slot, arr in jst.items():
            assert tst[slot].dtype == getattr(torch, str(arr.dtype))
            np.testing.assert_allclose(
                tst[slot].float().numpy(), np.asarray(arr, np.float32),
                atol=1e-6, rtol=1e-5 if dtype == "float32" else 1e-2)


def test_optimizer_state_dict_round_trip_and_lr():
    _, to, _, tps = _opt_pair("AdamW", "bfloat16", True, False)
    for p in tps:
        p.grad = torch.ones_like(p)
    to.step()
    sd = to.state_dict()
    assert sd["global_step"] == 1
    assert {"param_0.moment1", "param_0.moment2", "param_0.master"} <= set(sd)
    _, fresh, _, fps = _opt_pair("AdamW", "bfloat16", True, False)
    fresh.set_state_dict(sd)
    for k, v in sd.items():
        if k != "global_step":
            i, slot = k.split(".")
            assert torch.equal(fresh._state[int(i[6:])][slot], v)
    fresh.set_lr(0.5)
    assert fresh.get_lr() == 0.5
    fresh.clear_grad()
    assert all(p.grad is None for p in fps)
    with pytest.raises(TypeError, match="LRScheduler"):
        topt.SGD(learning_rate=object(), parameters=fps)


@pytest.mark.parametrize("clip_name", ["ClipGradByValue", "ClipGradByNorm",
                                       "ClipGradByGlobalNorm"])
def test_grad_clips_match_jax(clip_name):
    from paddle_tpu.nn import clip as jclip
    rng = np.random.RandomState(13)
    grads = [rng.randn(*s).astype("f4") * 3 for s in SHAPES]
    arg = 0.7
    jc = getattr(jclip, clip_name)(arg)
    tc = getattr(tnn, clip_name)(arg)
    want = jc.apply_arrays([jnp.asarray(g) for g in grads])
    got = tc([(None, torch.tensor(g)) for g in grads] + [(None, None)])
    assert got[-1] == (None, None)
    for (_, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_clip_keeps_group_name_and_fluid_aliases():
    """ClipGradByGlobalNorm takes and keeps `group_name` (default
    "default_group"), as the JAX clip does, and the three fluid aliases
    name the same classes and clip alike."""
    from paddle_tpu.nn import clip as jclip
    for mod in (jclip, tnn.clip):
        assert mod.ClipGradByGlobalNorm(1.0).group_name == "default_group"
        assert mod.ClipGradByGlobalNorm(
            1.0, group_name="moe").group_name == "moe"
        assert mod.GradientClipByValue is mod.ClipGradByValue
        assert mod.GradientClipByNorm is mod.ClipGradByNorm
        assert mod.GradientClipByGlobalNorm is mod.ClipGradByGlobalNorm
    assert tnn.GradientClipByGlobalNorm is tnn.ClipGradByGlobalNorm
    rng = np.random.RandomState(14)
    grads = [rng.randn(*s).astype("f4") * 3 for s in SHAPES]
    want = jclip.GradientClipByGlobalNorm(
        0.5, group_name="g").apply_arrays([jnp.asarray(g) for g in grads])
    got = tnn.GradientClipByGlobalNorm(0.5, group_name="g")(
        [(None, torch.tensor(g)) for g in grads])
    for (_, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
