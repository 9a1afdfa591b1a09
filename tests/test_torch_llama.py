"""The port's LLaMA (paddle_tpu_torch.nlp.llama) against the JAX
package's (paddle_tpu.nlp.llama): RMSNorm, the rope tables and every
rope variant, forward logits, loss and every gradient at GQA rep 1, 2, 3
and 4, both attention layouts, a sliding window, recompute, the fused
head, untied embeddings, SGD and AdamW `TrainStep` trajectories, and the
state-dict carry-over.

Model: vocab 256, hidden 64, 2 layers, 4 heads (head_dim 16), seq 128
(so both packages take flash attention's kernel route: JAX's Pallas
kernels in interpret mode, the port's plain loops), initializer_range
0.2 so the logits are O(1..10). Both packages hold the same numpy
weights through `load_jax_state`; the ids are seeded numpy.

Tolerances (f32; the two sum in different orders): RMSNorm and rope
within 1e-6 (bf16: one bf16 ulp, 1e-2 relative); the rope tables bit
for bit; logits atol 1e-4; loss rtol 1e-5; gradients within
1e-4 * max(1, max|g|); SGD losses rtol 1e-5, AdamW's rtol 1e-3 (a
gradient near 0 whose sign differs between summation orders moves one
weight by 2 lr).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp import llama as jllama
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.state import host_init_ctx
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.nlp import llama as tllama
from paddle_tpu_torch.nlp import load_jax_optimizer_state, load_jax_state

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=128, initializer_range=0.2)
IDS = np.random.RandomState(0).randint(0, 256, (2, 128)).astype("int32")


def _pair(**over):
    cfg = dict(SMALL, **over)
    pt.seed(3)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**cfg))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**cfg), device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.train()


def _ids():
    return torch.tensor(IDS, dtype=torch.long)


def _grads_close(jm, tm, tag=""):
    tg = {n: p.grad for n, p in tm.named_parameters()}
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for n, want in jg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tg[n].numpy(), want, atol=lim, rtol=0,
                                   err_msg=f"{tag} {n}")


def _forward_backward(jm, tm):
    """Logits and loss of both packages, then every gradient."""
    ids = Tensor(jnp.asarray(IDS))
    jl = jm(ids)
    tl = tm(_ids())
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), atol=1e-4)
    assert float(np.abs(jl.numpy()).max()) > 1.0
    jv = jllama.llama_pretrain_loss(jl, ids)
    tv = tllama.llama_pretrain_loss(tl, _ids())
    assert float(tv.detach()) == pytest.approx(float(jv.numpy()), rel=1e-5)
    jv.backward()
    tv.backward()
    _grads_close(jm, tm)


# ---------------------------------------------------------------------------
# RMSNorm and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jllama._rms_norm_raw(jx, jnp.asarray(w), 1e-6)
                      .astype(jnp.float32))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    with host_init_ctx(0):
        got = tllama.RMSNorm(48, 1e-6)
    got.weight.set_value(w)
    out = got(tx)._data
    assert out.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq,hd,theta", [(2048, 64, 10000.0),
                                          (128, 16, 10000.0),
                                          (4096, 128, 500000.0)])
def test_rope_tables_equal_bit_for_bit(seq, hd, theta):
    jc, js = jllama.rope_tables(seq, hd, theta)
    tc, ts = tllama.rope_tables(seq, hd, theta)
    assert tc.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rope_variants_match_jax():
    """apply_rope / apply_rope_bshd at int and tensor offsets (a tensor
    start past the table clamps as JAX's dynamic_slice does),
    apply_rope_positions at [C] and [B, C] positions and apply_rope_at at
    [B] positions, some past the table (their rows clamp to the last)."""
    n, hd = 32, 16
    jc, js = jllama.rope_tables(n, hd)
    tc, ts = tllama.rope_tables(n, hd)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, hd)).astype(np.float32)   # [B,H,S,D]
    xb = np.ascontiguousarray(x.transpose(0, 2, 1, 3))          # [B,S,H,D]

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    for off in (0, 5, 24):
        close(tllama.apply_rope(torch.tensor(x), tc, ts, off),
              jllama.apply_rope(jnp.asarray(x), jc, js, off))
        close(tllama.apply_rope_bshd(torch.tensor(xb), tc, ts, off),
              jllama.apply_rope_bshd(jnp.asarray(xb), jc, js, off))
    for off in (3, 30, 100):               # traced offsets; 30, 100 clamp
        close(tllama.apply_rope(torch.tensor(x), tc, ts, torch.tensor(off)),
              jllama.apply_rope(jnp.asarray(x), jc, js, jnp.int32(off)))
    with pytest.raises(ValueError, match="RoPE"):
        tllama.apply_rope(torch.tensor(x), tc, ts, 25)
    for pos in (np.array([0, 3, 31, 32, 40, 7, 9, 1]),
                np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                          [28, 29, 30, 31, 32, 33, 34, 35]])):
        close(tllama.apply_rope_positions(torch.tensor(x), tc, ts,
                                          torch.tensor(pos)),
              jllama.apply_rope_positions(jnp.asarray(x), jc, js,
                                          jnp.asarray(pos)))
    x1 = x[:, :, :1]
    pos = np.array([5, 40])
    close(tllama.apply_rope_at(torch.tensor(x1), tc, ts, torch.tensor(pos)),
          jllama.apply_rope_at(jnp.asarray(x1), jc, js, jnp.asarray(pos)))


def test_rope_tables_stay_f32_off_the_state_dict():
    """The tables are buffers of the model's one `rope`, a plain torch
    module beside the layers: no state-dict key (load_jax_state would refuse an extra key), shared
    by every layer, and kept f32 in a bf16 model."""
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**SMALL), device="cpu",
                                 dtype=torch.bfloat16)
    assert not any("rope" in k or "cos" in k for k in tm.state_dict())
    rope = tm.model.rope
    assert rope.cos.dtype == torch.float32 and rope.cos.shape == (128, 8)
    assert all(blk.self_attn.rope is rope for blk in tm.model.layers)
    np.testing.assert_array_equal(rope.cos.numpy(),
                                  tllama.rope_tables(128, 16)[0].numpy())
    tm.float()
    assert rope.cos.dtype == torch.float32
    assert tm.parameters()[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,kv_heads,hidden", [(4, 4, 64), (4, 2, 64),
                                                   (4, 1, 64), (6, 2, 96)],
                         ids=["rep1", "rep2", "rep4", "rep3"])
def test_logits_loss_and_every_gradient_match_jax(heads, kv_heads, hidden):
    jm, tm = _pair(num_heads=heads, num_kv_heads=kv_heads,
                   hidden_size=hidden)
    qkv = tm.model.layers[0].self_attn.qkv_proj.weight
    assert tuple(qkv.shape) == (hidden, (heads + 2 * kv_heads) * 16)
    _forward_backward(jm, tm)


@pytest.mark.parametrize("over", [{"attn_layout": "bhsd"},
                                  {"attn_window": 32},
                                  {"use_recompute": True},
                                  {"tie_embeddings": False}],
                         ids=["bhsd", "window", "recompute", "untied"])
def test_variants_match_jax(over):
    jm, tm = _pair(**over)
    if "tie_embeddings" in over:
        assert tuple(tm.lm_head.weight.shape) == (64, 256)
    _forward_backward(jm, tm)


def test_bshd_equals_bhsd():
    """The two layouts run the same arithmetic in another order of
    memory: logits within 1e-5, every gradient within 1e-5 * max(1, g)."""
    grads, logits = [], []
    for layout in ("bshd", "bhsd"):
        m = tllama.LlamaForCausalLM(tllama.LlamaConfig(
            **dict(SMALL, attn_layout=layout)), device="cpu", seed=4)
        lo = m.train()(_ids())
        tllama.llama_pretrain_loss(lo, _ids()).backward()
        logits.append(lo.detach())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(),
                               atol=1e-5)
    for n, g in grads[0].items():
        lim = 1e-5 * max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(), atol=lim,
                                   err_msg=n)


def test_fused_head_equals_dense_head():
    """fused_head_loss=True: forward returns FusedHeadLogits over the
    tied weight, the vocab-chunked loss equals the dense head's (rtol
    1e-5) and so do the gradients, the tied embedding's included."""
    out = {}
    for fused in (False, True):
        m = tllama.LlamaForCausalLM(tllama.LlamaConfig(
            **dict(SMALL, fused_head_loss=fused)), device="cpu", seed=5)
        lo = m.train()(_ids())
        assert isinstance(lo, tgpt.FusedHeadLogits) == fused
        loss = tllama.llama_pretrain_loss(lo, _ids())
        loss.backward()
        out[fused] = (float(loss.detach()),
                      {n: p.grad for n, p in m.named_parameters()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-5)
    for n, g in out[False][1].items():
        lim = 1e-4 * max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(out[True][1][n].numpy(), g.numpy(),
                                   atol=lim, err_msg=n)
    # an untied head is never fused
    m = tllama.LlamaForCausalLM(tllama.LlamaConfig(
        **dict(SMALL, fused_head_loss=True, tie_embeddings=False)),
        device="cpu")
    assert not isinstance(m(_ids()), tgpt.FusedHeadLogits)


# ---------------------------------------------------------------------------
# TrainStep trajectories and the carry-over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,rtol", [("SGD", 1e-5), ("AdamW", 1e-3)])
def test_train_step_trajectory_matches_jax(opt, rtol):
    jm, tm = _pair(num_heads=6, num_kv_heads=2, hidden_size=96)
    lr = 0.05 if opt == "SGD" else 1e-3
    jstep = JTrainStep(jm, jllama.llama_pretrain_loss, getattr(
        pt.optimizer, opt)(learning_rate=lr, parameters=jm.parameters()))
    tstep = TrainStep(tm, tllama.llama_pretrain_loss,
                      getattr(topt, opt)(lr, parameters=tm.parameters()))
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(4)]
    tl = [float(tstep(_ids(), _ids())) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]
    if opt == "SGD":
        assert tstep.last_grad_norm() == pytest.approx(
            jstep.last_grad_norm(), rel=1e-4)
        return
    # carry the trained weights and the moments across: two more steps
    # on each side give the same losses
    jstep.sync()
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    adam = topt.AdamW(lr, parameters=tm.parameters())
    load_jax_optimizer_state(adam, {n: {k: np.asarray(v)
                                        for k, v in st.items()}
                                    for n, st in jstep.opt_state.items()},
                             tm, jstep._step_i)
    assert adam._global_step == 4
    tstep = TrainStep(tm, tllama.llama_pretrain_loss, adam)
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(2)]
    tl = [float(tstep(_ids(), _ids())) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)


def test_load_jax_state_refuses_missing_and_extra_keys():
    pt.seed(3)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**SMALL))
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**SMALL), device="cpu")
    missing = dict(state)
    del missing["model.norm.weight"]
    with pytest.raises(KeyError, match="model.norm.weight"):
        load_jax_state(tm, missing)
    with pytest.raises(KeyError, match="lm_head"):
        load_jax_state(tm, dict(state, **{"lm_head.weight": np.zeros(
            (64, 256), np.float32)}))
    untied = tllama.LlamaForCausalLM(tllama.LlamaConfig(
        **dict(SMALL, tie_embeddings=False)), device="cpu")
    with pytest.raises(KeyError, match="lm_head"):
        load_jax_state(untied, state)
    assert not any("bias" in k for k in tm.state_dict())


def test_config_checks():
    cfg = tllama.LlamaConfig()
    assert (cfg.intermediate_size, cfg.num_kv_heads, cfg.max_seq_len,
            cfg.rms_eps, cfg.tie_embeddings) == (2048, 12, 2048, 1e-6, True)
    with pytest.raises(ValueError, match="divisible"):
        tllama.LlamaConfig(num_heads=12, num_kv_heads=5)
    with pytest.raises(ValueError, match="attn_layout"):
        tllama.LlamaConfig(attn_layout="sbhd")
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="RoPE"):
        tm(torch.zeros((1, 129), dtype=torch.long))
