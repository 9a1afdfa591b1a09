"""The vocab-chunked fused LM head + loss of the port
(paddle_tpu_torch.ops.chunked_ce and the fused path of nlp/gpt.py)
against the JAX package's (paddle_tpu.ops.chunked_ce, nlp/gpt.py).

Inputs are seeded numpy arrays handed to both packages, on the CPU, in
f32. Tolerances are the JAX package's own for this op
(tests/test_chunked_ce.py): the loss within rtol 1e-5, dh and dw within
rtol 1e-4 and atol 1e-6 (the two sum the chunks' exponentials and
products in different orders). The GPT trajectories use
tests/test_torch_train.py's: SGD losses within rtol 1e-5, AdamW's within
rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.ops.chunked_ce import chunked_lm_loss as jchunked
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.ops.chunked_ce import chunked_lm_loss

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

# vocab 4500 > the 4096 chunk: two chunks, the second ragged (404 rows)
CFG = dict(vocab_size=4500, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, attn_dropout=0.0,
           initializer_range=0.2)
IDS = np.random.RandomState(0).randint(0, 4500, (2, 64)).astype("int32")


def _inputs(n, h, v, seed=0, ignore_every=7):
    rs = np.random.RandomState(seed)
    hid = (rs.randn(n, h) * 0.5).astype("f4")
    w = (rs.randn(v, h) * 0.3).astype("f4")
    lab = rs.randint(0, v, n).astype("int64")
    if ignore_every:
        lab[::ignore_every] = -1
    return hid, w, lab


def _both(hid, w, lab, chunk):
    """(loss, dh, dw) of the port's op and of the JAX op."""
    th = torch.tensor(hid, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = chunked_lm_loss(th, tw, torch.tensor(lab), -1, chunk)
    loss.backward()
    jl, (jdh, jdw) = jax.value_and_grad(
        lambda a, b: jchunked(a, b, jnp.asarray(lab, jnp.int32), -1, chunk),
        argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(w))
    return ((float(loss.detach()), th.grad.numpy(), tw.grad.numpy()),
            (float(jl), np.asarray(jdh), np.asarray(jdw)))


# V a multiple of the chunk, V ragged, V below the chunk
@pytest.mark.parametrize("chunk,v", [(128, 512), (256, 1000), (4096, 512),
                                     (128, 300)])
def test_chunked_loss_and_grads_match_jax(chunk, v):
    hid, w, lab = _inputs(48, 32, v)
    (tl, tdh, tdw), (jl, jdh, jdw) = _both(hid, w, lab, chunk)
    assert tl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(tdh, jdh, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tdw, jdw, rtol=1e-4, atol=1e-6)
    # and the dense chain: the ragged slice is the padded -inf columns
    dense = torch.nn.functional.cross_entropy(
        torch.tensor(hid) @ torch.tensor(w).T, torch.tensor(lab),
        ignore_index=-1)
    assert tl == pytest.approx(float(dense), rel=1e-5)


def test_all_rows_ignored_gives_zero_loss_and_grads():
    hid, w, lab = _inputs(16, 32, 300, ignore_every=0)
    lab[:] = -1
    (tl, tdh, tdw), (jl, jdh, jdw) = _both(hid, w, lab, 128)
    assert tl == jl == 0.0
    assert not tdh.any() and not tdw.any()
    assert not jdh.any() and not jdw.any()


def test_labels_get_no_gradient_and_shapes_are_checked():
    hid, w, lab = _inputs(8, 16, 100)
    th = torch.tensor(hid, requires_grad=True)
    tl = torch.tensor(lab)
    loss = chunked_lm_loss(th, torch.tensor(w), tl, -1, 64)
    (g,) = torch.autograd.grad(loss, [th])
    assert g.shape == th.shape and tl.grad is None
    with pytest.raises(ValueError, match=r"\[N, H\] and \[V, H\]"):
        chunked_lm_loss(th, torch.tensor(w[:, :8]), tl)
    with pytest.raises(ValueError, match="labels"):
        chunked_lm_loss(th, torch.tensor(w), tl[:4])


def _pair(**over):
    cfg = dict(CFG, **over)
    pt.seed(3)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm.train()


@pytest.mark.parametrize("opt,rtol", [("SGD", 1e-5), ("AdamW", 1e-3)])
def test_fused_gpt_trajectory_matches_jax(opt, rtol):
    """Five TrainStep steps with the fused head on, in both packages:
    the losses agree, so the head's gradient reached the hidden states
    and the tied embedding in both."""
    jm, tm = _pair(fused_head_loss=True)
    lr = 0.1 if opt == "SGD" else 1e-3
    jstep = JTrainStep(jm, jgpt.gpt_pretrain_loss, getattr(
        pt.optimizer, opt)(learning_rate=lr, parameters=jm.parameters()))
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, getattr(topt, opt)(
        lr, parameters=tm.parameters()))
    ids = torch.tensor(IDS, dtype=torch.long)
    jl = [float(jstep(IDS, IDS).numpy()) for _ in range(5)]
    tl = [float(tstep(ids, ids)) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[4] < tl[0]


def test_dense_head_is_not_computed_on_the_loss_path(monkeypatch):
    """Forward, loss and backward, eagerly and through the CPU
    TrainStep, call the dense head 0 times; reading the logits computes
    it once and gives the true dense values."""
    calls = []
    dense = tgpt.FusedHeadLogits.dense

    def counted(self):
        if self._dense is None:
            calls.append(tuple(self.hidden.shape))
        return dense(self)
    monkeypatch.setattr(tgpt.FusedHeadLogits, "dense", counted)
    _, tm = _pair(fused_head_loss=True)
    ids = torch.tensor(IDS, dtype=torch.long)
    logits = tm(ids)
    assert isinstance(logits, tgpt.FusedHeadLogits)
    assert logits.shape == (2, 64, 4500) and logits.dtype == torch.float32
    assert logits.size(-1) == 4500 and logits.dim() == 3
    tgpt.gpt_pretrain_loss(logits, ids).backward()
    step = TrainStep(tm, tgpt.gpt_pretrain_loss,
                     topt.SGD(0.1, parameters=tm.parameters()))
    for _ in range(2):
        step(ids, ids)
    assert calls == []
    with torch.no_grad():
        logits = tm(ids)
        h = tm.gpt(ids)
        want = h @ tm.gpt.embeddings.word_embeddings.weight._data.T
        got = logits[:, 5]
    assert calls == [(2, 64, 64)]
    torch.testing.assert_close(got, want[:, 5], rtol=0, atol=0)
    torch.testing.assert_close(logits.float().sum(), want.sum())
    assert calls == [(2, 64, 64)]          # computed once


def test_fused_tied_embedding_gradient_matches_jax_and_dense():
    jm, tm = _pair(fused_head_loss=True)
    ids = torch.tensor(IDS, dtype=torch.long)
    tgpt.gpt_pretrain_loss(tm(ids), ids).backward()
    tw = tm.gpt.embeddings.word_embeddings.weight
    got = tw.grad.numpy().copy()
    jloss = jgpt.gpt_pretrain_loss(jm(Tensor(jnp.asarray(IDS))),
                                   Tensor(jnp.asarray(IDS)))
    jloss.backward()
    want = np.asarray(jm.gpt.embeddings.word_embeddings.weight.grad._data)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    assert float(np.abs(got).max()) > 1e-4
    # the dense head's gradient into the same weight
    tw.grad = None
    tgpt.gpt_pretrain_loss(tm(ids).dense(), ids).backward()
    assert float(np.abs(tw.grad.numpy() - got).max()) <= tol


def test_fused_head_auto_threshold(monkeypatch):
    """fused_head_loss=None picks by the f32 logits' size, in both
    packages alike: dense below CHUNKED_CE_AUTO_BYTES, fused above."""
    jm, tm = _pair()
    assert tm.cfg.fused_head_loss is None
    ids = torch.tensor(IDS, dtype=torch.long)
    jids = Tensor(jnp.asarray(IDS))
    for limit, fused in ((1 << 60, False), (1, True)):
        monkeypatch.setattr(jgpt, "CHUNKED_CE_AUTO_BYTES", limit)
        monkeypatch.setattr(tgpt, "CHUNKED_CE_AUTO_BYTES", limit)
        jl = jm(jids)
        tl = tm(ids)
        assert (getattr(jl, "_fused_head", None) is not None) == fused
        assert isinstance(tl, tgpt.FusedHeadLogits) == fused
        assert float(tgpt.gpt_pretrain_loss(tl, ids).detach()) == \
            pytest.approx(float(jgpt.gpt_pretrain_loss(jl, jids).numpy()),
                          rel=1e-5)
    # GPT-2 small's padded vocab at seq 1024 crosses 2 GiB from batch 11
    monkeypatch.undo()
    assert tgpt.CHUNKED_CE_AUTO_BYTES == jgpt.CHUNKED_CE_AUTO_BYTES == 2 << 30
    cfg = tgpt.GPTConfig()
    assert not tgpt._use_fused_head(cfg, (10, 1024, 50304))
    assert tgpt._use_fused_head(cfg, (11, 1024, 50304))
