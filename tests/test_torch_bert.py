"""The port's BERT pretraining model (paddle_tpu_torch.nlp.bert) against
the JAX package's (paddle_tpu.nlp.bert), from the same weights: the
state-dict keys (the tied MLM decoder weight listed once), the MLM and
NSP logits and `bert_pretrain_loss` with no attention mask (the flash
kernels' route: JAX's Pallas K1-K3 in interpret mode, the port's plain
blocks, non-causal) and with a padding mask (the dense route), every
gradient, and 3 AdamW steps in `jit.TrainStep` against the JAX
`TrainStep`.

Model: 2 layers, 128 wide, 2 heads of 64, FFN 256, vocab 1000, seq 128,
dropout 0, initializer_range 0.2. The ids, token types, 15% MLM labels
(-100 elsewhere) and NSP labels are seeded numpy draws.

Tolerances (f32, the two sum in different orders): logits atol 1e-4;
the loss within 1e-5 relative; every gradient within
1e-4 x max(1, max|ref|); the TrainStep losses rtol 1e-3 (AdamW: a
gradient near 0 whose sign differs between summation orders moves one
weight by 2 lr).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp import bert as jbert
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import bert as tbert

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

CFG = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
           intermediate_size=256, max_seq_len=128, dropout=0.0,
           attn_dropout=0.0, initializer_range=0.2)
B, S = 2, 128
RNG = np.random.RandomState(0)
IDS = RNG.randint(0, 1000, (B, S)).astype("int32")
TYPES = (np.arange(S)[None] >= RNG.randint(20, 100, (B, 1))).astype("int32")
PICK = RNG.rand(B, S) < 0.15
MLM = np.where(PICK, RNG.randint(0, 1000, (B, S)), -100).astype("int32")
NSP = RNG.randint(0, 2, (B,)).astype("int32")
MASK = (np.arange(S)[None] < np.array([[S], [90]])).astype("int32")


@pytest.fixture(scope="module")
def pair():
    pj.seed(3)
    jm = jbert.BertForPretraining(jbert.BertConfig(**CFG))
    tm = tbert.BertForPretraining(tbert.BertConfig(**CFG), device="cpu",
                                  seed=1)
    assert tm.set_state_dict({k: v.numpy() for k, v in
                              jm.state_dict().items()}) == ([], [])
    return jm, tm


def _j(a):
    return JTensor(jnp.asarray(a))


def _t(a):
    return pt.to_tensor(a, place="cpu")


def test_state_dict_keys_equal_jax_with_the_tied_weight_once(pair):
    jm, tm = pair
    assert list(tm.state_dict()) == list(jm.state_dict())
    tied = "bert.embeddings.word_embeddings.weight"
    assert tied in tm.state_dict()
    assert not any("decoder_weight" in k for k in tm.state_dict())
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    assert len(tm.parameters()) == len(jm.parameters())
    assert sum(p is tm.cls.decoder_weight for p in tm.parameters()) == 1


@pytest.mark.parametrize("masked", [False, True], ids=["kernels", "padded"])
def test_logits_loss_and_gradients_match_jax(pair, masked):
    jm, tm = pair
    jm.clear_gradients()
    tm.clear_gradients()
    tm.train()
    jmask = _j(MASK) if masked else None
    tmask = _t(MASK) if masked else None
    jmlm, jnsp = jm(_j(IDS), _j(TYPES), jmask)
    tmlm, tnsp = tm(_t(IDS), _t(TYPES), tmask)
    np.testing.assert_allclose(tmlm.numpy(), jmlm.numpy(), atol=1e-4)
    np.testing.assert_allclose(tnsp.numpy(), jnsp.numpy(), atol=1e-4)
    assert float(np.abs(jmlm.numpy()).max()) > 1.0
    jl = jbert.bert_pretrain_loss(jmlm, jnsp, _j(MLM), _j(NSP))
    tl = tbert.bert_pretrain_loss(tmlm, tnsp, _t(MLM), _t(NSP))
    assert float(tl) == pytest.approx(float(jl.numpy()), rel=1e-5)
    jl.backward()
    tl.backward()
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert list(tg) == list(jg)
    for n, want in jg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tg[n], want, atol=lim, rtol=0,
                                   err_msg=n)
    if masked:      # the padded keys change the unpadded row's outputs
        plain, _ = tm(_t(IDS), _t(TYPES))
        assert float(np.abs(plain.numpy()[1] - tmlm.numpy()[1]).max()) > 1e-3


def test_torch_inputs_give_torch_outputs(pair):
    _, tm = pair
    mlm, nsp = tm(torch.tensor(IDS))
    assert isinstance(mlm, torch.Tensor) and mlm.shape == (B, S, 1000)
    loss = tbert.bert_pretrain_loss(mlm, nsp, torch.tensor(MLM),
                                    torch.tensor(NSP))
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0


def test_three_adamw_steps_in_train_step_match_jax():
    pj.seed(4)
    jm = jbert.BertForPretraining(jbert.BertConfig(**CFG))
    tm = tbert.BertForPretraining(tbert.BertConfig(**CFG), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    jstep = JTrainStep(jm, jbert.bert_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, tbert.bert_pretrain_loss,
                      topt.AdamW(1e-3, parameters=tm.parameters()))
    jl = [float(jstep((IDS, TYPES), (MLM, NSP)).numpy()) for _ in range(3)]
    tl = [float(tstep((torch.tensor(IDS), torch.tensor(TYPES)),
                      (torch.tensor(MLM), torch.tensor(NSP))))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
