"""paddle_tpu_torch.amp against paddle_tpu.amp: `auto_cast` on the GPT
Layer (white-list ops in bf16, attention through the flash op in bf16,
the loss in f32, the gradients on the f32 leaves; the custom lists
restored on exit), eagerly and in `jit.TrainStep`, `decorate` at O2,
and the `GradScaler` state machine (an injected inf skips the step and
halves the scale after `decr_every_n_nan_or_inf` bad steps, growth after
`incr_every_n_steps` good ones, `state_dict` round trip, a row-sparse
SelectedRows gradient unscaled).

The GPT: 2 layers, 64 wide, 4 heads, vocab 256, seq 128 (JAX's Pallas
K1-K3 in interpret mode, the port's plain blocks), from the same numpy
weights. Tolerances: under bf16, 2e-2 x max(1, |ref|) on the logits,
the loss and the TrainStep's losses and gradient norms (5e-2 for O2's
all-bf16 forward); the GradScaler's weights within 1e-6 of the JAX
ones, its scale and counters equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import amp as jamp
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.ops import dispatch
from paddle_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

GPT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0, attn_dropout=0.0,
           initializer_range=0.2)
IDS = np.random.RandomState(0).randint(0, 256, (2, 128)).astype("int32")
BF16 = 2e-2


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _pair():
    pj.seed(3)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**GPT), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm.train()


def _bf16_close(got, want, what, rel=BF16):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    lim = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim, what


def test_auto_cast_gpt_matches_jax_and_restores_the_lists(monkeypatch):
    jm, tm = _pair()
    seen = []
    core = tfa._FlashCore.apply

    def spy(q, *args):
        seen.append(q.dtype)
        return core(q, *args)
    monkeypatch.setattr(tfa._FlashCore, "apply", spy)
    white, black = set(dispatch.AMP_WHITE_LIST), set(dispatch.AMP_BLACK_LIST)
    ji, ti = JTensor(jnp.asarray(IDS)), pt.to_tensor(IDS)
    with jamp.auto_cast(custom_white_list={"gelu"}):
        jlo = jm(ji)
        jl = jgpt.gpt_pretrain_loss(jlo, ji)
    with tamp.auto_cast(custom_white_list={"gelu"},
                        custom_black_list={"tanh"}):
        assert "gelu" in dispatch.AMP_WHITE_LIST
        tlo = tm(ti)
        tl = tgpt.gpt_pretrain_loss(tlo, ti)
    assert dispatch.AMP_WHITE_LIST == white
    assert dispatch.AMP_BLACK_LIST == black
    assert seen == [torch.bfloat16] * GPT["num_layers"]
    assert tlo.dtype == torch.bfloat16 and tl.dtype == torch.float32
    _bf16_close(tlo.numpy(), jlo.astype("float32").numpy(), "logits")
    _bf16_close(float(tl), float(jl.numpy()), "loss")
    # the gradients reach the f32 leaves in f32
    tl.backward()
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    # outside the block the model runs in f32 again
    assert tm(ti).dtype == torch.float32


def test_auto_cast_train_step_matches_jax():
    """Three SGD steps of each package's TrainStep under auto_cast (the
    JAX package's eager backward raises under auto_cast, its TrainStep
    does not): the losses and the global gradient norms within bf16
    tolerance."""
    jm, tm = _pair()
    jstep = JTrainStep(jm, jgpt.gpt_pretrain_loss, pj.optimizer.SGD(
        learning_rate=0.05, parameters=jm.parameters()))
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss,
                      topt.SGD(0.05, parameters=tm.parameters()))
    for _ in range(3):
        with jamp.auto_cast():
            jl = float(jstep(IDS, IDS).numpy())
        with tamp.auto_cast():
            tl = float(tstep(torch.tensor(IDS), torch.tensor(IDS)))
        _bf16_close(tl, jl, "loss")
        _bf16_close(tstep.last_grad_norm(), jstep.last_grad_norm(),
                    "grad norm")


def test_auto_cast_float16_casts_to_float16_and_disable_is_a_no_op():
    x = pt.to_tensor(np.ones((2, 3), "f4"))
    w = pt.to_tensor(np.ones((3, 4), "f4"))
    with tamp.auto_cast(dtype="float16"):
        assert pt.matmul(x, w).dtype == torch.float16
    with tamp.auto_cast(enable=False):
        assert pt.matmul(x, w).dtype == torch.float32
    with tamp.amp_guard():
        assert pt.matmul(x, w).dtype == torch.bfloat16


def test_decorate_o2_matches_jax():
    """O2: every weight and activation in bf16 on both sides (LayerNorm
    and the residual stream included), so the logits are held within
    5e-2 x max(1, max|ref|), five bf16 ulps at the logits' size."""
    jm, tm = _pair()
    jopt = pj.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters())
    topt_ = topt.AdamW(1e-3, parameters=tm.parameters())
    jm, jopt = jamp.decorate(jm, jopt, level="O2")
    got = tamp.decorate(tm, topt_, level="O2")
    assert got == (tm, topt_)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert [id(p) for p in topt_._parameters] == \
        [id(p._data) for p in tm.parameters()]
    ji, ti = JTensor(jnp.asarray(IDS)), pt.to_tensor(IDS)
    jlo, tlo = jm(ji), tm(ti)
    assert tlo.dtype == torch.bfloat16
    _bf16_close(tlo.astype("float32").numpy(),
                jlo.astype("float32").numpy(), "logits", rel=5e-2)
    assert tamp.decorate(tm, level="O1") is tm


def _scaler_pair(**kw):
    r = np.random.RandomState(5)
    w, b = r.randn(4, 3).astype("f4"), r.randn(3).astype("f4")
    sides = []
    for P, amp in ((pj, jamp), (pt, tamp)):
        lin = P.nn.Linear(4, 3)
        lin.set_state_dict({"weight": w, "bias": b})
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
        sides.append((P, lin, opt, amp.GradScaler(**kw)))
    return sides


def test_grad_scaler_state_machine_matches_jax():
    """Steps ok, inf, inf, ok x 3, inf: the infs skip their steps (the
    weights stay), the second inf in a row halves the scale, three good
    steps in a row double it; the scale, the counters and the weights
    equal the JAX scaler's after every step."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    sides = _scaler_pair(**kw)
    x = np.random.RandomState(6).randn(5, 4).astype("f4")
    scales = []
    for bad in (False, True, True, False, False, False, True):
        states = []
        for P, lin, opt, scaler in sides:
            before = lin.weight.numpy().copy()
            loss = lin(P.to_tensor(x)).sum() * (float("inf") if bad else 1.0)
            scaler.minimize(opt, scaler.scale(loss))
            opt.clear_grad()
            after = lin.weight.numpy()
            assert np.array_equal(after, before) == bad
            states.append((scaler.state_dict(), after.copy()))
        (jsd, jw), (tsd, tw) = states
        assert tsd == jsd
        np.testing.assert_allclose(tw, jw, atol=1e-6)
        scales.append(tsd["scale"])
    assert scales == [1024.0, 1024.0, 512.0, 512.0, 512.0, 1024.0, 1024.0]
    # state_dict round trip into a fresh scaler
    fresh = tamp.GradScaler(**kw)
    fresh.load_state_dict(sides[1][3].state_dict())
    assert fresh.state_dict() == sides[1][3].state_dict()
    assert fresh.get_init_loss_scaling() == 1024.0
    assert fresh.is_enable() and fresh.is_use_dynamic_loss_scaling()
    off = tamp.AmpScaler(enable=False)
    assert off.scale(3.0) == 3.0 and not off.is_use_dynamic_loss_scaling()


def test_grad_scaler_unscales_a_selected_rows_gradient_like_jax():
    table = np.random.RandomState(7).randn(10, 4).astype("f4")
    ids = np.array([[1, 3, 3, 7]], "int32")
    grads = []
    for P, amp in ((pj, jamp), (pt, tamp)):
        emb = P.nn.Embedding(10, 4, sparse=True)
        emb.set_state_dict({"weight": table})
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=emb.parameters())
        scaler = amp.GradScaler(init_loss_scaling=64.0)
        (emb(P.to_tensor(ids)) * 3.0).sum().backward()
        g = emb.weight.grad
        assert type(g).__name__ == "SelectedRows"
        scaler.unscale_(opt)
        g = emb.weight.grad
        assert type(g).__name__ == "SelectedRows"
        dense = g.to_dense()
        grads.append(np.asarray(getattr(dense, "_data", dense), "f4"))
        assert not scaler._found_inf
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-6)
    assert grads[1][3].tolist() == [6.0 / 64.0] * 4
