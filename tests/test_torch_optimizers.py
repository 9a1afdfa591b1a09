"""The nine optimizers beyond SGD/Adam/AdamW, the regularizers and the
per-parameter learning rates of the port (paddle_tpu_torch.optimizer,
paddle_tpu_torch.regularizer) against the JAX package's eager `step()`
(paddle_tpu.optimizer, paddle_tpu.regularizer).

Seeded numpy weights and grads go to both packages, five steps. f32
weights and state within rtol 1e-5 (atol 1e-6: the rules' reductions
and transcendental functions round differently); bf16 weights under
multi_precision within one bf16 ulp (rtol 1e-2) and their f32 masters
within rtol 1e-5; one Dpsgd step with sigma 0 and no clipping within
two f32 ulps (rtol 2.5e-7: XLA fuses p - lr g into a multiply-add on
the CPU, torch rounds the product first). Train
steps over a GPT follow the JAX eager loop within rtol 1e-5 (Momentum,
as tests/test_torch_train.py's SGD).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.tensor import Parameter as JParameter
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nlp.gpt import gpt_pretrain_loss as jloss
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.optimizer import fused_adam

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

SHAPES = [(6, 5), (7,), (3, 4, 2)]

# (name, class, kwargs) of every case; the JAX and the port classes take
# the same arguments
CASES = [
    ("Momentum", "Momentum", dict(momentum=0.9)),
    ("Momentum-nesterov", "Momentum", dict(momentum=0.8,
                                           use_nesterov=True)),
    ("Adamax", "Adamax", dict(beta1=0.8, beta2=0.95)),
    ("Adagrad", "Adagrad", dict(epsilon=1e-6,
                                initial_accumulator_value=0.1)),
    ("Adadelta", "Adadelta", dict(epsilon=1e-6, rho=0.9)),
    ("RMSProp", "RMSProp", dict(rho=0.9, epsilon=1e-6)),
    ("RMSProp-centered", "RMSProp", dict(rho=0.9, epsilon=1e-6,
                                         momentum=0.5, centered=True)),
    ("Lamb", "Lamb", dict(lamb_weight_decay=0.01, beta1=0.8, beta2=0.95)),
    ("Lars", "Lars", dict(momentum=0.9, lars_coeff=0.01,
                          lars_weight_decay=0.001)),
    ("Ftrl", "Ftrl", dict(l1=0.001, l2=0.01)),
    ("Dpsgd-sigma0", "Dpsgd", dict(clip=1.5, batch_size=4.0, sigma=0.0)),
]
LR = {"Adadelta": 1.0, "Ftrl": 0.1}


def _arrays(seed=31):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * 0.5).astype("f4") for s in SHAPES]


def _grads(rs):
    return [rs.randn(*s).astype("f4") for s in SHAPES]


def _pair(cls, kw, lr, dtype="float32", arrs=None, attrs=None, **extra):
    """The JAX and the port optimizer over the same weights; `attrs`
    sets per-parameter attributes (name -> callable of the package's
    regularizer module) on both."""
    arrs = arrs if arrs is not None else _arrays()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jps = [JParameter(jnp.asarray(a, jdt)) for a in arrs]
    tps = [torch.nn.Parameter(torch.tensor(a).to(getattr(torch, dtype)))
           for a in arrs]
    for i, at in (attrs or {}).items():
        for k, v in at.items():
            setattr(jps[i], k, v(jreg) if callable(v) else v)
            setattr(tps[i], k, v(treg) if callable(v) else v)
    jkw = {k: (v(jreg) if callable(v) else v) for k, v in extra.items()}
    tkw = {k: (v(treg) if callable(v) else v) for k, v in extra.items()}
    jo = getattr(pt.optimizer, cls)(learning_rate=lr, parameters=jps,
                                    **kw, **jkw)
    to = getattr(topt, cls)(lr, parameters=tps, **kw, **tkw)
    return jo, jps, to, tps


def _run(jo, jps, to, tps, steps=5, seed=32):
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        for jp, tp, g in zip(jps, tps, _grads(rs)):
            jp.grad = Tensor(jnp.asarray(g, jp._data.dtype))
            tp.grad = torch.tensor(g).to(tp.dtype)
        jo.step()
        to.step()


def _close(tps, jps, rtol=1e-5, atol=1e-6):
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._data, np.float32),
                                   rtol=rtol, atol=atol)


def _state_close(to, jo, jps, rtol=1e-5, atol=1e-6):
    for i, jp in enumerate(jps):
        for slot, arr in jo._accumulators[id(jp)].items():
            if slot == "noise_idx":          # Dpsgd's jax.random index
                continue
            np.testing.assert_allclose(
                to._state[i][slot].float().numpy(),
                np.asarray(arr, np.float32), rtol=rtol, atol=atol,
                err_msg=slot)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_optimizer_matches_jax_f32(case):
    _, cls, kw = case
    jo, jps, to, tps = _pair(cls, kw, LR.get(cls, 0.01))
    _run(jo, jps, to, tps)
    _close(tps, jps)
    _state_close(to, jo, jps)
    assert to._global_step == jo._global_step == 5
    assert not any(torch.equal(tp.detach(), torch.tensor(a))
                   for tp, a in zip(tps, _arrays()))


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_bf16_multi_precision_matches_jax(nesterov):
    jo, jps, to, tps = _pair("Momentum", dict(momentum=0.9,
                                              use_nesterov=nesterov,
                                              multi_precision=True),
                             0.05, dtype="bfloat16")
    _run(jo, jps, to, tps)
    assert all(tp.dtype == torch.bfloat16 for tp in tps)
    _close(tps, jps, rtol=1e-2, atol=1e-2)
    _state_close(to, jo, jps)               # f32 velocity and master
    assert set(to._state[0]) == {"velocity", "master"}


def test_momentum_bf16_without_master_rounds_as_jax():
    """bf16 weights and velocity without a master: the hyperparameters
    and lr round to bf16 as the JAX rule's weakly typed scalars do."""
    jo, jps, to, tps = _pair("Momentum", dict(momentum=0.9), 0.05,
                             dtype="bfloat16")
    _run(jo, jps, to, tps)
    for tp, jp in zip(tps, jps):
        np.testing.assert_array_equal(
            tp.detach().float().numpy(), np.asarray(jp._data, np.float32))
    assert to._state[0]["velocity"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["Adagrad", "Adadelta", "RMSProp", "Lamb",
                                  "Lars", "Ftrl"])
def test_f32_state_whatever_the_weights_dtype(name):
    kw = next(c[2] for c in CASES if c[0] == name)
    _, _, to, tps = _pair(name, kw, 0.01, dtype="bfloat16")
    for tp in tps:
        tp.grad = torch.ones_like(tp)
    to.step()
    assert all(t.dtype == torch.float32 for t in to._state[0].values())


# regularizer objects, a parameter's own regularizer and learning rate
ATTRS = {0: {"regularizer": lambda m: m.L1Decay(0.05)},
         1: {"learning_rate": 2.0},
         2: {"regularizer": lambda m: m.L2Decay(0.1),
             "learning_rate": 0.5}}


@pytest.mark.parametrize("cls,kw,dtype", [
    ("SGD", {}, "float32"),
    ("Momentum", dict(momentum=0.9), "float32"),
    ("Momentum", dict(momentum=0.9, multi_precision=True), "bfloat16"),
    ("Adam", dict(beta1=0.8, beta2=0.95), "float32"),
    ("Adam", dict(beta1=0.8, beta2=0.95, multi_precision=True), "bfloat16"),
    ("AdamW", dict(beta1=0.8, beta2=0.95, weight_decay=0.1), "float32"),
    ("Adagrad", {}, "float32"),
    ("RMSProp", dict(rho=0.9), "float32"),
    ("Ftrl", dict(l2=0.01), "float32"),
], ids=lambda x: x if isinstance(x, str) else None)
@pytest.mark.parametrize("decay", ["l1", "l2", "none"])
def test_regularizers_and_per_parameter_attributes_match_jax(cls, kw, dtype,
                                                             decay):
    extra = {} if decay == "none" or cls == "AdamW" else {
        "weight_decay": (lambda m: m.L1Decay(0.02)) if decay == "l1"
        else (lambda m: m.L2Decay(0.02))}
    jo, jps, to, tps = _pair(cls, kw, LR.get(cls, 0.01), dtype=dtype,
                             attrs=ATTRS, **extra)
    _run(jo, jps, to, tps)
    if dtype == "float32":
        _close(tps, jps)
        _state_close(to, jo, jps)
    else:
        _close(tps, jps, rtol=1e-2, atol=1e-2)
        _state_close(to, jo, jps, rtol=1e-5, atol=1e-6)


def test_cpu_norms_are_the_f64_sums_rounded_once():
    """Lamb, Lars and Dpsgd take per-tensor norms; on the CPU they are
    summed in f64, so a 4M-element tensor's norm is the correctly
    rounded f32 value (as the card's tree reduction nearly is)."""
    from paddle_tpu_torch.optimizer.optimizer import _norms
    x = torch.randn(4_000_000, generator=torch.Generator().manual_seed(0))
    got = _norms([x, x[:7]])
    want = [torch.linalg.vector_norm(t.double()).float() for t in (x, x[:7])]
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.stack(want))


def test_weight_decay_float_is_l2_and_zero_is_none():
    p = torch.nn.Parameter(torch.ones(3))
    assert isinstance(topt.SGD(0.1, parameters=[p], weight_decay=0.5)
                      ._weight_decay, treg.L2Decay)
    assert topt.SGD(0.1, parameters=[p], weight_decay=0.0)._weight_decay \
        is None
    reg = treg.L1Decay(0.3)
    assert topt.Momentum(0.1, parameters=[p], weight_decay=reg) \
        ._weight_decay is reg
    with pytest.raises(TypeError, match="regularizer"):
        topt.SGD(0.1, parameters=[p], weight_decay="l2")
    assert treg.L1DecayRegularizer is treg.L1Decay
    assert treg.L2DecayRegularizer is treg.L2Decay
    base = torch.tensor([-2.0, 0.0, 3.0])
    g = torch.zeros(3)
    assert treg.L1Decay(0.5).append(base, g).tolist() == [-0.5, 0.0, 0.5]
    assert treg.L2Decay(0.5).append(base, g).tolist() == [-1.0, 0.0, 1.5]


def test_lazy_mode_and_lr_ratio_are_accepted_with_the_default_trajectory():
    """Both only matter where the JAX package has no dense effect either
    (row-sparse grads; an AdamW argument it never stores): the
    trajectory is the default one, and the JAX optimizer's with them."""
    for cls, kw in (("Adam", dict(lazy_mode=True)),
                    ("AdamW", dict(lr_ratio=lambda p: 0.5)),
                    ("AdamW", dict(lazy_mode=True, lr_ratio=0.1))):
        _, _, plain, pps = _pair(cls, {}, 0.01)
        jo, jps, to, tps = _pair(cls, kw, 0.01)
        rs = np.random.RandomState(33)
        for _ in range(5):
            for a, b, c, g in zip(pps, tps, jps, _grads(rs)):
                a.grad = torch.tensor(g)
                b.grad = torch.tensor(g)
                c.grad = Tensor(jnp.asarray(g))
            plain.step()
            to.step()
            jo.step()
        for a, b in zip(pps, tps):
            assert torch.equal(a, b)
        _close(tps, jps)


def test_dpsgd_sigma0_without_clipping_equals_jax_to_the_ulp():
    """No noise and no clipping leave p - lr g: the JAX update up to
    the rounding of the product lr g, which XLA on the CPU contracts
    into one fused multiply-add and torch rounds first."""
    jo, jps, to, tps = _pair("Dpsgd", dict(clip=100.0, sigma=0.0), 0.05)
    _run(jo, jps, to, tps, steps=1)
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data), rtol=2.5e-7,
                                   atol=1e-8)


def test_dpsgd_noise_is_seeded_and_has_the_stated_std():
    """With zero gradients an update is -lr * noise: the same seed draws
    the same noise, another seed other noise, and the noise's std is
    clip * sigma / batch_size (within 2% over 40000 draws), as the JAX
    package's noise has."""
    clip, sigma, batch, lr = 2.0, 1.5, 8.0, 0.1
    std = clip * sigma / batch

    def port(seed):
        p = torch.nn.Parameter(torch.zeros(200, 200))
        opt = topt.Dpsgd(lr, clip=clip, batch_size=batch, sigma=sigma,
                         parameters=[p], seed=seed)
        p.grad = torch.zeros_like(p)
        opt.step()
        assert opt.generator.device == p.device
        return (-p.detach() / lr).numpy()
    a, b, c = port(5), port(5), port(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.std() / std - 1) < 0.02 and abs(a.mean()) < 0.02 * std
    jp = JParameter(jnp.zeros((200, 200)))
    jo = pt.optimizer.Dpsgd(learning_rate=lr, clip=clip, batch_size=batch,
                            sigma=sigma, parameters=[jp])
    jp.grad = Tensor(jnp.zeros((200, 200)))
    jo.step()
    jnoise = -np.asarray(jp._data) / lr
    assert abs(jnoise.std() / std - 1) < 0.02


SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)


def test_train_step_with_per_parameter_attributes_matches_jax_eager():
    """The port's TrainStep (one step() for eager and graphed) honours
    a parameter's regularizer and learning_rate, as the JAX package's
    eager step() does (its TrainStep's functional update drops them):
    three Momentum steps over a GPT against the JAX eager loop."""
    ids = np.random.RandomState(0).randint(0, 512, (2, 128)).astype("int32")
    tids = torch.tensor(ids, dtype=torch.long)
    pt.seed(3)
    jm = JGPT(JConfig(**SMALL))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    jnamed, tnamed = dict(jm.named_parameters()), dict(tm.named_parameters())
    for name, attrs in (("gpt.embeddings.word_embeddings.weight",
                         {"learning_rate": 0.5}),
                        ("gpt.ln_f.weight",
                         {"regularizer": lambda m: m.L1Decay(0.01)}),
                        ("gpt.blocks.0.mlp.fc_in.weight",
                         {"regularizer": lambda m: m.L2Decay(0.05),
                          "learning_rate": 3.0})):
        for k, v in attrs.items():
            setattr(jnamed[name], k, v(jreg) if callable(v) else v)
            setattr(tnamed[name], k, v(treg) if callable(v) else v)
    jopt = pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                 parameters=jm.parameters(),
                                 weight_decay=jreg.L2Decay(0.001))
    topt_ = topt.Momentum(0.05, momentum=0.9, parameters=tm.parameters(),
                          weight_decay=treg.L2Decay(0.001))
    step = TrainStep(tm, tgpt.gpt_pretrain_loss, topt_)
    jl, tl = [], []
    for _ in range(3):
        loss = jloss(jm(Tensor(jnp.asarray(ids))), Tensor(jnp.asarray(ids)))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        tl.append(float(step(tids, tids)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    w = tnamed["gpt.blocks.0.mlp.fc_in.weight"].detach().numpy()
    np.testing.assert_allclose(
        w, np.asarray(jnamed["gpt.blocks.0.mlp.fc_in.weight"]._data),
        rtol=1e-4, atol=1e-5)


def test_fused_kernel_groups_by_dtype_master_lr_and_regularizer(monkeypatch):
    """Adam/AdamW on the card launch the fused kernel once per (dtype,
    master, lr multiplier, gradient term) group, with that group's
    arguments; GPT-2's default attributes give one launch per dtype.
    (The launches themselves run on the card: chip_smoke.py's optimizer
    phase holds them against this plain path.)"""
    calls = []

    def record(params, grads, m, v, masters, scalars, b1, b2, eps,
               **kw):
        calls.append((len(params), params[0].dtype, masters is not None,
                      kw))
    monkeypatch.setattr(fused_adam, "cuda_adam", record)
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    opt = topt.AdamW(1e-3, parameters=tm.parameters(), kernel="cuda")
    for p in tm.parameters():
        p.grad = torch.zeros_like(p._data)
    opt.step()
    n = len(tm.parameters())
    assert calls == [(n, torch.float32, False, dict(
        grad_mode=None, grad_coeff=0.0, decoupled=True, decay=0.01,
        lr_scale=1.0))]
    calls.clear()
    ps = [torch.nn.Parameter(torch.zeros(4, dtype=dt))
          for dt in (torch.float32, torch.bfloat16, torch.bfloat16,
                     torch.float32, torch.float32)]
    ps[2].regularizer = treg.L1Decay(0.3)
    ps[3].learning_rate = 0.5
    ps[4].regularizer = treg.L2Decay(0.3)
    ps[4].learning_rate = 0.5
    opt = topt.Adam(1e-3, parameters=ps, weight_decay=0.01, kernel="cuda",
                    multi_precision=True)
    for p in ps:
        p.grad = torch.zeros_like(p)
    opt.step()
    bf = float(torch.tensor(0.01).bfloat16())
    assert [(c[0], c[1], c[2], c[3]["grad_mode"], c[3]["grad_coeff"],
             c[3]["lr_scale"]) for c in calls] == [
        (1, torch.float32, False, "l2", np.float32(0.01), 1.0),
        (1, torch.bfloat16, True, "l2", np.float32(0.01), 1.0),
        (1, torch.bfloat16, True, "l1", np.float32(0.3), 1.0),
        (1, torch.float32, False, "l2", np.float32(0.01), 0.5),
        (1, torch.float32, False, "l2", np.float32(0.3), 0.5)]
    assert all(not c[3]["decoupled"] for c in calls)
    assert bf != 0.01          # a bf16 base without a master rounds it
    p = torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))
    p.grad = torch.zeros_like(p)
    calls.clear()
    topt.Adam(1e-3, parameters=[p], weight_decay=0.01, kernel="cuda").step()
    assert calls[0][3]["grad_coeff"] == bf
    monkeypatch.undo()
    with pytest.raises(ValueError, match="grad_mode"):
        fused_adam.cuda_adam([p], [p], [p], [p], None, torch.zeros(2), 0.9,
                             0.999, 1e-8, grad_mode="l3")
