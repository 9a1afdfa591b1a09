"""The port's learning-rate schedulers (paddle_tpu_torch.optimizer.lr)
against the JAX package's (paddle_tpu.optimizer.lr), and an optimizer
and the CPU train step driven by one.

The schedulers are the same Python arithmetic in both packages, so their
values are compared for equality. Weights follow the JAX optimizer's
eager step within 1e-6 (f32; AdamW 1e-5, see the test); train-step
losses follow the JAX
TrainStep within rtol 1e-3 (AdamW, as tests/test_torch_optimizer.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Parameter as JParameter
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nlp.gpt import gpt_pretrain_loss as jloss
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.optimizer import lr as tlr

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)


def _halve(epoch):
    return 0.5 ** (epoch % 3)


def _decay(epoch):
    return 0.97


# every scheduler of lr.py, by class name, with its arguments
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=8,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=6,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=15), warmup_steps=6,
        start_lr=0.001, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 9, 17],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, _halve),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=11, eta_min=0.002),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1, _decay),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(0.01, 0.1, 3,
                                                 mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(0.01, 0.1, 3,
                                               mode="exp_range",
                                               exp_gamma=0.9),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=0.001),
    "CosineAnnealingWarmRestarts-1": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4),
}


def test_every_scheduler_class_is_ported():
    def classes(mod):
        return {n for n, c in vars(mod).items() if isinstance(c, type)
                and issubclass(c, mod.LRScheduler)}
    assert classes(tlr) == classes(jlr)
    assert len(classes(tlr)) == 17
    covered = {k.split("-")[0] for k in SCHEDULERS} | {"LRScheduler",
                                                        "ReduceOnPlateau"}
    assert covered == classes(tlr)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_equal_jax_over_30_steps(name):
    t, j = SCHEDULERS[name](tlr), SCHEDULERS[name](jlr)
    assert type(t).__name__ == type(j).__name__
    for _ in range(30):
        assert t() == j() and t.get_lr() == j.get_lr()
        assert t.last_epoch == j.last_epoch
        t.step()
        j.step()


def test_reduce_on_plateau_follows_the_metric_sequence():
    metrics = [1.0, 0.9, 0.91, 0.92, 0.93, 0.89, 0.9, 0.9, 0.9, 0.9, 0.95,
               0.8, 0.81, 0.82, 0.83, 0.84, 0.85]
    for mode, sign in (("min", 1.0), ("max", -1.0)):
        for thr_mode in ("rel", "abs"):
            kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.01,
                      threshold_mode=thr_mode, cooldown=1, min_lr=0.01)
            t, j = tlr.ReduceOnPlateau(0.1, **kw), jlr.ReduceOnPlateau(0.1,
                                                                        **kw)
            lrs = []
            for x in metrics:
                # a tensor metric is read with .item()
                t.step(torch.tensor(sign * x, dtype=torch.float64))
                j.step(sign * x)
                assert t() == j()
                lrs.append(t())
            assert t.state_dict() == j.state_dict()
            assert min(lrs) < 0.1        # the plateau did cut it
    t.step()                             # no metric: lr unchanged
    assert t() == lrs[-1]


@pytest.mark.parametrize("name", ["LinearWarmup-cosine", "StepDecay",
                                  "CyclicLR"])
def test_state_dict_round_trip_continues_the_schedule(name):
    whole = SCHEDULERS[name](tlr)
    first = SCHEDULERS[name](tlr)
    jax_side = SCHEDULERS[name](jlr)
    for _ in range(7):
        whole.step()
        first.step()
        jax_side.step()
    sd = first.state_dict()
    jsd = jax_side.state_dict()
    assert sd == jsd
    resumed = SCHEDULERS[name](tlr)
    resumed.set_state_dict(sd)
    for _ in range(10):
        assert resumed() == whole()
        resumed.step()
        whole.step()


def _arrays(seed=21):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype("f4") for s in ((6, 5), (7,), (3, 4, 2))]


@pytest.mark.parametrize("opt", ["SGD", "Momentum", "AdamW"])
def test_optimizer_with_a_scheduler_matches_jax(opt):
    """Eight steps, the scheduler stepped after each: the device pair
    holds the schedule's value, and the weights follow the JAX
    optimizer's."""
    tsched = SCHEDULERS["LinearWarmup-cosine"](tlr)
    jsched = SCHEDULERS["LinearWarmup-cosine"](jlr)
    jps = [JParameter(jnp.asarray(a)) for a in _arrays()]
    tps = [torch.nn.Parameter(torch.tensor(a)) for a in _arrays()]
    jo = getattr(pt.optimizer, opt)(learning_rate=jsched, parameters=jps)
    to = getattr(topt, opt)(tsched, parameters=tps)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        to.set_lr(0.5)
    rs = np.random.RandomState(22)
    # AdamW's 1 - beta2 is the f32 rounding of the Python double, as the
    # JAX TrainStep's functional update has it; the JAX eager step takes
    # 1 - f32(beta2), 1.3e-5 relative apart, which moves weights stepped
    # by lr up to 0.1 by up to 2e-6
    tol = dict(rtol=1e-6, atol=1e-5 if opt == "AdamW" else 1e-6)
    for step in range(1, 9):
        for jp, tp in zip(jps, tps):
            g = rs.randn(*tp.shape).astype("f4")
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.tensor(g)
        jo.step()
        to.step()
        assert to.get_lr() == jo.get_lr() == tsched()
        assert to._scalars.tolist() == [np.float32(tsched()), float(step)]
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._data), **tol)
        tsched.step()
        jsched.step()
    sd = to.state_dict()
    assert sd["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
    fresh_sched = SCHEDULERS["LinearWarmup-cosine"](tlr)
    fresh = getattr(topt, opt)(fresh_sched, parameters=tps)
    fresh.set_state_dict(sd)
    assert fresh_sched() == tsched() and fresh.get_lr() == to.get_lr()


SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)


def test_train_step_on_cpu_with_a_scheduler_matches_jax():
    """Five AdamW steps of the CPU TrainStep under LinearWarmup over
    CosineAnnealingDecay, against the JAX TrainStep: the same losses,
    and the device lr equal to the schedule's value at every step (the
    graphed step reads it the same way, before each replay)."""
    ids = np.random.RandomState(0).randint(0, 512, (2, 128)).astype("int32")
    tids = torch.tensor(ids, dtype=torch.long)
    pt.seed(3)
    jm = JGPT(JConfig(**SMALL))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})

    def sched(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=4),
                                warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    ts, js = sched(tlr), sched(jlr)
    topt_ = topt.AdamW(ts, parameters=tm.parameters())
    jopt = pt.optimizer.AdamW(learning_rate=js, parameters=jm.parameters())
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, topt_)
    jstep = JTrainStep(jm, jloss, jopt)
    tl, jl, lrs = [], [], []
    for _ in range(5):
        tl.append(float(tstep(tids, tids)))
        jl.append(float(jstep(ids, ids).numpy()))
        assert topt_._scalars[0].item() == np.float32(ts())
        lrs.append(ts())
        ts.step()
        js.step()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert len(set(lrs)) == 5                  # it moved every step
