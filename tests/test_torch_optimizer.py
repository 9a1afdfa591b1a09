"""The port's optimizers with their step count and learning rate on the
device (paddle_tpu_torch.optimizer against paddle_tpu.optimizer), the
fused Adam/AdamW kernel's dispatch, and the train step with a learning
rate changed mid-run.

On the CPU every update runs the plain `_foreach_*` path; the fused
kernel (csrc/optimizer.cu) runs only on the card, where chip_smoke.py's
`optimizer` phase holds it against this plain path. Tolerances are those
of tests/test_torch_train.py: f32 weights within 1e-6, bf16 weights
within one bf16 ulp (1e-2 relative), moments within 1e-6 + 1e-5
relative (f32) or 1e-2 (bf16 weights); a state-dict round trip is
exact; TrainStep losses agree with the JAX TrainStep within rtol 1e-3
under AdamW (its first steps move every weight by about +-lr whatever
the gradient).
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
from paddle_tpu_torch import kernels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.optimizer import fused_adam

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

SHAPES = [(6, 5), (7,), (3, 4, 2)]
CASES = [(n, dt, mp) for n in ("Adam", "AdamW")
         for dt, mp in (("float32", False), ("bfloat16", False),
                        ("bfloat16", True))]
IDS = [f"{n}-{d}{'-mp' if m else ''}" for n, d, m in CASES]


def _arrays(seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype("f4") for s in SHAPES]


def _torch_opt(name, dtype, mp, lr=0.01, arrs=None):
    tps = [torch.nn.Parameter(torch.tensor(a).to(getattr(torch, dtype)))
           for a in (arrs if arrs is not None else _arrays())]
    kw = {"beta1": 0.8, "beta2": 0.95, "multi_precision": mp}
    kw["weight_decay"] = 0.01 if name == "Adam" else 0.1
    if name == "SGD":
        kw = {}
    return getattr(topt, name)(lr, parameters=tps, **kw), tps


def _grads(rng):
    return [rng.randn(*s).astype("f4") for s in SHAPES]


@pytest.mark.parametrize("name,dtype,mp", CASES, ids=IDS)
def test_set_lr_between_steps_matches_jax(name, dtype, mp):
    """lr 0.01 for two steps, then set_lr(0.003): the device pair
    carries the change, and weights and moments follow the JAX
    optimizer given the same change."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jps = [JParameter(jnp.asarray(a, jdt)) for a in _arrays()]
    jo = getattr(pt.optimizer, name)(
        learning_rate=0.01, parameters=jps, beta1=0.8, beta2=0.95,
        multi_precision=mp, weight_decay=0.01 if name == "Adam" else 0.1)
    to, tps = _torch_opt(name, dtype, mp)
    rng = np.random.RandomState(12)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-2, rtol=1e-2)
    for step in range(1, 5):
        if step == 3:
            jo.set_lr(0.003)
            to.set_lr(0.003)
        for jp, tp, g in zip(jps, tps, _grads(rng)):
            jp.grad = Tensor(jnp.asarray(g, jp._data.dtype))
            tp.grad = torch.tensor(g).to(tp.dtype)
        jo.step()
        to.step()
        lr = 0.01 if step < 3 else 0.003
        assert to._scalars.tolist() == [np.float32(lr), float(step)]
        assert to._global_step == step
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(
                tp.detach().float().numpy(),
                np.asarray(jp._data, np.float32), **tol)
    for i, jp in enumerate(jps):
        for slot, arr in jo._accumulators[id(jp)].items():
            np.testing.assert_allclose(
                to._state[i][slot].float().numpy(),
                np.asarray(arr, np.float32), atol=1e-6,
                rtol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("name,dtype,mp",
                         [("SGD", "float32", False), *CASES],
                         ids=["SGD-float32", *IDS])
def test_state_dict_round_trip_continues_the_trajectory(name, dtype, mp):
    """Four steps straight, against two steps, a state_dict() into a new
    optimizer over the same weights, and two more: the same weights and
    state, exactly."""
    rng = np.random.RandomState(14)
    grads = [_grads(rng) for _ in range(4)]

    def run(opt, tps, steps):
        for gs in steps:
            for tp, g in zip(tps, gs):
                tp.grad = torch.tensor(g).to(tp.dtype)
            opt.step()

    whole, wps = _torch_opt(name, dtype, mp)
    run(whole, wps, grads)
    first, fps = _torch_opt(name, dtype, mp)
    run(first, fps, grads[:2])
    sd = first.state_dict()
    assert sd["global_step"] == 2 and isinstance(sd["global_step"], int)
    second = type(first)(0.01, parameters=fps,
                         **({} if name == "SGD" else {
                             "beta1": 0.8, "beta2": 0.95,
                             "multi_precision": mp,
                             "weight_decay": 0.01 if name == "Adam"
                             else 0.1}))
    second.set_state_dict(sd)
    assert second._global_step == 2 and isinstance(second._global_step, int)
    run(second, fps, grads[2:])
    assert second._scalars.tolist() == [np.float32(0.01), 4.0]
    for a, b in zip(wps, fps):
        assert torch.equal(a, b)
    for i, st in whole._state.items():
        for slot, t in st.items():
            assert torch.equal(second._state[i][slot], t), (i, slot)


def test_set_state_dict_writes_existing_state_in_place():
    """A captured graph holds the optimizer's state tensors, so loading
    a checkpoint into state that exists copies into it."""
    opt, tps = _torch_opt("AdamW", "bfloat16", True)
    for p in tps:
        p.grad = torch.ones_like(p)
    opt.step()
    held = {(i, n): t for i, st in opt._state.items() for n, t in st.items()}
    sd = {k: (v * 2 if isinstance(v, torch.Tensor) else v)
          for k, v in opt.state_dict().items()}
    opt.set_state_dict(sd)
    for (i, n), t in held.items():
        assert opt._state[i][n] is t
        assert torch.equal(t, sd[f"param_{i}.{n}"])


def test_auto_picks_plain_for_cpu_and_cuda_refuses_cpu_tensors():
    assert fused_adam.resolve_kernel("auto", "cpu") == "plain"
    assert fused_adam.resolve_kernel("auto", torch.device("cpu")) == "plain"
    assert fused_adam.resolve_kernel("auto", "cuda") == "cuda"
    assert fused_adam.resolve_kernel("cuda", "cpu") == "cuda"
    assert fused_adam.resolve_kernel("plain", "cuda") == "plain"
    assert topt.AdamW(0.01, parameters=[])._kernel == "auto"
    with pytest.raises(ValueError, match="unknown optimizer kernel"):
        fused_adam.resolve_kernel("fused")
    with pytest.raises(ValueError, match="unknown optimizer kernel"):
        topt.AdamW(0.01, parameters=[], kernel="fused")
    before = dict(fused_adam.launches)
    for name in ("Adam", "AdamW"):
        opt, tps = _torch_opt(name, "float32", False)
        opt._kernel = "cuda"
        for p in tps:
            p.grad = torch.ones_like(p)
        with pytest.raises(RuntimeError, match="CUDA tensors; param 0 is "
                                               "on cpu"):
            opt.step()
    p = torch.zeros(8)
    with pytest.raises(RuntimeError, match="CUDA tensors; param 0 is on cpu"):
        fused_adam.cuda_adam([p], [p], [p], [p], None, torch.zeros(2), 0.9,
                             0.999, 1e-8)
    assert fused_adam.launches == before


def test_every_kernel_counter_is_registered():
    from paddle_tpu_torch.nn import paged_attention as pa
    from paddle_tpu_torch.ops import flash_attention as fa
    assert kernels.COUNTERS["optimizer"] is fused_adam.launches
    assert kernels.COUNTERS["flash_attention"] is fa.launches
    assert kernels.COUNTERS["paged_attention"] is pa.launches
    counts = kernels.launch_counts()
    assert {"optimizer.adam", "flash_attention.fwd", "flash_attention.dd",
            "paged_attention.decode"} <= set(counts)
    assert all(isinstance(n, int) for n in counts.values())
    assert set(kernels.SIGNATURES["optimizer"]) == {
        "optimizer_adam_step", "optimizer_adam_max_tensors"}


SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)


def test_train_step_on_cpu_matches_jax_with_an_lr_change():
    """Three AdamW steps, the learning rate cut before step 2, through the
    JAX TrainStep (one compiled program taking lr as a device scalar)
    and the port's (eager on the CPU): the same losses, the same step
    count, and a third loss that the change moved."""
    ids = np.random.RandomState(0).randint(0, 512, (2, 128)).astype("int32")
    tids = torch.tensor(ids, dtype=torch.long)

    def port(change):
        pt.seed(3)
        jm = JGPT(JConfig(**SMALL))
        tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
        tgpt.load_jax_state(tm, {k: v.numpy()
                                 for k, v in jm.state_dict().items()})
        opt = topt.AdamW(1e-3, parameters=tm.parameters())
        step = TrainStep(tm, tgpt.gpt_pretrain_loss, opt)
        assert step.graphs == {} and not step._graphed
        losses = []
        for i in range(3):
            if i == 1 and change:
                opt.set_lr(2e-4)
            losses.append(float(step(tids, tids)))
            assert all(p.grad is None for p in tm.parameters())
        return jm, opt, losses

    jm, opt, tl = port(True)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jstep = JTrainStep(jm, jloss, jopt)
    jl = []
    for i in range(3):
        if i == 1:
            jopt.set_lr(2e-4)
        jl.append(float(jstep(ids, ids).numpy()))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert opt._global_step == jstep._step_i == 3
    assert opt._scalars.tolist() == [np.float32(2e-4), 3.0]
    _, _, unchanged = port(False)
    assert unchanged[:2] == tl[:2] and unchanged[2] != tl[2]


def test_train_step_runs_eagerly_on_the_cpu():
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    for graphed in (True, False):
        step = TrainStep(tm, tgpt.gpt_pretrain_loss, opt,
                         cuda_graph=graphed)
        assert not step._graphed and step.graphs == {}


def test_train_step_eval_fn_matches_jax_after_two_steps():
    """eval_fn: after two AdamW steps the port's eval forward (in eval
    mode, without grad, over the live weights) gives the JAX
    TrainStep.eval_fn's logits within the AdamW tolerance, and both put
    the model back in training mode."""
    ids = np.random.RandomState(1).randint(0, 512, (2, 128)).astype("int32")
    tids = torch.tensor(ids, dtype=torch.long)
    pt.seed(4)
    jm = JGPT(JConfig(**SMALL))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    step = TrainStep(tm, tgpt.gpt_pretrain_loss,
                     topt.AdamW(1e-3, parameters=tm.parameters()))
    jstep = JTrainStep(jm, jloss, pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    for _ in range(2):
        step(tids, tids)
        jstep(ids, ids)
    seen = []
    hook = tm.register_forward_pre_hook(
        lambda mod, args: seen.append((mod.training,
                                       torch.is_grad_enabled())))
    got = step.eval_fn()(tids)
    hook.remove()
    want = jstep.eval_fn()(ids)
    assert seen == [(False, False)]
    assert tm.training and jm.training
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-3, atol=1e-3)
