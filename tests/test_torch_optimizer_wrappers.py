"""The optimizer wrappers of the port (paddle_tpu_torch.optimizer
.wrappers) against the JAX package's (paddle_tpu.optimizer.wrappers):
ExponentialMovingAverage, ModelAverage, LookaheadOptimizer and
GradientMergeOptimizer, on seeded numpy weights and grads, f32.

Weights within rtol 1e-6 and atol 1e-7 (the same f32 operations in the
same order; the JAX package's compiled updates may fuse a multiply-add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Parameter as JParameter
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.optimizer import wrappers as jw
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.optimizer import wrappers as tw

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

SHAPES = [(6, 5), (7,), (3, 4, 2)]
TOL = dict(rtol=1e-6, atol=1e-7)


def _params():
    rs = np.random.RandomState(41)
    arrs = [(rs.randn(*s) * 0.5).astype("f4") for s in SHAPES]
    return ([JParameter(jnp.asarray(a)) for a in arrs],
            [torch.nn.Parameter(torch.tensor(a)) for a in arrs])


def _set_grads(jps, tps, rs):
    for jp, tp in zip(jps, tps):
        g = rs.randn(*tp.shape).astype("f4")
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.tensor(g)


def _close(tps, jps):
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data), **TOL)


@pytest.mark.parametrize("name", ["ema", "model_average"])
def test_averages_apply_and_restore_match_jax(name):
    jps, tps = _params()
    jo = pt.optimizer.SGD(learning_rate=0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps)
    if name == "ema":
        ja = jw.ExponentialMovingAverage(decay=0.9, parameters=jps)
        ta = tw.ExponentialMovingAverage(decay=0.9, parameters=tps)
    else:
        kw = dict(average_window_rate=0.5, min_average_window=2,
                  max_average_window=4)
        ja = jw.ModelAverage(parameters=jps, **kw)
        ta = tw.ModelAverage(parameters=tps, **kw)
    rs = np.random.RandomState(42)
    for _ in range(6):
        _set_grads(jps, tps, rs)
        jo.step()
        to.step()
        ja.update()
        ta.update()
    live = [tp.detach().clone() for tp in tps]
    held = [tp.data_ptr() for tp in tps]
    with ta.apply():
        with ja.apply():
            _close(tps, jps)                 # the averages
            assert not all(torch.equal(a, b) for a, b in zip(live, tps))
    for a, b in zip(live, tps):              # restored on exit
        assert torch.equal(a, b)
    assert [tp.data_ptr() for tp in tps] == held     # in place
    _close(tps, jps)
    ta.apply(need_restore=False)
    ja.apply(need_restore=False)
    _close(tps, jps)
    ta.restore()
    ja.restore()
    for a, b in zip(live, tps):
        assert torch.equal(a, b)


def test_ema_before_any_update_and_state_dict():
    jps, tps = _params()
    ema = tw.ExponentialMovingAverage(decay=0.5, parameters=tps)
    live = [tp.detach().clone() for tp in tps]
    with ema.apply():
        for a, b in zip(live, tps):
            assert torch.equal(a, b)         # no update yet: the weights
    ema.update()
    sd = ema.state_dict()
    assert sd["step"] == 1
    other = tw.ExponentialMovingAverage(decay=0.5, parameters=tps)
    other.set_state_dict(sd)
    with torch.no_grad():
        for p in tps:
            p.mul_(3.0)
    with ema.apply(), torch.no_grad():
        a = [p.clone() for p in tps]
    with other.apply(), torch.no_grad():
        b = [p.clone() for p in tps]
    for x, y, w in zip(a, b, live):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, w)     # ema_1 / (1 - 0.5) = p_1
    with pytest.raises(ValueError, match="parameters"):
        tw.ExponentialMovingAverage()


@pytest.mark.parametrize("k", [1, 3])
def test_lookahead_matches_jax(k):
    jps, tps = _params()
    jo = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=jps)
    to = topt.Momentum(0.1, momentum=0.9, parameters=tps)
    jl = jw.LookaheadOptimizer(jo, alpha=0.4, k=k)
    tl = tw.LookaheadOptimizer(to, alpha=0.4, k=k)
    rs = np.random.RandomState(43)
    moved = False
    for step in range(1, 8):
        _set_grads(jps, tps, rs)
        before = [tp.detach().clone() for tp in tps]
        jl.step()
        tl.step()
        _close(tps, jps)
        if step % k == 0 and k > 1:
            moved = True
            for s, tp in zip(tl._slow, tps):
                assert torch.equal(s, tp.detach())
        assert not all(torch.equal(a, b) for a, b in zip(before, tps))
    assert moved or k == 1
    assert tl.get_lr() == jl.get_lr() == 0.1
    tl.clear_grad()
    assert all(p.grad is None for p in tps)


@pytest.mark.parametrize("k,avg", [(1, True), (3, True), (2, False)])
def test_gradient_merge_matches_jax(k, avg):
    jps, tps = _params()
    jo = pt.optimizer.SGD(learning_rate=0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps)
    jg = jw.GradientMergeOptimizer(jo, k_steps=k, avg=avg)
    tg = tw.GradientMergeOptimizer(to, k_steps=k, avg=avg)
    rs = np.random.RandomState(44)
    for step in range(1, 7):
        _set_grads(jps, tps, rs)
        before = [tp.detach().clone() for tp in tps]
        jg.step()
        tg.step()
        assert all(p.grad is None for p in tps)      # consumed
        _close(tps, jps)
        changed = not all(torch.equal(a, b) for a, b in zip(before, tps))
        assert changed == (step % k == 0)
    assert to._global_step == jo._global_step == 6 // k


def test_minimize_runs_backward_and_step():
    tps = [torch.nn.Parameter(torch.ones(3))]
    opt = topt.SGD(0.5, parameters=tps)
    merge = tw.GradientMergeOptimizer(opt, k_steps=1)
    merge.minimize((tps[0] * 2.0).sum())
    assert tps[0].tolist() == [0.0, 0.0, 0.0] and tps[0].grad is None
    look = tw.LookaheadOptimizer(topt.SGD(0.5, parameters=tps), k=1,
                                 alpha=1.0)
    look.minimize((tps[0] * 2.0).sum())
    assert tps[0].tolist() == [-1.0, -1.0, -1.0]
    assert opt.minimize((tps[0] * 2.0).sum()) == ([], [])


def test_train_step_refuses_a_wrapper():
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                         num_heads=2, max_seq_len=16)
    model = tgpt.GPTForPretraining(cfg, device="cpu")
    inner = topt.AdamW(1e-3, parameters=model.parameters())
    for wrapper in (tw.LookaheadOptimizer(inner, k=2),
                    tw.GradientMergeOptimizer(inner, k_steps=2)):
        with pytest.raises(TypeError, match="wrappers"):
            TrainStep(model, tgpt.gpt_pretrain_loss, wrapper)
    TrainStep(model, tgpt.gpt_pretrain_loss, inner)
