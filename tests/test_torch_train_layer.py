"""`Layer`'s functional methods and `jit.TrainStep` over a `Layer`
against the JAX package on the CPU.

`functional_state`, `_use_state` and `functional_call` on a small
Linear-BatchNorm-Linear layer (a buffer the call updates, a second
method) against JAX's, gradients through `functional_call` against
`jax.grad` of JAX's, and the layer's own state after the call and after
an exception inside `_use_state`. Then 3 `TrainStep` steps with AdamW
under NoamDecay over the small Transformer (chip_smoke.py's
`layer_transformer` at 2 + 2 layers, d_model 128, 2 heads of 64, source
256 and target 128 tokens, dropout 0) and over `layer_gpt` (2 layers,
128 wide, seq 128), against the JAX TrainStep from the same weights, and
`eval_fn`.

The optimizer is the chip run's: AdamW(beta1 0.9, beta2 0.98, epsilon
1e-9) on NoamDecay(d_model, 4000), the paper's schedule at the test's
width. Tolerances (f32): losses within 1e-5 relative, parameters within
1e-4 x max(1, |ref|) elementwise, functional outputs within 1e-5 x
max(1, |ref|) and gradients within 1e-4 x max(1, max|g|). Adam moves
a weight by about lr whatever its gradient's size, so a gradient near
0 (the key projection's bias is 0 in exact arithmetic, by the softmax's
shift invariance) whose rounding differs between the packages moves
its weight by up to 2 lr: the schedule's first lrs keep that far below
the tolerance, and the whole update (every parameter's change over the
3 steps) is held to the JAX update's direction and size apart.
"""
import importlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_train_layer_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(got, want, rtol, what):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= rtol * np.maximum(1.0, np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


def small(P):
    nn = P.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 6)
            self.bn = nn.BatchNorm1D(6)
            self.fc2 = nn.Linear(6, 3)

        def forward(self, x):
            return self.fc2(P.nn.functional.relu(self.bn(self.fc1(x))))

        def double(self, x, k=2.0):
            return self.forward(x) * k

    return Net()


def small_pair():
    pj.seed(0)
    jm, tm = small(pj), small(pt)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def test_functional_state_and_call_match_jax():
    jm, tm = small_pair()
    jp, jb = jm.functional_state()
    tp, tb = tm.functional_state()
    assert list(tp) == list(jp) and list(tb) == list(jb)
    for k in jp:
        assert isinstance(tp[k], torch.Tensor)
        close(tp[k].detach().numpy(), np.asarray(jp[k]), 0, k)
    r = np.random.RandomState(1)
    new_p = {k: r.randn(*np.shape(v)).astype("f4") for k, v in jp.items()}
    x = r.randn(5, 4).astype("f4")
    own = {k: v.detach().clone() for k, v in tp.items()}
    own_ids = {k: id(v) for k, v in tp.items()}
    bufs = {k: v.clone() for k, v in tb.items()}
    jo, jnb = jm.functional_call({k: jax.numpy.asarray(v)
                                  for k, v in new_p.items()}, jb,
                                 jax.numpy.asarray(x))
    to, tnb = tm.functional_call({k: torch.from_numpy(v)
                                  for k, v in new_p.items()}, tb,
                                 torch.from_numpy(x))
    close(to.numpy(), jo.numpy(), 1e-5, "functional_call output")
    assert list(tnb) == list(jnb)
    for k in jnb:
        close(tnb[k].numpy(), np.asarray(jnb[k]), 1e-5, f"new buffer {k}")
    # the running statistics moved, in the copies only
    assert not np.allclose(tnb["bn._mean"].numpy(), bufs["bn._mean"].numpy())
    for k, v in tb.items():
        np.testing.assert_array_equal(v.numpy(), bufs[k].numpy())
    # the layer's own state is back: the same objects, the same values
    tp2, _ = tm.functional_state()
    for k, v in tp2.items():
        assert id(v) == own_ids[k] and tm._pt_params is not None
        np.testing.assert_array_equal(v.detach().numpy(), own[k].numpy())
    assert tm.fc1._parameters["weight"] is tm.fc1.weight._data
    # a second method, with a keyword and a non-tensor input
    jo, _ = jm.functional_call(jp, jb, jax.numpy.asarray(x),
                               method="double", k=3.0)
    to, _ = tm.functional_call(tp, tb, x, method="double", k=3.0)
    close(to.numpy(), jo.numpy(), 1e-5, "method='double'")


def test_gradients_through_functional_call_match_jax_grad():
    jm, tm = small_pair()
    jm.eval()
    tm.eval()
    jp, jb = jm.functional_state()
    tp, tb = tm.functional_state()
    x = np.random.RandomState(2).randn(5, 4).astype("f4")
    w = np.random.RandomState(3).randn(5, 3).astype("f4")

    def jloss(p):
        out, _ = jm.functional_call(p, jb, jax.numpy.asarray(x))
        return jax.numpy.sum(out._data * w)
    jg = jax.grad(jloss)(dict(jp))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    out, _ = tm.functional_call(leaves, tb, torch.from_numpy(x))
    (out._data * torch.from_numpy(w)).sum().backward()
    for k, g in jg.items():
        g = np.asarray(g)
        scale = max(1.0, float(np.abs(g).max()))
        assert float(np.abs(leaves[k].grad.numpy() - g).max()) <= \
            1e-4 * scale, k
    # the layer's own leaves took no gradient
    assert all(p.grad is None for p in tm.parameters())


def test_use_state_swaps_and_restores_on_an_exception():
    jm, tm = small_pair()
    jm.eval()
    tm.eval()
    jp, jb = jm.functional_state()
    tp, tb = tm.functional_state()
    zeros = {k: np.zeros(np.shape(v), "f4") for k, v in jp.items()}
    x = np.random.RandomState(4).randn(3, 4).astype("f4")
    with jm._use_state({k: jax.numpy.asarray(v) for k, v in zeros.items()},
                       None):
        jo = jm(pj.to_tensor(x)).numpy()
    with tm._use_state({k: torch.from_numpy(v) for k, v in zeros.items()},
                       None) as (named_p, named_b):
        assert tm.fc2._parameters["bias"] is named_p["fc2.bias"]._data
        to = tm(pt.to_tensor(x)).numpy()
    close(to, jo, 1e-5, "inside _use_state")
    before = {k: (id(v), v.detach().clone()) for k, v in tp.items()}
    with pytest.raises(ZeroDivisionError):
        with tm._use_state({k: torch.from_numpy(v)
                            for k, v in zeros.items()},
                           {k: v * 0 for k, v in tb.items()}):
            1 / 0
    tp2, tb2 = tm.functional_state()
    for k, v in tp2.items():
        assert id(v) == before[k][0]
        np.testing.assert_array_equal(v.detach().numpy(),
                                      before[k][1].numpy())
        layer, attr = k.rsplit(".", 1)
        assert getattr(tm, layer)._parameters[attr] is v
    for k, v in tb2.items():
        assert v is tb[k]
    close(tm(pt.to_tensor(x)).numpy(), jm(pj.to_tensor(x)).numpy(), 1e-5,
          "after the exception")


def _train(P, model, loss_fn, inputs, labels, d_model, steps=3):
    """`steps` TrainStep calls with AdamW on NoamDecay: the losses, the
    final state dict, and the eval forward on the inputs."""
    sched = P.optimizer.lr.NoamDecay(d_model, 4000)
    opt = P.optimizer.AdamW(learning_rate=sched, beta1=0.9, beta2=0.98,
                            epsilon=1e-9, parameters=model.parameters())
    step = (JTrainStep if P is pj else TrainStep)(model, loss_fn, opt)
    losses = []
    for _ in range(steps):
        losses.append(float(step(inputs, labels)))
        sched.step()
    step.sync()
    assert model.training
    ev = step.eval_fn()(*inputs)
    assert model.training
    return losses, {k: v.numpy().copy()
                    for k, v in model.state_dict().items()}, ev.numpy()


def _trajectories(make, loss, inputs, labels, d_model):
    pj.seed(5)
    jm = make(pj)
    tm = make(pt)
    start = {k: v.numpy().copy() for k, v in jm.state_dict().items()}
    tm.set_state_dict(start)
    res = {}
    for P, m in ((pj, jm), (pt, tm)):
        res[P] = _train(P, m, lambda out, *lab: loss(P, out, *lab),
                        tuple(P.to_tensor(a) for a in inputs),
                        tuple(P.to_tensor(a) for a in labels), d_model)
    (jl, js, je), (tl, ts, te) = res[pj], res[pt]
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    assert tl[-1] < tl[0], tl
    for k, want in js.items():
        close(ts[k], want, 1e-4, f"parameter {k} after {len(tl)} steps")
    dt = np.concatenate([(ts[k] - start[k]).ravel() for k in start])
    dj = np.concatenate([(js[k] - start[k]).ravel() for k in start])
    cos = float(dt @ dj) / float(np.linalg.norm(dt) * np.linalg.norm(dj))
    ratio = float(np.linalg.norm(dt) / np.linalg.norm(dj))
    assert cos > 0.999 and abs(ratio - 1) < 1e-2, (cos, ratio)
    close(te, je, 1e-4, "eval_fn")
    return tl


def test_trainstep_over_the_small_transformer_matches_jax():
    cs = _chip_smoke()
    r = np.random.RandomState(6)
    src = r.randint(0, 64, (2, 256)).astype("int32")
    tgt = r.randint(0, 64, (2, 128)).astype("int32")
    lab = r.randint(0, 64, (2, 128)).astype("int32")
    _trajectories(lambda P: cs.layer_transformer(P, 64, 128, 2, 2, 256, 0.0,
                                                 128),
                  cs.transformer_loss, (src, tgt), (lab,), 128)


def test_trainstep_over_layer_gpt_matches_jax():
    cs = _chip_smoke()
    t_fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    j_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    ids = np.random.RandomState(7).randint(0, 96, (2, 128)).astype("int32")
    fas = {pj: j_fa, pt: t_fa}
    _trajectories(lambda P: cs.layer_gpt(P, fas[P].flash_attention, 96, 128,
                                         2, 2, 128),
                  cs.layer_gpt_loss, (ids,), (ids,), 128)


def test_trainstep_takes_torch_tensors_and_a_layer_on_the_cpu():
    tm = small(pt)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    step = TrainStep(tm, lambda out, y: ((out - y) ** 2).mean(), opt)
    assert not step._graphed and step.graphs == {}
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
    y = torch.zeros(5, 3)
    l0 = step(x, y)
    assert isinstance(l0, pt.Tensor)
    l1 = step(pt.to_tensor(x.numpy()), y)
    assert float(l1) < float(l0)
    assert all(p.grad is None for p in tm.parameters())
