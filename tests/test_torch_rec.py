"""The port's recommendation models (`rec/`) against the JAX package's
on the CPU.

WideDeep and DeepFM (with and without dense features) from the same
seeded weights (the JAX model's state dict through `set_state_dict`):
the state-dict keys and shapes, the logits, `ctr_loss` and the gradient
of every parameter; then 5 Adam steps of each package's `jit.TrainStep`
from those weights on the same seeded batches: the losses and every
parameter after them. `tests/test_rec_models.py`'s convergence check on
the port, and `wide_deep_sparse_loss`'s refusal (the parameter server
is ROADMAP Queue 1 item 5).

Tolerances (f32): logits and losses within 1e-5 x max(1, |ref|),
gradients within 1e-4 x max(1, max|g|); the Adam trajectory's losses
within 1e-5 relative and every parameter within 1e-4 x max(1, |ref|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB, FIELDS, EMB = 97, 5, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


# (class name, dense features, MLP widths)
MODELS = [("WideDeep", 4, (16, 8)), ("DeepFM", 0, (16, 8)),
          ("DeepFM", 3, (12, 12, 6))]


def _build(P, cls, n_dense, hidden):
    kw = dict(vocab_size=VOCAB, emb_dim=EMB, n_fields=FIELDS, hidden=hidden)
    if cls == "WideDeep" or n_dense:
        kw["n_dense"] = n_dense
    return getattr(P.rec, cls)(**kw)


def _batch(seed, n_dense, b=16):
    r = np.random.RandomState(seed)
    ids = r.randint(0, VOCAB, (b, FIELDS)).astype("int32")
    dense = r.randn(b, n_dense).astype("f4") if n_dense else None
    y = (r.rand(b) > 0.5).astype("f4")
    return ids, dense, y


def _inputs(P, ids, dense):
    return (P.to_tensor(ids),) if dense is None else \
        (P.to_tensor(ids), P.to_tensor(dense))


def _pair(cls, n_dense, hidden):
    """The JAX model and the port's from its state dict (the bias moved
    off 0 so its gradient path is exercised)."""
    pj.seed(3)
    jm = _build(pj, cls, n_dense, hidden)
    sd = {k: np.asarray(v.numpy()).copy() for k, v in
          jm.state_dict().items()}
    sd["bias"] = np.array([0.25], "f4")
    jm.set_state_dict(sd)
    tm = _build(pt, cls, n_dense, hidden)
    assert list(tm.state_dict()) == list(sd)
    assert [tuple(v.shape) for v in tm.state_dict().values()] == \
        [v.shape for v in sd.values()]
    assert tm.set_state_dict(sd) == ([], [])
    return jm, tm


def _close(got, want, rtol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want)
    assert (err <= rtol * np.maximum(1.0, np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


@pytest.mark.parametrize("cls,n_dense,hidden", MODELS)
def test_forward_loss_and_every_gradient_match_jax(cls, n_dense, hidden):
    jm, tm = _pair(cls, n_dense, hidden)
    ids, dense, y = _batch(1, n_dense)
    res = {}
    for name, P, m in (("jax", pj, jm), ("port", pt, tm)):
        logits = m(*_inputs(P, ids, dense))
        loss = P.rec.ctr_loss(logits, P.to_tensor(y))
        loss.backward()
        res[name] = (logits.numpy(), loss.numpy(),
                     {k: p.grad.numpy() for k, p in m.named_parameters()})
    _close(res["port"][0], res["jax"][0], 1e-5, "logits")
    _close(res["port"][1], res["jax"][1], 1e-5, "loss")
    assert set(res["port"][2]) == set(res["jax"][2])
    for k, want in res["jax"][2].items():
        got = res["port"][2][k]
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(want).max() > 0, k
        assert np.abs(got - want).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("cls,n_dense,hidden", MODELS)
def test_adam_trainstep_trajectory_matches_jax(cls, n_dense, hidden):
    jm, tm = _pair(cls, n_dense, hidden)
    steps = {}
    for name, P, m, TS in (("jax", pj, jm, JTrainStep),
                           ("port", pt, tm, TrainStep)):
        opt = P.optimizer.Adam(learning_rate=0.01,
                               parameters=m.parameters())
        steps[name] = (P, m, TS(m, P.rec.ctr_loss, opt))
    losses = {"jax": [], "port": []}
    for i in range(5):
        ids, dense, y = _batch(10 + i, n_dense)
        for name, (P, m, step) in steps.items():
            losses[name].append(float(step(_inputs(P, ids, dense),
                                           (P.to_tensor(y),)).numpy()))
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    steps["jax"][2].sync()
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        _close(v.numpy(), want[k], 1e-4, k)


@pytest.mark.parametrize("cls,n_dense", [("WideDeep", 4), ("DeepFM", 0)])
def test_rec_model_converges(cls, n_dense):
    """tests/test_rec_models.py's check on the port: 80 Adam steps of the
    graph-free TrainStep on a planted CTR rule cut the loss by a
    quarter."""
    pt.seed(0)
    rng = np.random.RandomState(0)
    vocab, n_fields = 64, 4
    kw = dict(vocab_size=vocab, emb_dim=8, n_fields=n_fields,
              hidden=(32, 16))
    if n_dense:
        kw["n_dense"] = n_dense
    model = getattr(pt.rec, cls)(**kw)
    opt = pt.optimizer.Adam(learning_rate=0.01,
                            parameters=model.parameters())
    step = TrainStep(model, pt.rec.ctr_loss, opt)
    true_w = rng.normal(0, 1.0, vocab).astype("f4")
    losses = []
    for _ in range(80):
        ids = rng.randint(0, vocab, (64, n_fields))
        dense = rng.randn(64, n_dense).astype("f4") if n_dense else None
        logit = true_w[ids].sum(axis=1)
        if n_dense:
            logit = logit + 0.5 * dense.sum(axis=1)
        y = (logit + 0.3 * rng.randn(64) > 0).astype("f4")
        inputs = (ids, dense) if n_dense else (ids,)
        losses.append(float(step(inputs, (y,)).numpy()))
    assert np.mean(losses[-10:]) < 0.75 * np.mean(losses[:5]), \
        (losses[:5], losses[-10:])


def test_sparse_loss_waits_for_the_parameter_server():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        pt.rec.wide_deep_sparse_loss(4, 8, 2)
    assert set(pt.rec.__all__) == set(pj.rec.__all__)
