"""The port's `metric` against the JAX package's on the same seeded numpy
inputs: `Accuracy` at top 1 and top (1, 5) with index, one-hot and
[N, 1] labels (`compute`, each `update`'s value, `accumulate` and
`name`), on logits without ties, so the port's `torch.topk` and the JAX
package's host argsort must pick the same classes; `Precision`,
`Recall` and `Auc` over several updates; `accuracy`.

Tolerances: hit masks, counts and precision/recall exactly; accuracies
and the AUC within 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def logits(n, c, seed):
    """[n, c] f32 logits with distinct values in every row (no ties)."""
    rng = np.random.RandomState(seed)
    rows = [rng.permutation(c).astype("f4") + rng.rand(c).astype("f4") * 0.5
            for _ in range(n)]
    return np.stack(rows)


def labels_of(kind, n, c, seed):
    lab = np.random.RandomState(seed).randint(0, c, n)
    if kind == "index":
        return lab.astype("int64")
    if kind == "column":
        return lab.reshape(n, 1).astype("int64")
    return np.eye(c, dtype="f4")[lab]           # one-hot


@pytest.mark.parametrize("topk", [(1,), (1, 5)])
@pytest.mark.parametrize("kind", ["index", "column", "onehot"])
def test_accuracy_against_jax(topk, kind):
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert t.name() == j.name()
    for step in range(3):
        pred = logits(16, 10, 10 + step)
        lab = labels_of(kind, 16, 10, 20 + step)
        jc = j.compute(pj.to_tensor(pred), pj.to_tensor(lab))
        tc = t.compute(pt.to_tensor(pred), pt.to_tensor(lab))
        np.testing.assert_array_equal(tc.numpy(), jc.numpy())
        jv, tv = j.update(jc), t.update(tc)
        np.testing.assert_allclose(tv, jv, atol=TOL)
    np.testing.assert_allclose(t.accumulate(), j.accumulate(), atol=TOL)
    t.reset()
    assert t.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])


def test_accuracy_takes_numpy_and_torch_inputs():
    pred, lab = logits(8, 6, 3), labels_of("index", 8, 6, 4)
    want = jm.Accuracy().compute(pred, lab).numpy()
    for p, lab_ in ((pred, lab), (torch.from_numpy(pred),
                                  torch.from_numpy(lab))):
        np.testing.assert_array_equal(
            tm.Accuracy().compute(p, lab_).numpy(), want)


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall_against_jax(name):
    j, t = getattr(jm, name)(), getattr(tm, name)()
    rng = np.random.RandomState(5)
    for _ in range(3):
        preds = rng.rand(32, 1).astype("f4")
        labs = rng.randint(0, 2, (32, 1)).astype("int64")
        j.update(preds, labs)
        t.update(pt.to_tensor(preds), pt.to_tensor(labs))
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()
    t.reset()
    assert t.accumulate() == 0.0


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_against_jax(two_columns):
    j, t = jm.Auc(), tm.Auc()
    rng = np.random.RandomState(6)
    for _ in range(3):
        p = rng.rand(64).astype("f4")
        preds = np.stack([1 - p, p], 1) if two_columns else p
        labs = rng.randint(0, 2, 64).astype("int64")
        j.update(preds, labs)
        t.update(pt.to_tensor(preds), pt.to_tensor(labs))
    assert abs(t.accumulate() - j.accumulate()) <= TOL
    assert 0.0 < t.accumulate() < 1.0


def test_accuracy_function_against_jax():
    pred, lab = logits(12, 7, 8), labels_of("column", 12, 7, 9)
    for k in (1, 3):
        want = float(jm.accuracy(pj.to_tensor(pred), pj.to_tensor(lab),
                                 k=k).numpy())
        got = float(tm.accuracy(pt.to_tensor(pred), pt.to_tensor(lab),
                                k=k).numpy())
        assert abs(got - want) <= TOL
