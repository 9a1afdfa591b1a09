"""Where the two packages' `nn` semantics part from torch's defaults, the
port keeps the JAX package's: Linear's [in, out] weight, BatchNorm's
running statistics (Paddle's momentum, the biased variance),
cross_entropy's mean over max(#valid, 1) and its label forms,
interpolate's align_mode=1 and cubic coordinates, Embedding's
padding_idx, ctc_loss's reduction; and the draws (dropout,
alpha_dropout, gumbel_softmax) by their statistics, p = 0,
training=False and their replay under `paddle.seed`. Also the row-sparse
gradient of `F.embedding(sparse=True)` and the absence of an environment
switch for layer_norm.

Tolerances: f32 values within 1e-5 x max(1, |ref|); gradients within
1e-4 x max(1, max|g|); the draws' statistics within 4 standard errors.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework.selected_rows import SelectedRows

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
TF, JF = pt.nn.functional, pj.nn.functional


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def close(got, want, rtol=FWD_RTOL):
    got = np.asarray(got.numpy() if hasattr(got, "numpy") else got, "f8")
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want, "f8")
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= rtol * np.maximum(1, np.abs(want))).all(), err.max()


def u(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("f4")


def test_linear_weight_is_in_by_out():
    lin = pt.nn.Linear(4, 3)
    assert lin.weight.shape == [4, 3] and lin.bias.shape == [3]
    x = u((2, 4))
    w = lin.weight._data.detach()
    close(lin(pt.to_tensor(x)),
          x @ w.numpy() + lin.bias.numpy())
    # the same weight in torch's layout is its transpose
    close(lin(pt.to_tensor(x)), torch.nn.functional.linear(
        torch.from_numpy(x), w.t().contiguous(), lin.bias._data.detach()))
    assert pj.nn.Linear(4, 3).weight.shape == [4, 3]


def test_batch_norm_running_statistics_are_paddle_s():
    x = u((8, 3, 4, 4), 1, 0.0, 3.0)
    out = {}
    for P in (pt, pj):
        bn = P.nn.BatchNorm2D(3, momentum=0.8)
        for step in range(2):
            bn(P.to_tensor(x * (step + 1)))
        out[P] = (bn._mean.numpy().copy(), bn._variance.numpy().copy())
    close(out[pt][0], out[pj][0])
    close(out[pt][1], out[pj][1])
    rm, rv = np.zeros(3), np.ones(3)
    for step in range(2):
        xs = (x * (step + 1)).astype("f8")
        rm = 0.8 * rm + 0.2 * xs.mean(axis=(0, 2, 3))
        rv = 0.8 * rv + 0.2 * xs.var(axis=(0, 2, 3))      # biased
    close(out[pt][0], rm)
    close(out[pt][1], rv)
    # torch's own convention would give another variance
    trm, trv = torch.zeros(3), torch.ones(3)
    torch.nn.functional.batch_norm(torch.from_numpy(x), trm, trv,
                                   training=True, momentum=0.2)
    assert not np.allclose(trv.numpy(), 0.8 + 0.2 * x.var(axis=(0, 2, 3)),
                           rtol=1e-6)
    # eval mode reads them and leaves them alone
    bn = pt.nn.BatchNorm2D(3)
    bn.eval()
    y = bn(pt.to_tensor(x))
    close(y, x / np.sqrt(1 + 1e-5))
    np.testing.assert_array_equal(bn._mean.numpy(), np.zeros(3, "f4"))


def test_cross_entropy_mean_over_valid_rows_and_label_forms():
    logits = u((4, 5), 2, -2, 2)
    lab = np.array([1, -100, 3, -100], "int32")
    for P, F in ((pt, TF), (pj, JF)):
        all_ignored = F.cross_entropy(P.to_tensor(logits),
                                      P.to_tensor(np.full(4, -100, "int32")))
        assert float(all_ignored) == 0.0, P.__name__
    assert math.isnan(float(torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.full((4,), -100))))
    got = TF.cross_entropy(pt.to_tensor(logits), pt.to_tensor(lab))
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    close(got, -(logp[0, 1] + logp[2, 3]) / 2)
    close(TF.cross_entropy(pt.to_tensor(logits), pt.to_tensor(lab[:, None])),
          got)
    soft = np.random.RandomState(3).dirichlet(np.ones(5), 4).astype("f4")
    for kw in (dict(soft_label=True), dict(use_softmax=False)):
        arg = soft if "soft_label" in kw else lab
        src = logits if "soft_label" in kw else soft
        close(TF.cross_entropy(pt.to_tensor(src), pt.to_tensor(arg), **kw),
              JF.cross_entropy(pj.to_tensor(src), pj.to_tensor(arg), **kw))


def test_interpolate_align_mode_1_and_cubic_are_the_jax_package_s():
    x = u((1, 1, 3, 4), 4)
    # align_mode 1: src = i * in / out (no torch mode computes it)
    got = TF.interpolate(pt.to_tensor(x), size=[3, 6], mode="bilinear",
                         align_mode=1).numpy()
    src = np.arange(6) * 4 / 6
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, 3)
    w = src - lo
    close(got, x[..., lo] * (1 - w) + x[..., hi] * w)
    close(got, JF.interpolate(pj.to_tensor(x), size=[3, 6], mode="bilinear",
                              align_mode=1))
    for ac in (False, True):
        close(TF.interpolate(pt.to_tensor(x), size=[5, 7], mode="bicubic",
                             align_corners=ac),
              JF.interpolate(pj.to_tensor(x), size=[5, 7], mode="bicubic",
                             align_corners=ac))


def test_embedding_padding_idx():
    for P in (pt, pj):
        emb = P.nn.Embedding(5, 3, padding_idx=-1)
        assert not emb.weight.numpy()[4].any(), P.__name__
        emb.weight.set_value(np.ones((5, 3), "f4"))
        ids = P.to_tensor(np.array([[4, 1, 4]], "int32"))
        out = emb(ids)
        np.testing.assert_array_equal(out.numpy()[0, [0, 2]], 0.0)
        np.testing.assert_array_equal(out.numpy()[0, 1], 1.0)
        out.sum().backward()
        g = emb.weight.grad.numpy()
        np.testing.assert_array_equal(g[4], 0.0)
        np.testing.assert_array_equal(g[1], 1.0)


def test_ctc_loss_reductions_are_the_jax_package_s():
    lp = u((7, 3, 5), 5)
    lab = np.array([[1, 2, 2], [4, 3, 0], [1, 0, 0]], "int32")
    il, ll = np.array([7, 6, 4], "int32"), np.array([3, 2, 1], "int32")
    for red in ("mean", "sum", "none"):
        for nbt in (False, True):
            args = [(lp, lab, il, ll)]
            t = TF.ctc_loss(*[pt.to_tensor(a) for a in args[0]],
                            reduction=red, norm_by_times=nbt)
            j = JF.ctc_loss(*[pj.to_tensor(a) for a in args[0]],
                            reduction=red, norm_by_times=nbt)
            close(t, j)
    # the mean divides each sample's loss by its label length, then
    # averages
    per = TF.ctc_loss(*[pt.to_tensor(a) for a in (lp, lab, il, ll)],
                      reduction="none").numpy()
    close(TF.ctc_loss(*[pt.to_tensor(a) for a in (lp, lab, il, ll)]),
          (per / ll).mean())


def test_dropout_draws():
    x = pt.to_tensor(np.ones((200, 100), "f4"))
    assert TF.dropout(x, p=0.0) is x
    assert TF.dropout(x, p=0.7, training=False) is x
    pt.seed(7)
    a = TF.dropout(x, p=0.3).numpy().copy()
    pt.seed(7)
    np.testing.assert_array_equal(TF.dropout(x, p=0.3).numpy(), a)
    kept = a != 0
    np.testing.assert_allclose(a[kept], 1 / 0.7, rtol=1e-6)
    n = a.size
    assert abs(kept.mean() - 0.7) <= 4 * math.sqrt(0.21 / n)
    rows = TF.dropout(x, p=0.5, axis=[0]).numpy()
    assert ((rows == 0).all(1) | (rows != 0).all(1)).all()
    down = TF.dropout(x, p=0.3, mode="downscale_in_infer").numpy()
    assert set(np.unique(down)) <= {0.0, 1.0}
    ch = TF.dropout2d(pt.to_tensor(np.ones((4, 50, 3, 3), "f4")), 0.5)
    per_channel = ch.numpy().reshape(4, 50, 9)
    assert ((per_channel == 0).all(2) | (per_channel != 0).all(2)).all()
    # alpha dropout keeps a unit-normal input's moments
    z = pt.to_tensor(np.random.RandomState(0).randn(400, 100).astype("f4"))
    az = TF.alpha_dropout(z, p=0.2).numpy()
    assert abs(az.mean()) < 4 / math.sqrt(az.size) * 2
    assert abs(az.std() - 1) < 0.05
    assert TF.alpha_dropout(z, p=0.2, training=False) is z
    g = TF.gumbel_softmax(pt.to_tensor(u((6, 5))), temperature=0.5)
    np.testing.assert_allclose(g.numpy().sum(-1), 1, rtol=1e-5)
    # hard: one-hot forward (onehot + y - y held, as the JAX package
    # writes it: 1 within an ulp)
    h = TF.gumbel_softmax(pt.to_tensor(u((6, 5))), hard=True).numpy()
    np.testing.assert_allclose(h.sum(-1), 1, rtol=1e-6)
    assert ((np.abs(h) < 1e-6) | (np.abs(h - 1) < 1e-6)).all()
    # the draws land where the input is
    layer = pt.nn.Dropout(0.5)
    layer.eval()
    assert layer(x) is x


def test_sparse_embedding_gradient_is_selected_rows():
    w = pt.Parameter(u((6, 3)))
    ids = pt.to_tensor(np.array([[1, 4, 1], [5, 4, 0]], "int32"))
    out = TF.embedding(ids, w, sparse=True)
    cot = u((2, 3, 3), 1)
    (out * pt.to_tensor(cot)).sum().backward()
    g = w.grad
    assert isinstance(g, SelectedRows) and g.height == 6
    dense = np.zeros((6, 3), "f4")
    np.add.at(dense, ids.numpy().ravel(), cot.reshape(-1, 3))
    close(g.to_dense().numpy(), dense)
    # a second backward accumulates rows
    (TF.embedding(ids, w, sparse=True) * pt.to_tensor(cot)).sum().backward()
    close(w.grad.to_dense().numpy(), 2 * dense)
    # a non-leaf table takes the dense gradient
    w2 = pt.Parameter(u((6, 3)))
    (TF.embedding(ids, w2 * 1.0, sparse=True) * pt.to_tensor(cot)).sum() \
        .backward()
    close(w2.grad, dense)
    # JAX's sparse gradient names the same rows
    jw = pj.Parameter(u((6, 3)))
    (JF.embedding(pj.to_tensor(ids.numpy()), jw, sparse=True)
     * pj.to_tensor(cot)).sum().backward()
    close(np.asarray(jw.grad.to_dense()), dense)


def test_layer_norm_takes_no_environment_switch(monkeypatch):
    x = pt.to_tensor(u((4, 16), 6, -2.0, 3.0))
    w, b = pt.to_tensor(u((16,), 7)), pt.to_tensor(u((16,), 8))
    before = TF.layer_norm(x, 16, w, b).numpy().copy()
    monkeypatch.setenv("PT_LN_SINGLE_PASS", "1")
    np.testing.assert_array_equal(TF.layer_norm(x, 16, w, b).numpy(), before)
    close(before, JF.layer_norm(pj.to_tensor(x.numpy()), 16,
                                pj.to_tensor(w.numpy()),
                                pj.to_tensor(b.numpy())))
