"""The port's Tensor surface against the JAX package's: `to_tensor` and
its dtype rule (int64 -> int32, float64 -> the default dtype), the
properties, `numpy`/`item`, the in-place methods (`set_value`,
`__setitem__` on leaves and non-leaves), operators with Python scalars,
indexing, places, and the error when no card is present and the CPU was
not chosen.

Tolerances: f32 values within 1e-5 x max(1, |ref|); gradients within
1e-4 x max(1, max|g|); integers, booleans and dtypes exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def name(dtype):
    return str(dtype).replace("torch.", "")


def same(t, j):
    """Port Tensor t equals JAX Tensor (or array) j: dtype, shape, values."""
    ja = np.asarray(j.numpy() if hasattr(j, "numpy") else j)
    assert name(t.dtype) == str(ja.dtype), (t.dtype, ja.dtype)
    ta = t.numpy()
    assert ta.shape == ja.shape
    if ja.dtype.kind in "biu":
        np.testing.assert_array_equal(ta, ja)
    else:
        err = np.abs(ta.astype("c16") - ja.astype("c16"))
        assert (err <= FWD_RTOL * np.maximum(1, np.abs(ja))).all()


@pytest.mark.parametrize("data,dtype", [
    ([1, 2, 3], None), ([1.5, 2.0], None), ([[True, False]], None),
    (np.arange(4, dtype=np.int64), None), (np.ones(3, np.float64), None),
    (np.ones(3, np.float16), None), ([1 + 2j], None), (3, None), (2.5, None),
    ([1, 2], "float32"), ([1.7, -2.2], "int64"), ([1, 0], "bool"),
    (np.ones((2, 3), np.float32), "float64"), ([0.5], "bfloat16"),
])
def test_to_tensor_dtype_rule_matches_jax(data, dtype):
    same(pt.to_tensor(data, dtype=dtype), pj.to_tensor(data, dtype=dtype))


def test_default_dtype_and_creation_dtypes():
    for f in ("arange", "argmax"):
        j = getattr(pj, f)(pj.to_tensor([3.0, 1.0, 2.0])) if f == "argmax" \
            else pj.arange(4)
        t = getattr(pt, f)(pt.to_tensor([3.0, 1.0, 2.0])) if f == "argmax" \
            else pt.arange(4)
        same(t, j)
    same(pt.arange(0.0, 1.0, 0.25), pj.arange(0.0, 1.0, 0.25))
    same(pt.zeros([2, 3], "int64"), pj.zeros([2, 3], "int64"))
    same(pt.full([2], 7, "int32"), pj.full([2], 7, "int32"))
    same(pt.eye(3, 4), pj.eye(3, 4))
    same(pt.linspace(0, 1, 5), pj.linspace(0, 1, 5))
    same(pt.diag(pt.to_tensor([1.0, 2.0]), offset=1, padding_value=-1),
         pj.diag(pj.to_tensor([1.0, 2.0]), offset=1, padding_value=-1))
    old = pt.get_default_dtype()
    try:
        pt.set_default_dtype("float16")
        assert pt.to_tensor([1.5]).dtype == torch.float16
        assert pt.zeros([1]).dtype == torch.float16
    finally:
        pt.set_default_dtype(old)


def test_properties_numpy_item_and_conversions():
    a = np.arange(6, dtype="f4").reshape(2, 3)
    t, j = pt.to_tensor(a), pj.to_tensor(a)
    assert t.shape == j.shape == [2, 3]
    assert (t.ndim, t.size, t.numel(), t.dim(), len(t)) == \
        (j.ndim, j.size, j.numel(), j.dim(), len(j))
    assert t.stop_gradient and t.is_leaf and t.grad is None
    assert t.item(1, 2) == j.item(1, 2) == 5.0
    assert pt.to_tensor(3).item() == pj.to_tensor(3).item() == 3
    assert t.tolist() == j.tolist()
    assert float(pt.to_tensor(2.5)) == 2.5 and int(pt.to_tensor(4)) == 4
    same(t.T, j.T)
    same(t.astype("int32"), j.astype("int32"))
    # numpy() of a CPU tensor is a read-only view, as JAX's asarray is
    with pytest.raises(ValueError):
        t.numpy()[0, 0] = 1.0
    # bf16 comes back as float32 (no ml_dtypes on the card's machine)
    b = pt.to_tensor([1.0, 2.5], dtype="bfloat16")
    assert b.dtype == torch.bfloat16 and b.numpy().dtype == np.float32
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(pj.to_tensor([1.0, 2.5], dtype="bfloat16")
                              .numpy(), dtype=np.float32))
    # to_tensor copies: the source is not aliased
    src = np.ones(3, "f4")
    c = pt.to_tensor(src)
    src[0] = 9
    assert c.numpy()[0] == 1.0
    d = pt.to_tensor(c)
    d.fill_(5.0)
    assert c.numpy()[0] == 1.0


def test_set_value_and_in_place_methods_match_jax():
    a = np.arange(6, dtype="f4").reshape(2, 3)
    for mk in (lambda P: P.to_tensor(a), lambda P: P.to_tensor(
            a, stop_gradient=False), lambda P: P.Parameter(a)):
        t, j = mk(pt), mk(pj)
        t_data = t._data
        for f in (lambda x: x.set_value(np.ones((2, 3), "f4") * 2),
                  lambda x: x.scale_(3.0), lambda x: x.add_(1.0),
                  lambda x: x.add_(x), lambda x: x.fill_(0.5),
                  lambda x: x.zero_(), lambda x: x.copy_(a)):
            f(t)
            f(j)
            same(t, j)
        if not t.stop_gradient:
            assert t._data is t_data     # a trainable leaf keeps its storage
            assert not t.stop_gradient and t.is_leaf
    with pytest.raises(ValueError, match="shape mismatch"):
        pt.to_tensor(a).set_value(np.ones(3))


def test_setitem_on_leaves_matches_jax():
    a = np.arange(12, dtype="f4").reshape(3, 4)
    for sg in (True, False):
        t, j = pt.to_tensor(a, stop_gradient=sg), \
            pj.to_tensor(a, stop_gradient=sg)
        for idx, val in (((0, 1), 7.0), ((slice(None), 2), -1.0),
                         ((1, slice(None, None, -2)), 5.0),
                         (np.array([0, 2]), np.full(4, 3.0, "f4"))):
            t[idx] = val
            j[idx] = val
            same(t, j)
        t[pt.to_tensor([1])] = pt.to_tensor(np.zeros((1, 4), "f4"))
        j[pj.to_tensor([1])] = pj.to_tensor(np.zeros((1, 4), "f4"))
        same(t, j)
    # a write into a view's tensor leaves its source alone
    base = pt.to_tensor(a)
    view = base[0]
    view[0] = 100.0
    assert base.numpy()[0, 0] == 0.0


def test_setitem_on_a_non_leaf_keeps_the_old_gradient_like_jax():
    """JAX rebinds `_data` and keeps the node: the written entries take
    the new value, and the gradient flows as if nothing was written."""
    a = np.arange(1, 7, dtype="f4").reshape(2, 3)
    out = {}
    for P in (pt, pj):
        x = P.to_tensor(a, stop_gradient=False)
        y = x * x
        y[0, 1] = 100.0
        y.scale_(2.0)
        loss = (y * P.to_tensor(a)).sum()
        loss.backward()
        out[P] = (y.numpy(), loss.numpy(), x.grad.numpy(), y.stop_gradient)
    for want, got in zip(out[pj], out[pt]):
        np.testing.assert_allclose(got, want, rtol=FWD_RTOL)


def test_operators_with_python_scalars_and_tensors():
    a = np.array([[1.5, -2.0], [0.25, 3.0]], "f4")
    i = np.array([[3, -4], [7, 2]], "int32")
    for f in (lambda P, x, k: x + 2, lambda P, x, k: 2.5 - x,
              lambda P, x, k: x * 3, lambda P, x, k: 1 / (x + 5),
              lambda P, x, k: x ** 2, lambda P, x, k: 2 ** x,
              lambda P, x, k: -x, lambda P, x, k: abs(x),
              lambda P, x, k: x @ x, lambda P, x, k: (x > 0.5),
              lambda P, x, k: x == x, lambda P, x, k: x != 1.5,
              lambda P, x, k: k // 3, lambda P, x, k: k % 3,
              lambda P, x, k: k + 1.5, lambda P, x, k: k / k,
              lambda P, x, k: k * 2, lambda P, x, k: (k & 6) | 1,
              lambda P, x, k: ~(k > 0), lambda P, x, k: P.maximum(x, 0.0),
              lambda P, x, k: x.sum(axis=1), lambda P, x, k: x.mean(),
              lambda P, x, k: x.reshape([4]).transpose([0]),
              lambda P, x, k: x.astype("int32").sum(),
              lambda P, x, k: (k > 0).sum(), lambda P, x, k: x.clip(0, 1),
              lambda P, x, k: x.norm(), lambda P, x, k: x.max(axis=0)):
        same(f(pt, pt.to_tensor(a), pt.to_tensor(i)),
             f(pj, pj.to_tensor(a), pj.to_tensor(i)))


def test_advanced_indexing_and_gradients_match_jax():
    a = np.arange(24, dtype="f4").reshape(2, 3, 4)
    w = np.random.RandomState(0).uniform(-1, 1, a.shape).astype("f4")
    for idx in ((1, slice(None), [0, 3]), ([1, 0], [2, 1]),
                (Ellipsis, slice(None, None, -1)), (slice(None), None, 1),
                (np.array([True, False]),)):
        res = {}
        for P in (pt, pj):
            x = P.to_tensor(a, stop_gradient=False)
            y = x[idx]
            (y.astype("float32").sum() * 2).backward()
            res[P] = (y, x.grad)
        same(res[pt][0], res[pj][0])
        same(res[pt][1], res[pj][1])
    t, j = pt.to_tensor(a), pj.to_tensor(a)
    same(t[pt.to_tensor([1, 0])], j[pj.to_tensor([1, 0])])
    same(t[t > 20.0], pj.masked_select(j, j > 20.0))
    assert [x.shape for x in pt.to_tensor(w)] == [[3, 4], [3, 4]]


def test_places_and_moves():
    t = pt.to_tensor([1.0, 2.0])
    assert t.place == pt.CPUPlace() and t.place.is_cpu_place()
    assert pt.get_device() == "cpu:0"
    assert pt.CUDAPlace(1) == pt.framework.state.parse_place("gpu:1")
    assert pt.TPUPlace(0) == pt.CUDAPlace(0)
    assert t.cpu().place == pt.CPUPlace()
    x = pt.to_tensor([1.0], stop_gradient=False)
    assert not x.cpu().stop_gradient       # a move keeps the graph
    with pytest.raises(ValueError):
        pt.set_device("mlu")


def test_default_place_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt.set_device("gpu")
    assert pt.get_device() == "gpu:0"
    for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                 lambda: pt.Parameter(np.ones(2, "f4")),
                 lambda: pt.arange(3), lambda: pt.randn([2])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    pt.set_device("cpu")
    assert pt.to_tensor([1.0]).place == pt.CPUPlace()


def test_no_host_fallback_and_complex_ops_stay_put():
    from paddle_tpu_torch.ops import dispatch
    assert not hasattr(dispatch, "HOST_FALLBACK_OPS")
    assert not hasattr(dispatch, "_host_fallback")
    c = pt.complex(pt.to_tensor([1.0, 2.0]), pt.to_tensor([0.5, -1.0]))
    assert c.dtype == torch.complex64 and c.place == pt.CPUPlace()
    same(pt.as_real(c), pj.as_real(pj.complex(pj.to_tensor([1.0, 2.0]),
                                              pj.to_tensor([0.5, -1.0]))))


def test_repr_and_parameter():
    p = pt.Parameter(np.ones((2, 2), "f4"), name="w")
    assert isinstance(p._data, torch.nn.Parameter) and p.persistable
    assert not p.stop_gradient and p.trainable and p.name == "w"
    assert "Parameter containing" in repr(p)
    frozen = pt.Parameter(np.ones(2, "f4"), trainable=False)
    assert frozen.stop_gradient
    assert "stop_gradient=False" in repr(pt.to_tensor([1.0],
                                                      stop_gradient=False))
    # integer tensors record stop_gradient=False without requiring grad
    i = pt.to_tensor([1, 2], stop_gradient=False)
    assert not i.stop_gradient and not i._data.requires_grad
