"""The port's `nn.Layer` against the JAX package's: registration of
parameters, buffers and sublayers, hooks, train/eval, the containers,
`ParamAttr` reaching the optimizers, `create_parameter`'s Xavier
default, state-dict keys and `set_state_dict` from the JAX package's
numpy arrays, and the port's own contract: `Layer` is a
`torch.nn.Module` whose registry holds the very tensors the port's
`Parameter`s wrap.

Tolerances: f32 values within 1e-5 x max(1, |ref|); gradients and
optimizer trajectories within 1e-4 x max(1, max|ref|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import optimizer as j_opt
from paddle_tpu import regularizer as j_reg
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch import regularizer as t_reg

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


def close(got, want, rtol=FWD_RTOL):
    got = np.asarray(got.numpy() if hasattr(got, "numpy") else got, "f8")
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want, "f8")
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= rtol * np.maximum(1, np.abs(want))).all(), err.max()


def tree(P):
    """The same small tree in either package: a Sequential holding a
    LayerList, a BatchNorm (buffers), a Layer with its own parameter and
    a shared sublayer."""
    nn = P.nn

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(2.0))
            self.proj = nn.Linear(3, 2)

        def forward(self, x):
            return self.proj(x * self.scale)

    shared = nn.Linear(4, 4)
    return nn.Sequential(
        ("stack", nn.LayerList([shared, nn.ReLU(), shared])),
        ("bn", nn.BatchNorm1D(4)),
        ("out", nn.Sequential(nn.Linear(4, 3), Head())))


def run_tree(net, x):
    for layer in net.stack:
        x = layer(x)
    return net.out(net.bn(x))


def test_state_dict_keys_match_jax_and_set_state_dict_takes_jax_numpy():
    jnet, tnet = tree(pj), tree(pt)
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    assert list(jsd) == list(tsd)
    assert [v.shape for v in jsd.values()] == [v.shape for v in tsd.values()]
    assert [n for n, _ in jnet.named_parameters()] == \
        [n for n, _ in tnet.named_parameters()]
    assert [n for n, _ in jnet.named_buffers()] == \
        [n for n, _ in tnet.named_buffers()]
    missing, unexpected = tnet.set_state_dict(
        {k: v.numpy() for k, v in jsd.items()})
    assert missing == [] and unexpected == []
    for k in jsd:
        close(tsd[k], jsd[k])
    x = np.random.RandomState(0).randn(5, 4).astype("f4")
    xj, xt = pj.to_tensor(x), pt.to_tensor(x)
    close(run_tree(tnet, xt), run_tree(jnet, xj))
    # the training-mode forward moved the running statistics in both
    close(tnet.bn._mean, jnet.bn._mean)
    close(tnet.bn._variance, jnet.bn._variance)
    # unknown and missing keys are reported, as the JAX package does
    m, u = tnet.set_state_dict({"nope": np.zeros(1, "f4")})
    m2, u2 = jnet.set_state_dict({"nope": np.zeros(1, "f4")})
    assert (m, u) == (m2, u2)
    with pytest.raises(ValueError, match="shape"):
        tnet.set_state_dict({"bn._mean": np.zeros(3, "f4")})


def test_registration_sublayers_and_the_torch_registry():
    net = tree(pt)
    assert isinstance(net, torch.nn.Module)
    params = net.parameters()
    assert all(isinstance(p, pt.Parameter) for p in params)
    # the shared Linear counts once; torch's registry holds exactly the
    # torch leaves the port's Parameters wrap
    held = {id(tp): tp for _, m in net.named_modules()
            for tp in m._parameters.values()}
    assert len(params) == len(held) == 9
    assert {id(p._data) for p in params} == set(held)
    assert [n for n, _ in net.named_sublayers()] == [
        "stack", "stack.0", "stack.1", "stack.2", "bn", "out", "out.0",
        "out.1", "out.1.proj"]
    assert len(net.sublayers(include_self=True)) == 10
    assert net.stack[-1] is net.stack[0] and len(net.stack) == 3
    assert len(net.parameters(include_sublayers=False)) == 0
    # torch's registry holds the buffers the port's Tensors wrap
    assert net.bn._mean._data is net.bn._buffers["_mean"]
    # set_value and an in-place write are seen by both
    w = net.out[0].weight
    w.set_value(np.full((4, 3), 0.25, "f4"))
    assert float(net.out[0]._parameters["weight"].sum()) == 3.0
    # reassigning a parameter name to a plain value unregisters it
    head = net.out[1]
    head.scale = None
    assert "scale" not in dict(head.named_parameters())
    assert "scale" not in head._parameters and head.scale is None
    head.scale = pt.Parameter(np.ones(3, "f4"))
    assert "scale" in dict(head.named_parameters())
    del head.scale
    assert "scale" not in head._parameters
    with pytest.raises(AttributeError):
        head.scale
    # add_sublayer / add_parameter / register_buffer
    extra = pt.nn.Layer()
    extra.add_sublayer("lin", pt.nn.Linear(2, 2))
    extra.add_parameter("p", pt.Parameter(np.zeros(2, "f4")))
    extra.register_buffer("buf", pt.to_tensor([1.0, 2.0]))
    extra.register_buffer("tmp", pt.to_tensor([3.0]), persistable=False)
    assert list(extra.state_dict()) == ["p", "lin.weight", "lin.bias", "buf"]
    assert [n for n, _ in extra.named_buffers()] == ["buf", "tmp"]
    extra.buf = pt.to_tensor([5.0, 6.0])
    assert extra._buffers["buf"] is extra.buf._data
    # a torch Parameter assigned to a Layer is wrapped, not copied
    tp = torch.nn.Parameter(torch.ones(2))
    extra.q = tp
    assert isinstance(extra.q, pt.Parameter) and extra.q._data is tp
    # the functional methods see the same registry: torch leaves under
    # the JAX package's names, swapped in and put back
    params, buffers = extra.functional_state()
    assert list(params) == ["p", "q", "lin.weight", "lin.bias"]
    assert params["q"] is tp and params["p"] is extra.p._data
    assert list(buffers) == ["buf", "tmp"]
    with extra._use_state({"p": torch.ones(2)}, None):
        assert float(extra.p.sum()) == 2.0
        assert float(extra._parameters["p"].sum()) == 2.0
    assert extra.p._data is params["p"] and float(extra.p.sum()) == 0.0
    assert extra._parameters["p"] is params["p"]


def test_train_eval_apply_hooks_and_containers():
    for P in (pt, pj):
        net = tree(P)
        assert net.training and net.stack[0].training
        net.eval()
        assert not any(layer.training
                       for layer in net.sublayers(include_self=True))
        net.train()
        assert all(layer.training
                   for layer in net.sublayers(include_self=True))
        order = []
        net.apply(lambda layer: order.append(type(layer).__name__))
        assert order[0] == "Sequential" and order[1] == "LayerList"
        lin = P.nn.Linear(2, 2)
        calls = []
        pre = lin.register_forward_pre_hook(
            lambda layer, inp: (inp[0] * 2,))
        post = lin.register_forward_post_hook(
            lambda layer, inp, out: calls.append(out.shape) or out * 0)
        x = P.to_tensor(np.ones((1, 2), "f4"))
        assert float(lin(x).sum()) == 0.0 and calls == [[1, 2]]
        pre.remove()
        post.remove()
        want = P.matmul(x, lin.weight) + lin.bias
        close(lin(x), want)
        ll = P.nn.LayerList([P.nn.ReLU()])
        ll.append(P.nn.Tanh())
        ll.insert(0, P.nn.Sigmoid())
        ll.extend([P.nn.Identity()])
        assert [type(m).__name__ for m in ll] == [
            "Sigmoid", "ReLU", "Tanh", "Identity"]
        assert type(ll[1:3][0]).__name__ == "ReLU"
        seq = P.nn.Sequential(P.nn.Linear(2, 3), P.nn.ReLU())
        assert len(seq) == 2 and type(seq[1]).__name__ == "ReLU"
        plist = P.nn.ParameterList([P.create_parameter([2], "float32")])
        plist.append(P.create_parameter([3], "float32"))
        assert len(plist) == 2 and plist[1].shape == [3]
        assert len(plist.parameters()) == 2
    assert "Linear(in_features=4, out_features=3)" in repr(tree(pt))


def test_param_attr_reaches_the_optimizer_like_jax():
    """trainable=False freezes, learning_rate scales and regularizer adds
    its term, in the port's optimizer as in the JAX package's eager
    step."""
    r = np.random.RandomState(1)
    x = r.randn(6, 4).astype("f4")
    start = {"weight": r.randn(4, 3).astype("f4"), "bias": np.ones(3, "f4")}
    out = {}
    for P, opt_mod, reg in ((pt, t_opt, t_reg), (pj, j_opt, j_reg)):
        nn = P.nn
        lin = nn.Linear(4, 3, weight_attr=nn.ParamAttr(
            learning_rate=0.5, regularizer=reg.L2Decay(0.1)),
            bias_attr=nn.ParamAttr(trainable=False))
        lin.set_state_dict(start)
        assert lin.bias.stop_gradient and not lin.weight.stop_gradient
        opt = opt_mod.SGD(learning_rate=0.1, parameters=lin.parameters())
        for _ in range(3):
            loss = (lin(P.to_tensor(x)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        out[P] = {k: v.numpy() for k, v in lin.state_dict().items()}
    for k in out[pj]:
        close(out[pt][k], out[pj][k], GRAD_RTOL)
    np.testing.assert_array_equal(out[pt]["bias"], start["bias"])
    assert not np.allclose(out[pt]["weight"], start["weight"])
    # the attributes the optimizer reads
    w = pt.nn.Linear(2, 2, weight_attr=pt.nn.ParamAttr(
        name="w0", learning_rate=0.25)).weight
    assert w.name == "w0" and w.learning_rate == 0.25
    assert pt.nn.Linear(2, 2, bias_attr=False).bias is None


def test_create_parameter_defaults_to_xavier_normal():
    """pt.create_parameter and Layer.create_parameter draw Xavier-normal
    (std sqrt(2 / (fan_in + fan_out))) unless told otherwise, as the JAX
    package's do; a bias is zeros."""
    pt.seed(3)
    p = pt.create_parameter([256, 128], "float32")
    std = np.sqrt(2.0 / (256 + 128))
    a = p.numpy()
    n = a.size
    assert abs(a.mean()) < 4 * std / np.sqrt(n)
    assert abs(a.std() - std) < 4 * std / np.sqrt(2 * n)
    layer_p = pt.nn.Layer().create_parameter([256, 128])
    assert abs(layer_p.numpy().std() - std) < 4 * std / np.sqrt(2 * n)
    assert not pt.create_parameter([4], "float32", is_bias=True).numpy().any()
    pt.seed(3)
    np.testing.assert_array_equal(pt.create_parameter([256, 128],
                                                      "float32").numpy(), a)
    assert p.place == pt.CPUPlace()


def test_to_and_torch_casts_keep_the_wrappers_bound():
    net = tree(pt)
    net.to(dtype="bfloat16")
    held = {id(tp) for _, m in net.named_modules()
            for tp in m._parameters.values()}
    for name, p in net.named_parameters():
        assert p.dtype == torch.bfloat16, name
        assert id(p._data) in held, name
    assert net.bn._mean.dtype == torch.bfloat16
    assert net.bn._mean._data is net.bn._buffers["_mean"]
    net.float()              # torch's cast, through Layer._apply
    assert net.bn._variance.dtype == torch.float32
    assert net.bn._variance._data is net.bn._buffers["_variance"]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    net.to("cpu")
    assert net.out[0].weight.place == pt.CPUPlace()


def test_layers_are_made_on_the_current_place_and_never_fall_back(
        monkeypatch):
    """With the default place (the card) and no card, building a layer
    raises; asked for the CPU, its parameters and buffers live there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt.set_device("gpu")
    for make in (lambda: pt.nn.Linear(2, 2), lambda: pt.nn.BatchNorm1D(3),
                 lambda: pt.create_parameter([2], "float32")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    pt.set_device("cpu")
    bn = pt.nn.BatchNorm1D(3)
    assert all(t.place == pt.CPUPlace()
               for t in bn.state_dict().values())
