"""The port's autograd (torch autograd behind Paddle's `backward`,
`paddle.grad` and `PyLayer`) against the JAX package's tape, case by case
after `tests/test_autograd.py`: a linear chain, accumulation, a diamond,
`stop_gradient`, `detach`, `no_grad`, retained and freed graphs,
multi-output ops, `grad` with `allow_unused` and `no_grad_vars`,
create_graph to second and third order, a gradient-penalty loop through
the optimizer, `PyLayer`, and hooks.

Tolerances: f32 values within 1e-5 x max(1, |ref|); gradients within
1e-4 x max(1, max|g|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu_torch.autograd import PyLayer as TPyLayer

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def close(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got.numpy() if hasattr(got, "numpy") else got), \
        np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got - want).max(initial=0)) <= rtol * scale


def both(fn):
    """fn(P) for both packages -> (port result, JAX result)."""
    return fn(pt), fn(pj)


def test_linear_chain():
    r = np.random.RandomState(0)
    xa, wa = r.randn(4, 3).astype("f4"), r.randn(3, 5).astype("f4")

    def run(P):
        x = P.to_tensor(xa, stop_gradient=False)
        w = P.to_tensor(wa, stop_gradient=False)
        b = P.zeros([5])
        b.stop_gradient = False
        loss = ((P.matmul(x, w) + b) ** 2).mean()
        loss.backward()
        return loss, x.grad, w.grad, b.grad
    t, j = both(run)
    for a, b in zip(t, j):
        close(a, b)


def test_accumulation_and_clear_grad():
    def run(P):
        x = P.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        g = x.grad.numpy().copy()
        x.clear_grad()
        return g, x.grad
    (tg, tn), (jg, jn) = both(run)
    close(tg, jg)
    assert tn is None and jn is None


def test_diamond_stop_gradient_and_detach():
    def run(P):
        a = P.to_tensor([2.0], stop_gradient=False)
        (a * a + a * 3.0).backward()
        b = P.to_tensor([3.0])
        c = P.to_tensor([2.0], stop_gradient=False)
        (c * b).sum().backward()
        d = (c * 2).detach()
        e = P.to_tensor([2.0], stop_gradient=False)
        (e * d).backward()
        f = P.to_tensor([5.0], stop_gradient=False)
        g = f * f
        g.stop_gradient = True           # cuts the lineage of a non-leaf
        (f * 1.0 + g).sum().backward()
        return a.grad, c.grad, b.grad, d.stop_gradient, e.grad, f.grad
    t, j = both(run)
    for k in (0, 1, 4, 5):
        close(t[k], j[k])
    assert t[2] is None and j[2] is None and t[3] and j[3]


def test_no_grad_context_and_decorator():
    def run(P):
        a = P.to_tensor([2.0], stop_gradient=False)
        with P.no_grad():
            y = a * 5
        f = P.no_grad()(lambda v: v * 2)
        return y.stop_gradient, y.is_leaf, f(a).stop_gradient, \
            P.is_grad_enabled()
    t, j = both(run)
    assert t == j == (True, True, True, True)


def test_retain_graph_and_freed_graph():
    def run(P):
        a = P.to_tensor([2.0], stop_gradient=False)
        y = a * a
        y.backward(retain_graph=True)
        y.backward()
        return a.grad
    close(*both(run))
    # a second sweep through a freed graph raises in the port (torch's
    # rule, and Paddle's); the JAX package's is a no-op for the inputs
    for P in (pt, pj):
        a = P.to_tensor([2.0], stop_gradient=False)
        y = (a * a * a).sum()
        y.backward()
        if P is pt:
            with pytest.raises(RuntimeError):
                y.backward()
        else:
            y.backward()
        close(a.grad, [12.0])


def test_non_scalar_backward_needs_grad_tensor():
    def run(P):
        a = P.to_tensor([1.0, 2.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            (a * 2).backward()
        (a * 2).backward(P.to_tensor([1.0, 3.0]))
        return a.grad
    close(*both(run))


def test_multi_output_op():
    def run(P):
        t = P.to_tensor([[1.0, 5.0, 3.0]], stop_gradient=False)
        vals, idxs = P.topk(t, k=2)
        vals.sum().backward()
        return t.grad, idxs.stop_gradient
    (tg, ts), (jg, js) = both(run)
    close(tg, jg)
    assert ts and js


def test_grad_api_allow_unused_and_only_inputs():
    def run(P):
        a = P.to_tensor([3.0], stop_gradient=False)
        g, = P.grad(a * a, a)
        x = P.to_tensor(np.array([3.0], "f4"), stop_gradient=False)
        w = P.to_tensor(np.array([1.0], "f4"), stop_gradient=False)
        gs = P.grad(x, [w], allow_unused=True)
        with pytest.raises(RuntimeError, match="unused"):
            P.grad(x * 2, [w])
        return g, a.grad, gs, x.grad
    (tg, ta, tgs, tx), (jg, ja, jgs, jx) = both(run)
    close(tg, jg)
    assert ta is None and ja is None          # grad() leaves .grad alone
    assert tgs == jgs == [None] and tx is None and jx is None


def test_tape_backward_only_accumulates_into_the_named_leaves():
    """`framework.tape.backward(..., only_accumulate=)` (paddle.grad's
    only_inputs): the named leaves accumulate, the others keep `.grad`."""
    from paddle_tpu_torch.framework import tape
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    w = pt.to_tensor([3.0, 4.0], stop_gradient=False)
    tape.backward((x * w).sum(), only_accumulate=[x])
    close(x.grad, np.array([3.0, 4.0]))
    assert w.grad is None
    tape.backward((x * w).sum(), only_accumulate=[w])
    close(w.grad, np.array([1.0, 2.0]))
    close(x.grad, np.array([3.0, 4.0]))


def test_grad_outputs_and_no_grad_vars():
    """Beyond the JAX package, whose `grad` accepts these and ignores
    them: `grad_outputs` seeds the outputs and `no_grad_vars` are held
    constant."""
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * x
    g, = pt.grad(y, x, grad_outputs=pt.to_tensor([1.0, 10.0]))
    close(g, np.array([2.0, 40.0]))
    h = x * 3
    z = (h * x).sum()
    g, = pt.grad(z, x, no_grad_vars=[h])
    close(g, 3 * np.array([1.0, 2.0]))


def test_create_graph_second_and_third_order():
    def run(P):
        x = P.to_tensor(np.array([2.0, 3.0], "f4"), stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = P.grad(y, [x], create_graph=True)
        (g2,) = P.grad(g.sum(), [x], create_graph=True)
        (g3,) = P.grad(g2.sum(), [x])
        return g, g2, g3, g.stop_gradient
    t, j = both(run)
    for a, b in zip(t[:3], j[:3]):
        close(a, b)
    close(t[0], [12.0, 27.0])
    assert t[3] is False and j[3] is False


def test_freed_graph_raises_in_both():
    """A graph freed by a second-order sweep cannot be swept again. (With
    y = sum(x * x) the JAX package raises too, where torch's double
    backward does not reach y's nodes; x * x * x reaches them in both.)"""
    for P in (pt, pj):
        x = P.to_tensor(np.array([1.0], "f4"), stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = P.grad(y, [x], create_graph=True)
        P.grad(g.sum(), [x])
        with pytest.raises(RuntimeError):
            P.grad(y, [x], create_graph=True)


def test_gradient_penalty_training_through_the_optimizer():
    """WGAN-GP-style: the penalty (|dD/dx| - 1)^2 trains a linear map
    through the double-grad path and SGD over Parameters."""
    r = np.random.RandomState(0)
    xa = r.randn(16, 4).astype("f4")
    wa, ba = r.randn(4, 1).astype("f4"), np.zeros(1, "f4")

    def run(P, opt_mod):
        w, b = P.Parameter(wa), P.Parameter(ba)
        opt = opt_mod.SGD(learning_rate=0.2, parameters=[w, b])
        x = P.to_tensor(xa, stop_gradient=False)
        hist = []
        for _ in range(6):
            out = (P.matmul(x, w) + b).sum()
            (gx,) = P.grad(out, [x], create_graph=True)
            gnorm = (gx * gx).sum(axis=1) ** 0.5
            penalty = ((gnorm - 1.0) ** 2).mean()
            penalty.backward()
            opt.step()
            opt.clear_grad()
            hist.append(float(penalty.numpy()))
        return np.array(hist), w
    import paddle_tpu.optimizer as jopt
    import paddle_tpu_torch.optimizer as topt
    (th, tw), (jh, jw) = run(pt, topt), run(pj, jopt)
    close(th, jh)
    close(tw, jw)
    assert th[-1] < th[0] and tw.grad is None


def _pylayers(base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x, k=1.0):
            ctx.save_for_backward(x)
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return 3 * x * x * g

    class Split(base):
        @staticmethod
        def forward(ctx, a, b):
            return a * b, a + b

        @staticmethod
        def backward(ctx, ga, gb):
            return ga * 2 + gb, None
    return Cube, Split


def test_pylayer_matches_jax():
    def run(P, base):
        Cube, Split = _pylayers(base)
        x = P.to_tensor(np.array([1.0, 2.0], "f4"), stop_gradient=False)
        y = Cube.apply(x, k=2.0)
        a = P.to_tensor(np.array([3.0], "f4"), stop_gradient=False)
        b = P.to_tensor(np.array([4.0], "f4"), stop_gradient=False)
        p, q = Split.apply(a, b)
        (y.sum() + (p * 5).sum() + q.sum()).backward()
        with P.no_grad():
            z = Cube.apply(x)
        return y, x.grad, a.grad, b.grad, z.stop_gradient
    t, j = run(pt, TPyLayer), run(pj, JPyLayer)
    for k in (0, 1, 2):
        close(t[k], j[k])
    assert t[3] is None and j[3] is None and t[4] and j[4]


def test_pylayer_refuses_double_backward_and_bad_grads():
    Cube, _ = _pylayers(TPyLayer)
    x = pt.to_tensor(np.array([2.0], "f4"), stop_gradient=False)
    with pytest.raises(RuntimeError, match="double backward"):
        pt.grad(Cube.apply(x).sum(), [x], create_graph=True)
    for base, P in ((TPyLayer, pt), (JPyLayer, pj)):
        class Bad(base):
            @staticmethod
            def forward(ctx, a, b):
                return a * b

            @staticmethod
            def backward(ctx, g):
                return g
        a = P.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(ValueError, match="returned 1 grads"):
            Bad.apply(a, P.to_tensor([2.0])).sum().backward()
        with pytest.raises(TypeError, match="keyword"):
            Bad.apply(a, b=a)


def test_hooks_see_and_replace_the_gradient():
    """The JAX package records hooks and never calls them (its tape has no
    hook call); the port runs them as Paddle does: a hook sees the
    gradient of that tensor, and its return value replaces it."""
    seen = []
    x = pt.to_tensor(np.array([1.0, 2.0], "f4"), stop_gradient=False)
    h = x * x
    handle = h.register_hook(lambda g: seen.append(g.numpy().copy()))
    scale = x.register_hook(lambda g: g * 10)
    (h * 3).sum().backward()
    close(seen[0], np.array([3.0, 3.0]))
    close(x.grad, 10 * np.array([6.0, 12.0]))
    handle.remove()
    scale.remove()
    x.clear_grad()
    (x * x).sum().backward()
    assert len(seen) == 1
    close(x.grad, np.array([2.0, 4.0]))


def test_autograd_backward_over_several_roots():
    def run(P):
        import importlib
        ag = importlib.import_module(P.__name__ + ".autograd")
        x = P.to_tensor(np.array([1.0, 2.0], "f4"), stop_gradient=False)
        h = x * x
        ag.backward([h.sum(), (h * 2).sum()])
        return x.grad
    close(*both(run))


def test_a_hook_on_a_torch_parameter_shares_the_grad_slot():
    p = pt.Parameter(np.ones(3, "f4"))
    (p * 2).sum().backward()
    assert isinstance(p._data.grad, torch.Tensor)
    close(p.grad, np.full(3, 2.0))
    p.grad = None
    assert p._data.grad is None
