"""The port's initializers against the JAX package's: the fans, gains and
deterministic initializers exactly; the random ones by their bounds and
moments (within 4 standard errors), their dtype, their place, and their
replay under `paddle.seed` (the JAX package draws from JAX keys, so the
values themselves differ).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch.nn import initializer as TI

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def draw(init, shape, dtype="float32"):
    out = init(shape, dtype)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert tuple(out.shape) == tuple(shape)
    return out.float().numpy().astype("f8")


def moments(a, mean, std):
    """mean and std of the sample `a` within 4 standard errors of the
    distribution's."""
    n = a.size
    assert abs(a.mean() - mean) <= 4 * std / math.sqrt(n), (a.mean(), mean)
    assert abs(a.std() - std) <= 4 * std / math.sqrt(2 * n), (a.std(), std)


def test_fans_and_gains_are_the_jax_package_s():
    for shape in ((), (7,), (3, 5), (4, 3, 2, 2), (2, 6, 3, 1, 2)):
        assert TI._fan_in_out(shape) == JI._fan_in_out(shape), shape
    for name in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d", "tanh",
                 "relu", "leaky_relu", "selu"):
        assert TI.calculate_gain(name) == JI.calculate_gain(name)
    assert TI.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)


@pytest.mark.parametrize("make,shape", [
    (lambda I: I.Constant(0.75), (3, 4)),
    (lambda I: I.Assign(np.arange(12, dtype="f4") / 7), (3, 4)),
    (lambda I: I.NumpyArrayInitializer([[1.5, -2.0], [0.25, 8.0]]), (2, 2)),
    (lambda I: I.Dirac(), (4, 3, 3, 3)),
    (lambda I: I.Bilinear(), (2, 2, 4, 5)),
    (lambda I: I.Bilinear(), (3, 1, 3, 3)),
])
def test_deterministic_initializers_equal_the_jax_package_s(make, shape):
    for dtype in ("float32", "bfloat16"):
        got = make(TI)(shape, dtype)
        want = np.asarray(make(JI)(shape, dtype)).astype("f4")
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.array_equal(
        TI.Assign(pt.to_tensor(np.ones((2, 2), "f4")))((2, 2)).numpy(),
        np.ones((2, 2), "f4"))


def test_random_initializers_bounds_and_moments():
    pt.seed(11)
    shape = (300, 200)
    fi, fo = 300, 200
    a = draw(TI.Uniform(-0.5, 1.5), shape)
    assert -0.5 <= a.min() and a.max() < 1.5
    moments(a, 0.5, 2.0 / math.sqrt(12))
    moments(draw(TI.Normal(0.3, 2.0), shape), 0.3, 2.0)
    t = draw(TI.TruncatedNormal(1.0, 0.5), shape)
    assert 0.0 <= t.min() and t.max() <= 2.0
    # the standard normal truncated to [-2, 2] has variance 0.7737
    z = 2.0
    pdf = math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
    var = 1 - 2 * z * pdf / math.erf(z / math.sqrt(2))
    moments(t, 1.0, 0.5 * math.sqrt(var))
    lim = math.sqrt(6.0 / (fi + fo))
    xu = draw(TI.XavierUniform(), shape)
    assert np.abs(xu).max() <= lim
    moments(xu, 0.0, lim / math.sqrt(3))
    moments(draw(TI.XavierNormal(gain=2.0), shape), 0.0,
            2.0 * math.sqrt(2.0 / (fi + fo)))
    moments(draw(TI.XavierNormal(fan_in=10, fan_out=30), shape), 0.0,
            math.sqrt(2.0 / 40))
    klim = math.sqrt(6.0 / 50)
    ku = draw(TI.KaimingUniform(fan_in=50), shape)
    assert np.abs(ku).max() <= klim
    moments(ku, 0.0, klim / math.sqrt(3))
    moments(draw(TI.KaimingNormal(), (64, 32, 3, 3)), 0.0,
            math.sqrt(2.0 / (32 * 9)))
    assert TI.MSRAInitializer is TI.KaimingNormal
    bf = TI.Normal(0.0, 1.0)((64, 64), "bfloat16")
    assert bf.dtype == torch.bfloat16


def test_orthogonal_is_orthogonal_and_scaled():
    pt.seed(2)
    for shape, gain in (((6, 4), 1.0), ((3, 8), 2.0), ((2, 3, 5), 0.5)):
        q = draw(TI.Orthogonal(gain), shape).reshape(-1, shape[-1])
        rows, cols = q.shape
        gram = q.T @ q if rows >= cols else q @ q.T
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(min(rows, cols)),
                                   atol=1e-5)
        jq = np.asarray(JI.Orthogonal(gain)(shape)).reshape(-1, shape[-1])
        jgram = jq.T @ jq if rows >= cols else jq @ jq.T
        np.testing.assert_allclose(jgram, gram, atol=1e-5)


def test_draws_replay_under_seed_and_follow_the_place():
    def draws():
        pt.seed(5)
        return [draw(init, (50, 40)) for init in (
            TI.Uniform(), TI.Normal(), TI.TruncatedNormal(),
            TI.XavierUniform(), TI.XavierNormal(), TI.KaimingUniform(),
            TI.KaimingNormal(), TI.Orthogonal())]
    first, again = draws(), draws()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    pt.seed(6)
    assert not np.array_equal(draw(TI.Normal(), (50, 40)), first[1])
    # with no card, the default place raises instead of drawing on the
    # host
    pt.set_device("gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.Normal()((2, 2))
