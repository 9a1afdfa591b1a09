"""The port's recurrent stack (`nn/rnn.py`) against the JAX package's on
the CPU, where every sequence op takes its `plain` form.

The registered ops (`simple_rnn_seq`, `lstm_seq`, `gru_seq`, `gru_unit`,
`lstm_unit`, `lstmp_seq` and `text`'s `viterbi_decode`: the `RNN_CASES`
of `tests/torch_op_cases.py`, through `test_torch_ops.check_case`); the
cells; `RNN` over the known cells and over a custom cell; `BiRNN`;
`SimpleRNN`, `LSTM` and `GRU` at 1-2 layers, both directions, batch- and
time-major, with lengths (reverse passes included): the same seeded
inputs and the JAX layer's weights through both packages, the outputs,
the final states and the gradients of every input and weight. Then the
state dict both ways, dropout between layers on the framework generator,
3 CPU `TrainStep` steps of a small `chip_smoke.ptb_lm` against the JAX
TrainStep, and the form each call takes.

Tolerances (f32): outputs and states within 1e-5 x max(1, |ref|);
gradients within 1e-4 x max(1, max|g|); TrainStep losses within 1e-5
relative and parameters within 1e-4 x max(1, |ref|).
"""
import ast
import importlib.util
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import rnn as trnn
from test_torch_ops import check_case
from torch_op_cases import RNN_CASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_rnn_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def u(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype("f4")


def cotangent(name, i, shape):
    r = np.random.RandomState(zlib.crc32(f"{name}/{i}".encode()))
    return r.uniform(-1, 1, shape).astype("f4")


def flat(out):
    """A layer's outputs and (nested) states as one list."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [out]


def held(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, "f8"), np.asarray(w, "f8")
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = np.abs(g - w)
        assert (err <= FWD_RTOL * np.maximum(1, np.abs(w))).all(), \
            (what, k, err.max())


def grads_held(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert (got[k] is None) == (want[k] is None), (what, k)
        if want[k] is None:
            continue
        scale = max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_RTOL * scale, (what, k, err, scale)


@pytest.mark.parametrize("name", sorted(RNN_CASES))
def test_rnn_op_matches_jax(name):
    check_case(name)


def run(P, layer, name, inputs, call):
    """call(P, layer, *Tensors) -> outputs; returns the outputs and the
    gradients of every float input and parameter of a fixed random
    projection of them."""
    ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in inputs]
    outs = flat(call(P, layer, *ts))
    loss = None
    for i, o in enumerate(outs):
        term = (o * P.to_tensor(cotangent(name, i, o.shape))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    grads = {f"input {i}": t.grad.numpy() for i, t in enumerate(ts)
             if not t.stop_gradient}
    grads.update({f"param {k}": p.grad.numpy()
                  for k, p in layer.named_parameters()})
    return [o.numpy() for o in outs], grads


def twin(name, ctor, inputs, call):
    """The layer built by ctor(P) in both packages, the JAX weights loaded
    into the port's, held to each other."""
    jl, tl = ctor(pj), ctor(pt)
    jsd = jl.state_dict()
    assert list(jsd) == list(tl.state_dict())
    assert tl.set_state_dict({k: v.numpy() for k, v in jsd.items()}) == \
        ([], [])
    jo, jg = run(pj, jl, name, inputs, call)
    to, tg = run(pt, tl, name, inputs, call)
    assert len(jo) == len(to)
    held(to, jo, name)
    grads_held(tg, jg, name)


LENS = np.array([5, 2, 1, 4], "int32")
X = u((4, 5, 3))           # [B, T, I]


def layer_call(P, layer, x, lens=None):
    return layer(x, sequence_length=lens)


LAYERS = {
    "SimpleRNN-tanh": (lambda P: P.nn.SimpleRNN(3, 4), [X]),
    "SimpleRNN-relu-bidirect-lengths": (
        lambda P: P.nn.SimpleRNN(3, 4, direction="bidirect",
                                 activation="relu"), [X, LENS]),
    "LSTM-2-layers": (lambda P: P.nn.LSTM(3, 4, num_layers=2), [X]),
    "LSTM-bidirect-lengths": (
        lambda P: P.nn.LSTM(3, 4, num_layers=2, direction="bidirectional"),
        [X, LENS]),
    "LSTM-time-major-lengths": (
        lambda P: P.nn.LSTM(3, 4, time_major=True), [u((5, 4, 3), 1), LENS]),
    "GRU": (lambda P: P.nn.GRU(3, 4), [X]),
    "GRU-bidirect-2-layers-lengths": (
        lambda P: P.nn.GRU(3, 4, num_layers=2, direction="bidirect"),
        [X, LENS]),
    "GRU-time-major": (lambda P: P.nn.GRU(3, 4, time_major=True),
                       [u((5, 4, 3), 2)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rnn_layer_matches_jax(name):
    ctor, inputs = LAYERS[name]
    twin(name, ctor, inputs, layer_call)


def test_initial_states_given_match_jax():
    h0, c0 = u((2, 4, 4), 3), u((2, 4, 4), 4)
    twin("LSTM-h0", lambda P: P.nn.LSTM(3, 4, direction="bidirect"),
         [X, h0, c0, LENS],
         lambda P, layer, x, h, c, lens: layer(x, (h, c), lens))
    twin("GRU-h0", lambda P: P.nn.GRU(3, 4, num_layers=2), [X, h0],
         lambda P, layer, x, h: layer(x, h))


CELLS = {
    "SimpleRNNCell": lambda P: P.nn.SimpleRNNCell(3, 4, activation="relu"),
    "LSTMCell": lambda P: P.nn.LSTMCell(3, 4),
    "GRUCell": lambda P: P.nn.GRUCell(3, 4),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_and_rnn_over_the_cell_match_jax(name):
    x, h = u((4, 3), 5), u((4, 4), 6)
    states = [h, u((4, 4), 7)] if name == "LSTMCell" else [h]
    twin(name, CELLS[name], [x, *states],
         lambda P, cell, x, *s: cell(x, tuple(s) if len(s) > 1 else s[0]))
    twin(name + " default states", CELLS[name], [x],
         lambda P, cell, x: cell(x))
    for rev in (False, True):
        twin(f"RNN({name}, reverse={rev})",
             lambda P: P.nn.RNN(CELLS[name](P), is_reverse=rev),
             [X, LENS], layer_call)


def custom_cell(P):
    """A cell the RNN does not know: h' = tanh(x W + h U), its state (h,
    the running sum of h)."""
    nn = P.nn

    class Cell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 4])
            self.v = self.create_parameter([4, 4])

        def forward(self, x, states):
            h, acc = states
            h = P.tanh(P.matmul(x, self.w) + P.matmul(h, self.v))
            return h, (h, acc + h)

        @property
        def state_shape(self):
            return ((4,), (4,))
    return Cell()


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_over_a_custom_cell_and_birnn_match_jax(reverse):
    twin(f"RNN(custom, reverse={reverse})",
         lambda P: P.nn.RNN(custom_cell(P), is_reverse=reverse),
         [X, LENS], layer_call)
    twin(f"RNN(custom, time_major, reverse={reverse})",
         lambda P: P.nn.RNN(custom_cell(P), is_reverse=reverse,
                            time_major=True), [u((5, 4, 3), 8)], layer_call)
    twin("BiRNN", lambda P: P.nn.BiRNN(P.nn.GRUCell(3, 4),
                                      P.nn.LSTMCell(3, 4)),
         [X, LENS], layer_call)


def test_state_dict_both_ways():
    x = u((2, 6, 3), 9)
    jl = pj.nn.LSTM(3, 5, num_layers=2, direction="bidirect")
    tl = pt.nn.LSTM(3, 5, num_layers=2, direction="bidirect")
    # the port's weights into the JAX layer, then the JAX layer's into a
    # fresh port layer: all three give the same outputs
    jl.set_state_dict({k: v.numpy() for k, v in tl.state_dict().items()})
    back = pt.nn.LSTM(3, 5, num_layers=2, direction="bidirect")
    back.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k].numpy(),
                                      v.numpy())
        assert tuple(v.shape) == tuple(jl.state_dict()[k].shape)
    want = flat(jl(pj.to_tensor(x)))
    for layer in (tl, back):
        held([o.numpy() for o in flat(layer(pt.to_tensor(x)))],
             [o.numpy() for o in want], "state dict")
    # and through the port's save files, which the JAX package reads
    path = str(ROOT / "build" / "test_rnn_state.pdparams")
    Path(path).parent.mkdir(exist_ok=True)
    pt.save(tl.state_dict(), path)
    loaded = pj.load(path)
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v.numpy())
    Path(path).unlink()


def test_dropout_between_layers_draws_from_the_framework_generator():
    x = pt.to_tensor(u((3, 6, 4), 10))
    lstm = pt.nn.LSTM(4, 5, num_layers=2, dropout=0.5)
    plain = pt.nn.LSTM(4, 5, num_layers=2)
    plain.set_state_dict(lstm.state_dict())

    def draw(seed):
        pt.seed(seed)
        return lstm(x)[0].numpy().copy()
    a, b, a2 = draw(1), draw(2), draw(1)
    np.testing.assert_array_equal(a, a2)
    assert not np.array_equal(a, b)
    # the same draw by hand: layer 0's pass, F.dropout on the framework
    # generator seeded alike, layer 1's pass
    pt.seed(1)
    out = x.transpose([1, 0, 2])
    for k in range(2):
        if k:
            out = pt.nn.functional.dropout(out, p=0.5)
        out = pt.nn.rnn.lstm_seq(
            out, pt.zeros([3, 5]), pt.zeros([3, 5]),
            *[getattr(lstm, f"{n}_l{k}") for n in (
                "weight_ih", "weight_hh", "bias_ih", "bias_hh")], None)[0]
    np.testing.assert_array_equal(out.transpose([1, 0, 2]).numpy(), a)
    lstm.eval()
    np.testing.assert_array_equal(lstm(x)[0].numpy(), plain(x)[0].numpy())


def test_trainstep_over_an_lstm_lm_matches_jax():
    cs = _chip_smoke()
    vocab, hidden, batch, steps = 40, 16, 3, 7
    jm = cs.ptb_lm(pj, vocab, hidden, 2, 0.0, init=0.1)
    tm = cs.ptb_lm(pt, vocab, hidden, 2, 0.0, init=0.1)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    res = {}
    for P, m, Step in ((pj, jm, JTrainStep), (pt, tm, TrainStep)):
        step = Step(m, cs.ptb_loss(P, batch), cs.ptb_optimizer(P, m))
        losses = []
        for s in range(3):
            ids, labels = cs.ptb_ids(s, batch, steps, vocab)
            losses.append(float(step(P.to_tensor(ids),
                                     P.to_tensor(labels)).numpy()))
        step.sync()
        res[P] = losses, {k: v.numpy() for k, v in m.state_dict().items()}
    (jl, jw), (tl, tw) = res[pj], res[pt]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jw:
        err = np.abs(tw[k] - jw[k])
        assert (err <= 1e-4 * np.maximum(1, np.abs(jw[k]))).all(), \
            (k, err.max())


def fake(device, dtype=torch.float32):
    """What resolve_form reads of a tensor: its device and dtype."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


def test_auto_form_takes_plain_for_cpu_tensors_and_lengths(monkeypatch):
    def no_cudnn(*a, **k):
        raise AssertionError("cuDNN touched")
    for name in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        monkeypatch.setattr(torch._VF, name, no_cudnn, raising=False)
    monkeypatch.setattr(torch.backends.cudnn, "is_acceptable", no_cudnn)
    monkeypatch.setattr(torch, "_cudnn_rnn_flatten_weight", no_cudnn)
    before = dict(trnn.calls)
    x = pt.to_tensor(X)
    for layer in (pt.nn.LSTM(3, 4, direction="bidirect"), pt.nn.GRU(3, 4),
                  pt.nn.SimpleRNN(3, 4)):
        layer(x)
        layer(x, sequence_length=pt.to_tensor(LENS))
    got = {k: n - before[k] for k, n in trnn.calls.items()}
    assert got == {"lstm_seq.plain": 4, "gru_seq.plain": 2,
                   "simple_rnn_seq.plain": 2, "lstm_seq.cudnn": 0,
                   "gru_seq.cudnn": 0, "simple_rnn_seq.cudnn": 0}, got
    lens = torch.tensor(LENS)
    # the rule: the arguments' device, type and lengths (cuDNN enabled)
    assert trnn.resolve_form(fake("cuda"), None) == "cudnn"
    assert trnn.resolve_form(fake("cuda"), lens) == "plain"
    assert trnn.resolve_form(fake("cuda", torch.bfloat16), None) == "cudnn"
    assert trnn.resolve_form(fake("cuda", torch.complex64), None) == "plain"
    assert trnn.resolve_form(fake("cpu"), None) == "plain"
    with trnn.form_scope("plain"):
        assert trnn.resolve_form(fake("cuda"), None) == "plain"
    with torch.backends.cudnn.flags(enabled=False):
        assert trnn.resolve_form(fake("cuda"), None) == "plain"
        with trnn.form_scope("cudnn"):
            with pytest.raises(ValueError, match="cudnn"):
                trnn.resolve_form(fake("cuda"), None)
    # a pinned cudnn that cannot run raises: no fallback
    with trnn.form_scope("cudnn"):
        for args in ((fake("cpu"), None), (fake("cuda"), lens),
                     (fake("cuda", torch.complex64), None)):
            with pytest.raises(ValueError, match="cudnn"):
                trnn.resolve_form(*args)
        with pytest.raises(ValueError, match="cudnn"):
            pt.nn.rnn.lstm_seq(x.transpose([1, 0, 2]), pt.zeros([4, 4]),
                               pt.zeros([4, 4]), pt.zeros([16, 3]),
                               pt.zeros([16, 4]), pt.zeros([16]),
                               pt.zeros([16]), None)
    with pytest.raises(ValueError, match="unknown rnn form"):
        with trnn.form_scope("fast"):
            pass


def test_nn_exports_every_rnn_name_of_the_jax_package():
    src = (ROOT / "paddle_tpu" / "nn" / "__init__.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom) and node.module == "rnn":
            names.update(a.asname or a.name for a in node.names)
    assert len(names) == 10
    missing = sorted(n for n in names | {"rnn"} if not hasattr(pt.nn, n))
    assert not missing, missing
    for n in names:
        assert getattr(pt.nn, n) is getattr(pt.nn.rnn, n)


def test_no_card_means_no_quiet_cpu_fallback(monkeypatch):
    """On the default place (the card) the layers and distributions raise
    when there is none; asked for the CPU, they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt.set_device("gpu")
    for make in (lambda: pt.nn.LSTM(3, 4), lambda: pt.nn.GRUCell(3, 4),
                 lambda: pt.distribution.Normal(0.0, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    pt.set_device("cpu")
    out, (h, c) = pt.nn.LSTM(3, 4)(pt.to_tensor(X))
    assert out.place == pt.CPUPlace() and tuple(h.shape) == (1, 4, 4)
