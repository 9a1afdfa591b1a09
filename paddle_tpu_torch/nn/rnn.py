"""Recurrent layers: SimpleRNN / LSTM / GRU cells and multi-layer RNNs (the
port of `paddle_tpu/nn/rnn.py`; ref python/paddle/nn/layer/rnn.py).

A whole (layer, direction) pass over a time-major [T, B, I] sequence is
one registered op (`simple_rnn_seq`, `lstm_seq`, `gru_seq`). Two forms
sit behind the op's dispatch point, chosen by the innermost
`form_scope(...)`, else "auto":

  "plain"  the input projection of every timestep as one product,
           `x @ w_ih.T + b_ih`, then a Python loop over time that
           carries only the recurrent product, in torch ops — the JAX
           package's `lax.scan` step by step. The CPU runs it, and so
           does any call with `lengths`;
  "cudnn"  one `torch._VF` call for the pass (`lstm`, `gru`,
           `rnn_tanh`, `rnn_relu`: cuDNN's RNN), a reverse pass through
           flipped time. CUDA tensors of a floating type cuDNN's RNN
           takes (f16, bf16, f32, f64) without `lengths`, with
           `torch.backends.cudnn.enabled` set, only: anything else
           raises, nothing falls back;
  "auto"   "cudnn" where those conditions hold, "plain" everywhere
           else (cuDNN cannot apply the length mask without host-side
           lengths, which a captured graph cannot read). The conditions
           are the arguments' device, type and lengths and the process's
           cuDNN switch; nothing is caught to switch forms.

`calls` counts each op's calls by the form they took (a CUDA-graph
replay runs no Python and counts nothing).

Gate layouts match the JAX package and torch's: LSTM chunks [i, f, g,
o]; GRU chunks [r, z, c] with the reset gate applied after the recurrent
product (its bias included) and `h = (h - c) * z + c`. Lengths keep each
row's carry at its last valid step and zero the padded outputs; a
reverse pass walks the padded axis backwards, so a row of length L < T
consumes only its own steps, in reverse.

The layers keep the JAX package's parameter names and shapes ([gates·H,
in], `Uniform(±1/sqrt(H))`), so a JAX state dict loads through
`set_state_dict`. A layer whose weights sit on the card in a cuDNN type
keeps each pass's four weights in one cuDNN-layout buffer
(`flatten_parameters`, when it is built and after every move or cast:
`torch._cudnn_rnn_flatten_weight` re-points the same torch leaves, so
the Parameters, the optimizers and any captured graph keep them), and
cuDNN reads them without a copy. Weights that are not flat (swapped in
by `functional_call`, or an op called on loose tensors) still run; cuDNN
copies them first.
"""
import contextlib
import math

import torch

from ..framework.dtype import convert_dtype
from ..framework.tensor import Tensor
from ..ops.dispatch import def_op
from . import initializer as I
from .layer import Layer

FORMS = ("auto", "plain", "cudnn")
_SCOPE_STACK = []
# the types torch's cuDNN RNN takes (bf16 too: `torch.backends.cudnn.
# is_acceptable` leaves it out, but `_VF.lstm` runs it through cuDNN,
# aten/src/ATen/native/cudnn/RNN.cpp, on torch 2.11 with cuDNN 9.22)
_CUDNN_DTYPES = (torch.float16, torch.bfloat16, torch.float32,
                 torch.float64)
SEQ_OPS = ("simple_rnn_seq", "lstm_seq", "gru_seq")

#: calls of each sequence op by the form it took since the last reset
#: ("lstm_seq.plain", ...): plain integers, incremented where the op
#: runs its form and nowhere else
calls = {f"{op}.{form}": 0 for op in SEQ_OPS for form in ("plain", "cudnn")}


def _check(form):
    if form not in FORMS:
        raise ValueError(f"unknown rnn form {form!r}: expected one of "
                         f"{FORMS}")
    return form


@contextlib.contextmanager
def form_scope(form):
    """Pin the sequence ops' form inside a `with` block."""
    _SCOPE_STACK.append(_check(form))
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


def resolve_form(x, lengths):
    """"plain" or "cudnn" for a pass over torch tensor `x` under the
    innermost `form_scope` (see the module docstring). A pinned "cudnn"
    that cannot run raises."""
    form = _SCOPE_STACK[-1] if _SCOPE_STACK else "auto"
    if form == "plain":
        return "plain"
    usable = (x.device.type == "cuda" and lengths is None
              and x.dtype in _CUDNN_DTYPES and torch.backends.cudnn.enabled)
    if form == "auto":
        return "cudnn" if usable else "plain"
    if not usable:
        raise ValueError(
            f"rnn form 'cudnn' runs CUDA tensors of {_CUDNN_DTYPES} "
            f"without lengths, with cuDNN enabled; got a {x.dtype} tensor "
            f"on {x.device}" + ("" if lengths is None else " with lengths"))
    return "cudnn"


# --------------------------------------------------------------------------- #
# one (layer, direction) pass                                                 #
# --------------------------------------------------------------------------- #

def _common(*ts):
    """The tensors (None kept) cast to their promoted floating type, as
    the JAX package's mixed-type products promote."""
    dt = None
    for t in ts:
        if t is not None and t.is_floating_point():
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt or
                 not t.is_floating_point() else t.to(dt) for t in ts)


def _live(lengths, T, device):
    """[T, B, 1] bool: step t of row b is inside its length."""
    if lengths is None:
        return None
    return (torch.arange(T, device=device)[:, None]
            < lengths.to(device)[None, :]).unsqueeze(-1)


def _scan(step, xp, carry, live, reverse):
    """Run `step(carry, x_t) -> (carry, out)` over time-major `xp`
    [T, B, G*H] (the input projection, biases folded in). Steps outside a
    row's length keep its carry and output zeros. Returns (outputs
    [T, B, H], final carry)."""
    T = xp.shape[0]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new, out = step(carry, xp[t])
        if live is not None:
            valid = live[t]
            new = tuple(torch.where(valid, n, o) for n, o in zip(new, carry))
            out = torch.where(valid, out, 0.0)
        carry = new
        outs[t] = out
    return torch.stack(outs), carry


def _simple_step(w_hh, act):
    w = w_hh.t()
    f = torch.tanh if act == "tanh" else torch.relu

    def step(carry, xt):
        h = f(torch.addmm(xt, carry[0], w))
        return (h,), h
    return step


def _lstm_step(w_hh):
    w = w_hh.t()

    def step(carry, xt):
        h, c = carry
        gates = torch.addmm(xt, h, w)
        H = c.shape[1]
        s = torch.sigmoid(gates)
        i, f, o = s[:, :H], s[:, H:2 * H], s[:, 3 * H:]
        c = torch.addcmul(f * c, i, torch.tanh(gates[:, 2 * H:3 * H]))
        h = o * torch.tanh(c)
        return (h, c), h
    return step


def _gru_step(w_hh, b_hh):
    w = w_hh.t()

    def step(carry, xt):
        (h,) = carry
        # the reset gate applies after the recurrent product (ref
        # rnn.py:683)
        hg = torch.addmm(b_hh, h, w)
        H = h.shape[1]
        rz = torch.sigmoid(xt[:, :2 * H] + hg[:, :2 * H])
        r, z = rz[:, :H], rz[:, H:]
        c = torch.tanh(torch.addcmul(xt[:, 2 * H:], r, hg[:, 2 * H:]))
        h = torch.addcmul(c, h - c, z)
        return (h,), h
    return step


def _plain(kind, x, states, w_ih, w_hh, b_ih, b_hh, lengths, reverse,
           activation="tanh"):
    if kind == "gru":
        xp = torch.nn.functional.linear(x, w_ih, b_ih)
        step = _gru_step(w_hh, b_hh)
    else:
        xp = torch.nn.functional.linear(x, w_ih, b_ih + b_hh)
        step = _lstm_step(w_hh) if kind == "lstm" else \
            _simple_step(w_hh, activation)
    return _scan(step, xp, states, _live(lengths, x.shape[0], x.device),
                 reverse)


def _cudnn(kind, x, states, weights, reverse, activation="tanh"):
    """One `torch._VF` pass (one layer, one direction): returns (outputs,
    final states)."""
    if kind == "lstm":
        fn = torch._VF.lstm
        hx = [s.unsqueeze(0) for s in states]
    else:
        fn = {"gru": torch._VF.gru}.get(kind) or (
            torch._VF.rnn_tanh if activation == "tanh" else
            torch._VF.rnn_relu)
        hx = states[0].unsqueeze(0)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *states, *weights))
    if reverse:
        x = x.flip(0)
    out = fn(x, hx, list(weights), True, 1, 0.0, train, False, False)
    ys = out[0].flip(0) if reverse else out[0]
    return ys, tuple(s.squeeze(0) for s in out[1:])


def _pass(op, kind, x, states, w_ih, w_hh, b_ih, b_hh, lengths, reverse,
          activation="tanh"):
    x, w_ih, w_hh, b_ih, b_hh, *states = _common(x, w_ih, w_hh, b_ih, b_hh,
                                                 *states)
    form = resolve_form(x, lengths)
    calls[f"{op}.{form}"] += 1
    if form == "cudnn":
        return _cudnn(kind, x, tuple(states), (w_ih, w_hh, b_ih, b_hh),
                      reverse, activation)
    return _plain(kind, x, tuple(states), w_ih, w_hh, b_ih, b_hh, lengths,
                  reverse, activation)


@def_op("simple_rnn_seq", n_tensor_args=7)
def simple_rnn_seq(x, h0, w_ih, w_hh, b_ih, b_hh, lengths,
                   activation="tanh", reverse=False):
    """One SimpleRNN layer over a full [T, B, I] time-major sequence."""
    ys, (h,) = _pass("simple_rnn_seq", "simple", x, (h0,), w_ih, w_hh,
                     b_ih, b_hh, lengths, reverse, activation)
    return ys, h


@def_op("lstm_seq", n_tensor_args=8)
def lstm_seq(x, h0, c0, w_ih, w_hh, b_ih, b_hh, lengths, reverse=False):
    """One LSTM layer over a full [T, B, I] time-major sequence."""
    ys, (h, c) = _pass("lstm_seq", "lstm", x, (h0, c0), w_ih, w_hh, b_ih,
                       b_hh, lengths, reverse)
    return ys, h, c


@def_op("gru_seq", n_tensor_args=7)
def gru_seq(x, h0, w_ih, w_hh, b_ih, b_hh, lengths, reverse=False):
    """One GRU layer over a full [T, B, I] time-major sequence."""
    ys, (h,) = _pass("gru_seq", "gru", x, (h0,), w_ih, w_hh, b_ih, b_hh,
                     lengths, reverse)
    return ys, h


def flatten_weights(weights, mode, hidden_size):
    """Move one pass's (w_ih, w_hh, b_ih, b_hh) torch leaves into one
    buffer in cuDNN's layout, in place: the same leaf objects, re-pointed,
    their values kept. Only for CUDA leaves of a cuDNN type (otherwise
    nothing happens), and never inside a CUDA-graph capture, whose pool
    the buffer would come from."""
    w = weights[0]
    if not (w.device.type == "cuda" and w.dtype in _CUDNN_DTYPES
            and torch.backends.cudnn.enabled
            and all(v.device == w.device and v.dtype == w.dtype
                    for v in weights)):
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rnn: weights flattened during a CUDA-graph "
                           "capture")
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            list(weights), 4, w.shape[1],
            torch.backends.cudnn.rnn.get_cudnn_mode(mode), hidden_size, 0,
            1, False, False)


class _FlatWeights:
    """Keeps a layer's passes flat for cuDNN (`flatten_weights`): when it
    is built (`flatten_parameters()` at the end of `__init__`) and after
    every move or cast (`_apply`)."""

    def _passes(self):
        """(mode, the pass's four Parameters) of each pass."""
        raise NotImplementedError

    def flatten_parameters(self):
        for mode, weights in self._passes():
            flatten_weights(tuple(w._data for w in weights), mode,
                            self.hidden_size)

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self.flatten_parameters()
        return out


# --------------------------------------------------------------------------- #
# cells                                                                       #
# --------------------------------------------------------------------------- #

def _wrap(x):
    return x if isinstance(x, Tensor) else Tensor(x)


class RNNCellBase(Layer):
    """ref python/paddle/nn/layer/rnn.py:144."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = convert_dtype(dtype or "float32")
        dev = batch_ref._data.device if isinstance(batch_ref, Tensor) \
            else batch_ref.device

        def full(s):
            return Tensor._wrap(torch.full((batch,) + tuple(s), init_value,
                                           dtype=dt, device=dev))
        if isinstance(shape[0], (list, tuple)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def _make_weights(self, input_size, hidden_size, n_gates,
                      weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr):
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        g = n_gates * hidden_size
        self.weight_ih = self.create_parameter(
            (g, input_size), weight_ih_attr, default_initializer=u)
        self.weight_hh = self.create_parameter(
            (g, hidden_size), weight_hh_attr, default_initializer=u)
        self.bias_ih = self.create_parameter(
            (g,), bias_ih_attr, is_bias=True, default_initializer=u)
        self.bias_hh = self.create_parameter(
            (g,), bias_hh_attr, is_bias=True, default_initializer=u)


class SimpleRNNCell(RNNCellBase):
    """Elman RNN cell (ref rnn.py:268)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(
                f"activation for SimpleRNNCell should be tanh or relu, "
                f"but got {activation}")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._make_weights(input_size, hidden_size, 1, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        from . import functional as F
        if states is None:
            states = self.get_initial_states(inputs)
        pre = (F.linear(inputs, self.weight_ih.T, self.bias_ih)
               + F.linear(states, self.weight_hh.T, self.bias_hh))
        h = pre.tanh() if self.activation == "tanh" else F.relu(pre)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class LSTMCell(_FlatWeights, RNNCellBase):
    """LSTM cell, gate chunks [i, f, g, o] (ref rnn.py:400,518-537)."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(input_size, hidden_size, 4, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.flatten_parameters()

    def _passes(self):
        yield "LSTM", (self.weight_ih, self.weight_hh, self.bias_ih,
                       self.bias_hh)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h0, c0 = states
        ys, h, c = lstm_seq(_wrap(inputs).unsqueeze(0), h0, c0,
                            self.weight_ih, self.weight_hh, self.bias_ih,
                            self.bias_hh, None)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class GRUCell(_FlatWeights, RNNCellBase):
    """GRU cell, h = (h_prev - c) * z + c (ref rnn.py:553,665-686)."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(input_size, hidden_size, 3, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.flatten_parameters()

    def _passes(self):
        yield "GRU", (self.weight_ih, self.weight_hh, self.bias_ih,
                      self.bias_hh)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        ys, h = gru_seq(_wrap(inputs).unsqueeze(0), states, self.weight_ih,
                        self.weight_hh, self.bias_ih, self.bias_hh, None)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


# --------------------------------------------------------------------------- #
# wrappers                                                                    #
# --------------------------------------------------------------------------- #

_FUSED = {}  # cell class -> runner; filled below


def _as_tuple(states):
    return states if isinstance(states, (tuple, list)) else (states,)


class RNN(Layer):
    """Run a cell over a sequence (ref rnn.py:700).

    Known cells (SimpleRNNCell/LSTMCell/GRUCell) go straight to the
    sequence ops; a custom cell takes the per-step loop, which holds
    finished rows' states the same way."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs if self.time_major else inputs.transpose([1, 0, 2])
        runner = _FUSED.get(type(self.cell))
        if runner is not None:
            outs, final = runner(self.cell, x, initial_states,
                                 sequence_length, self.is_reverse)
        else:
            outs, final = self._loop(x, initial_states, sequence_length)
        if not self.time_major:
            outs = outs.transpose([1, 0, 2])
        return outs, final

    def _loop(self, x, initial_states, sequence_length):
        from ..ops import manipulation as M
        T = x.shape[0]
        states = initial_states
        if states is None:
            states = self.cell.get_initial_states(x, batch_dim_idx=1)
        order = range(T - 1, -1, -1) if self.is_reverse else range(T)
        outs = [None] * T
        for t in order:
            out, new_states = self.cell(x[t], states)
            if sequence_length is not None:
                valid = Tensor._wrap(
                    (t < sequence_length._data.to(out._data.device))[:, None])
                zero = Tensor._wrap(torch.zeros_like(out._data))
                outs[t] = M.where(valid, out, zero)
                # hold states past each sequence's end (as the ops do)
                new_flat = _as_tuple(new_states)
                old_flat = _as_tuple(states)
                held = tuple(M.where(valid, n, o)
                             for n, o in zip(new_flat, old_flat))
                states = held if isinstance(new_states, (tuple, list)) \
                    else held[0]
            else:
                outs[t] = out
                states = new_states
        return M.stack(outs, axis=0), states


def _run_simple(cell, x, init, lengths, reverse):
    h0 = _as_tuple(init)[0] if init is not None else \
        cell.get_initial_states(x, batch_dim_idx=1)
    ys, h = simple_rnn_seq(x, h0, cell.weight_ih, cell.weight_hh,
                           cell.bias_ih, cell.bias_hh, lengths,
                           activation=cell.activation, reverse=reverse)
    return ys, h


def _run_lstm(cell, x, init, lengths, reverse):
    if init is None:
        init = cell.get_initial_states(x, batch_dim_idx=1)
    h0, c0 = init
    ys, h, c = lstm_seq(x, h0, c0, cell.weight_ih, cell.weight_hh,
                        cell.bias_ih, cell.bias_hh, lengths, reverse=reverse)
    return ys, (h, c)


def _run_gru(cell, x, init, lengths, reverse):
    h0 = _as_tuple(init)[0] if init is not None else \
        cell.get_initial_states(x, batch_dim_idx=1)
    ys, h = gru_seq(x, h0, cell.weight_ih, cell.weight_hh,
                    cell.bias_ih, cell.bias_hh, lengths, reverse=reverse)
    return ys, h


_FUSED[SimpleRNNCell] = _run_simple
_FUSED[LSTMCell] = _run_lstm
_FUSED[GRUCell] = _run_gru


class BiRNN(Layer):
    """Forward + backward cells over the same sequence (ref rnn.py:775)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops import manipulation as M
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return M.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class _RNNBase(_FlatWeights, Layer):
    """Multi-layer (optionally bidirectional) stack (ref rnn.py:854).

    Parameter naming follows the reference flat form: weight_ih_l{k} /
    weight_hh_l{k} / bias_ih_l{k} / bias_hh_l{k} with `_reverse` suffix for
    the backward direction, so state dicts port over directly. Dropout
    between layers is `F.dropout` on the framework generator (a captured
    step draws afresh on every replay), never cuDNN's own."""

    MODES = {"RNN_TANH": (1, "simple"), "RNN_RELU": (1, "simple"),
             "LSTM": (4, "lstm"), "GRU": (3, "gru")}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(
                f"direction should be forward or bidirect(ional), "
                f"got {direction}")
        n_gates, self._kind = self.MODES[mode]
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                isize = input_size if layer == 0 \
                    else hidden_size * self.num_directions
                sfx = f"l{layer}" + ("_reverse" if d == 1 else "")
                g = n_gates * hidden_size
                setattr(self, f"weight_ih_{sfx}", self.create_parameter(
                    (g, isize), weight_ih_attr, default_initializer=u))
                setattr(self, f"weight_hh_{sfx}", self.create_parameter(
                    (g, hidden_size), weight_hh_attr, default_initializer=u))
                setattr(self, f"bias_ih_{sfx}", self.create_parameter(
                    (g,), bias_ih_attr, is_bias=True, default_initializer=u))
                setattr(self, f"bias_hh_{sfx}", self.create_parameter(
                    (g,), bias_hh_attr, is_bias=True, default_initializer=u))
        self.flatten_parameters()

    def _passes(self):
        for layer in range(self.num_layers):
            for d in range(self.num_directions):
                yield self.mode, self._weights(layer, d)

    def _weights(self, layer, d):
        sfx = f"l{layer}" + ("_reverse" if d == 1 else "")
        return (getattr(self, f"weight_ih_{sfx}"),
                getattr(self, f"weight_hh_{sfx}"),
                getattr(self, f"bias_ih_{sfx}"),
                getattr(self, f"bias_hh_{sfx}"))

    def _zeros(self, x):
        batch = x.shape[1]
        n = self.num_layers * self.num_directions
        return torch.zeros((n, batch, self.hidden_size),
                           dtype=x._data.dtype, device=x._data.device)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from . import functional as F
        from ..ops import manipulation as M
        x = inputs if self.time_major else inputs.transpose([1, 0, 2])
        lengths = sequence_length
        is_lstm = self._kind == "lstm"

        if initial_states is None:
            z = Tensor._wrap(self._zeros(x))
            initial_states = (z, z.clone()) if is_lstm else z
        if is_lstm:
            h_all, c_all = initial_states
        else:
            h_all = initial_states

        out = x
        hs, cs = [], []
        for layer in range(self.num_layers):
            per_dir = []
            for d in range(self.num_directions):
                idx = layer * self.num_directions + d
                w_ih, w_hh, b_ih, b_hh = self._weights(layer, d)
                h0 = h_all[idx]
                if self._kind == "simple":
                    act = "tanh" if self.mode == "RNN_TANH" else "relu"
                    ys, h = simple_rnn_seq(out, h0, w_ih, w_hh, b_ih, b_hh,
                                           lengths, activation=act,
                                           reverse=bool(d))
                    hs.append(h)
                elif self._kind == "gru":
                    ys, h = gru_seq(out, h0, w_ih, w_hh, b_ih, b_hh,
                                    lengths, reverse=bool(d))
                    hs.append(h)
                else:
                    c0 = c_all[idx]
                    ys, h, c = lstm_seq(out, h0, c0, w_ih, w_hh, b_ih, b_hh,
                                        lengths, reverse=bool(d))
                    hs.append(h)
                    cs.append(c)
                per_dir.append(ys)
            out = per_dir[0] if len(per_dir) == 1 \
                else M.concat(per_dir, axis=-1)
            if self.dropout > 0.0 and layer < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout,
                                training=self.training)
        final_h = M.stack(hs, axis=0)
        if not self.time_major:
            out = out.transpose([1, 0, 2])
        if is_lstm:
            return out, (final_h, M.stack(cs, axis=0))
        return out, final_h

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, mode={self.mode}")


class SimpleRNN(_RNNBase):
    """ref rnn.py:1090."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    """ref rnn.py:1197."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    """ref rnn.py:1308."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


# public alias (ref nn/layer/rnn.py RNNBase)
RNNBase = _RNNBase


# --------------------------------------------------------------------------- #
# fluid-era cell-step ops (ref operators/gru_unit_op.cc, lstm_unit_op.cc,    #
# lstmp_op.cc)                                                               #
# --------------------------------------------------------------------------- #

@def_op("gru_unit", n_tensor_args=4)
def gru_unit(x_gates, hidden_prev, weight, bias,
             gate_activation="sigmoid", activation="tanh",
             origin_mode=False):
    """One GRU step, fluid layout (ref operators/gru_unit_op.cc):
    x_gates: [B, 3D] (input already projected), hidden_prev: [B, D],
    weight: [D, 3D] stored flat — the reference kernel (gru_unit_op.h
    GEMMs: ldb=2*frame_size over the first 2*D*D elements, then
    ldb=frame_size from offset 2*D*D) reads it as a packed [D, 2D]
    update/reset block followed by a [D, D] candidate block, NOT as
    column slices of a [D, 3D] matrix; bias: [1, 3D]. Returns
    (gate [B,3D], reset_hidden_prev [B,D], hidden [B,D]) like the ref op."""
    d = hidden_prev.shape[1]
    g = x_gates + bias
    wf = weight.reshape(-1)
    w_rz = wf[:2 * d * d].reshape(d, 2 * d)
    w_c = wf[2 * d * d:].reshape(d, d)
    rz = g[:, :2 * d] + hidden_prev @ w_rz
    act = torch.sigmoid if gate_activation == "sigmoid" else torch.tanh
    u = act(rz[:, :d])
    r = act(rz[:, d:])
    rhp = r * hidden_prev
    c_in = g[:, 2 * d:] + rhp @ w_c
    cact = torch.tanh if activation == "tanh" else torch.sigmoid
    c = cact(c_in)
    if origin_mode:
        h = u * hidden_prev + (1.0 - u) * c
    else:
        h = (1.0 - u) * hidden_prev + u * c
    gate_out = torch.cat([u, r, c], dim=1)
    return gate_out, rhp, h


@def_op("lstm_unit", n_tensor_args=2)
def lstm_unit(x_gates, c_prev, forget_bias=0.0):
    """One LSTM step on pre-projected gates (ref operators/lstm_unit_op.cc):
    x_gates: [B, 4D] in (i, g, f, o) order like the reference kernel,
    c_prev: [B, D]. Returns (c, h)."""
    d = c_prev.shape[1]
    i = torch.sigmoid(x_gates[:, :d])
    g = torch.tanh(x_gates[:, d:2 * d])
    f = torch.sigmoid(x_gates[:, 2 * d:3 * d] + forget_bias)
    o = torch.sigmoid(x_gates[:, 3 * d:])
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return c, h


@def_op("lstmp_seq", n_tensor_args=9)
def lstmp_seq(x, h0, c0, w_ih, w_hh, b_ih, b_hh, w_proj, lengths,
              reverse=False):
    """LSTM with recurrent projection (ref operators/lstmp_op.cc): the
    recurrent state fed back is r_t = h_t @ w_proj, so w_hh is [4H, P].
    x: [T, B, I]; returns (ys [T, B, P], r_T, c_T). Padding steps freeze
    the carry, so rT/cT are the states at each row's last valid step and
    reverse=True consumes timesteps from each row's true region. The
    plain form only."""
    x, h0, c0, w_ih, w_hh, b_ih, b_hh, w_proj = _common(
        x, h0, c0, w_ih, w_hh, b_ih, b_hh, w_proj)
    xp = torch.nn.functional.linear(x, w_ih, b_ih + b_hh)
    lstm = _lstm_step(w_hh)

    def step(carry, xt):
        (h, c), _ = lstm(carry, xt)
        r = h @ w_proj
        return (r, c), r

    ys, (rT, cT) = _scan(step, xp, (h0, c0), _live(lengths, x.shape[0],
                                                   x.device), reverse)
    return ys, rT, cT
