"""Mixture-of-Experts FFN (the port of `paddle_tpu/incubate/moe.py`,
GShard/Switch-style top-k gating).

The experts live in stacked parameters, expert dimension first:
`gate.weight [D, E]` (no bias), `w1 [E, D, H]`, `b1 [E, 1, H]`,
`w2 [E, H, D]`, `b2 [E, 1, D]`, the JAX package's names and shapes, so
its `state_dict()` loads as it is. Dispatch and combine are dense
products over a one-hot [N, E, C] plan (no gather, scatter or dynamic
shape), the experts two batched products with a tanh-GELU between:
everything the layer runs is a fixed-shape device op, so it runs inside
a CUDA graph with no host read (the one-hots are comparisons with an
`arange`, the slot counters device tensors). Capacity C bounds each
expert's buffer; a token past it gets no slot and rides the caller's
residual.

Gating and softmax run in f32; the plan's products run in the
activations' dtype. The top-1 load-balance loss (Shazeer et al.:
E * sum(fraction of tokens x mean gate probability)) is returned, scaled
by `aux_weight`, not stashed. The JAX package's 'ep' sharding hint has
no counterpart while the port has no mesh (ROADMAP Queue 1 item 5).
"""
import math

import torch
from torch.nn import functional as TF

from .. import nn
from ..nn import initializer as I
from ..ops.dispatch import apply


def _one_hot(idx, n):
    """f32 one-hot of int indices: a comparison with an arange (capturable;
    an index outside [0, n) gives a zero row)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_dispatch(gate_logits, k, capacity):
    """Gating and the dispatch plan of gate_logits [N, E] (N = B * S
    tokens). Returns (dispatch [N, E, C] f32 one-hot, combine [N, E, C]
    f32, aux loss): token n's choice r takes slot c of expert e, where c
    is the count of earlier tokens (and earlier rounds) routed to e; a
    token whose slot would be C or more is dropped (zero rows). The k
    choices are routed in sequential argmax rounds (ties to the lowest
    expert index), each round's counts carried into the next."""
    n, e = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)

    # the load-balance loss over the TOP-1 assignment (Switch/GShard)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = _one_hot(top1, e).mean(dim=0)              # [E]
    frac_probs = probs.mean(dim=0)                           # [E]
    aux = e * torch.sum(frac_tokens * frac_probs)

    dispatch = torch.zeros((n, e, capacity), dtype=torch.float32,
                           device=gate_logits.device)
    combine = torch.zeros_like(dispatch)
    remaining = probs
    used = torch.zeros((e,), dtype=torch.int32, device=gate_logits.device)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)             # [N]
        gate = torch.gather(remaining, 1, choice[:, None])[:, 0]
        sel = _one_hot(choice, e)                            # [N, E]
        remaining = remaining * (1.0 - sel)
        # each token's position in its expert's buffer: the running count
        # of earlier tokens routed there, after the earlier rounds' slots
        pos_in_e = (torch.cumsum(sel, dim=0) - sel) + used[None, :].float()
        pos = torch.sum(pos_in_e * sel, dim=-1).to(torch.int32)   # [N]
        # the overflow slot C is dropped
        slot = _one_hot(torch.where(pos < capacity, pos, capacity),
                        capacity + 1)[:, :capacity]
        d = sel[:, :, None] * slot[:, None, :]               # [N, E, C]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        used = used + torch.sum(d, dim=(0, 2)).to(torch.int32)
    return dispatch, combine, aux


def capacity_of(tokens, k, num_experts, capacity_factor):
    """Slots per expert: max(1, int(cf * N * k / E)), from shapes."""
    return max(1, int(capacity_factor * tokens * k / num_experts))


def _moe_raw(x, w1, b1, w2, b2, gw, k, capacity_factor):
    """The layer's forward on torch tensors: (y [B, S, D], aux)."""
    b, s, d = x.shape
    nt = b * s
    xt = x.reshape(nt, d)
    logits = xt.float() @ gw.float()
    e = gw.shape[1]
    dispatch, combine, aux = moe_dispatch(
        logits, k, capacity_of(nt, k, e, capacity_factor))
    ein = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)  # [E, C, D]
    h = TF.gelu(torch.einsum("ecd,edh->ech", ein, w1) + b1.to(x.dtype),
                approximate="tanh")
    eout = torch.einsum("ech,ehd->ecd", h, w2) + b2.to(x.dtype)
    y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), eout)
    return y.reshape(b, s, d), aux


class MoELayer(nn.Layer):
    """MoE FFN. forward(x) -> (y, aux_weight * aux): the load-balance
    loss is returned for the caller to add to its task loss. Tokens past
    capacity contribute zero rows and ride the caller's residual."""

    def __init__(self, d_model, d_hidden, num_experts, k=2,
                 capacity_factor=1.25, aux_weight=0.01,
                 initializer_range=0.02):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.k = int(k)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        init = I.Normal(0.0, initializer_range)
        self.gate = nn.Linear(d_model, num_experts,
                              weight_attr=nn.ParamAttr(initializer=init),
                              bias_attr=False)
        self.w1 = self.create_parameter(
            [num_experts, d_model, d_hidden], default_initializer=init)
        self.b1 = self.create_parameter(
            [num_experts, 1, d_hidden], default_initializer=I.Constant(0.0))
        self.w2 = self.create_parameter(
            [num_experts, d_hidden, d_model],
            default_initializer=I.Normal(
                0.0, initializer_range / math.sqrt(2.0)))
        self.b2 = self.create_parameter(
            [num_experts, 1, d_model], default_initializer=I.Constant(0.0))

    def forward(self, x):
        y, aux = apply(_moe_raw, (x, self.w1, self.b1, self.w2, self.b2,
                                  self.gate.weight),
                       {"k": self.k, "capacity_factor": self.capacity_factor},
                       name="moe_layer")
        return y, aux * self.aux_weight

    def infer(self, x):
        """The layer on its torch leaves (serving: the output only)."""
        return _moe_raw(x, self.w1._data, self.b1._data, self.w2._data,
                        self.b2._data, self.gate.weight._data, self.k,
                        self.capacity_factor)[0]
