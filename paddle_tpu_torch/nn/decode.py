"""Decoding: beam search (`BeamSearchDecoder`, `dynamic_decode`), the
sampling filters of generation and serving, and `sampling_id` /
`greedy_search` — the port of `paddle_tpu/nn/decode.py` (ref
python/paddle/fluid/layers/rnn.py:1034 BeamSearchDecoder, :1496
dynamic_decode).

The JAX package runs the whole beam decode as one `lax.scan` over dense
[batch, beam] state; here it is a Python loop over the same state, on
the device of the cell's inputs, with the same rules: every beam but
beam 0 starts at -1e9, finished beams absorb (only `<eos>` continues
them, at no cost), each step re-ranks the token buffer and the cell
state (any pytree of tensors) by parent, and the final order is by
length-normalised score. Nothing in the loop reads the device from the
host.
"""
import torch

from ..framework import state
from ..framework.tensor import Tensor, unwrap

_NEG_INF = -1e9


def _tree_map(fn, tree):
    """`fn` over the leaves (Tensors and torch tensors) of a tree of
    tuples, namedtuples, lists and dicts."""
    if isinstance(tree, (Tensor, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _first_leaf(tree):
    if isinstance(tree, (Tensor, torch.Tensor)):
        return unwrap(tree)
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


def _gather_beams(x, idx):
    """x: [B, K, ...] -> x[b, idx[b, k]] (re-rank beams)."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(
        idx.shape + x.shape[2:]))


class BeamSearchDecoder:
    """ref fluid/layers/rnn.py BeamSearchDecoder. Wraps a cell (any
    callable (inputs, states) -> (cell_out, new_states)) for beam decode.

    embedding_fn maps token ids -> cell inputs; output_fn maps cell output
    -> vocab logits (defaults to identity, i.e. the cell emits logits)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam_size, ...], each row repeated beam_size
        times in a row (ref rnn.py:1112)."""
        a = unwrap(x)
        return Tensor._wrap(torch.repeat_interleave(a, int(beam_size),
                                                    dim=0))


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Beam-search decode (ref fluid/layers/rnn.py dynamic_decode).

    inits: the initial cell states (a tree of [B, ...] Tensors or torch
    tensors). Returns (ids Tensor [B, max_step_num, K] int32, lengths
    Tensor [B, K] int32): beams sorted best-first, padded with
    end_token after they finish."""
    K = decoder.beam_size
    eos = decoder.end_token
    cell = decoder.cell
    embed = decoder.embedding_fn
    out_fn = decoder.output_fn
    T = int(max_step_num)

    states = _tree_map(lambda a: torch.repeat_interleave(
        unwrap(a)[:, None], K, dim=1), inits)
    lead = _first_leaf(states)
    B, dev = lead.shape[0], lead.device

    # beam 0 live, the others dead, so step 0 expands one beam (device
    # fills and selects only: no host-to-device copy)
    log_probs = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                            _NEG_INF).expand(B, K).contiguous()
    tokens = torch.full((B, K), decoder.start_token, dtype=torch.int32,
                        device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    buf = torch.full((B, K, T), eos, dtype=torch.int32, device=dev)
    eos_only = None

    for t in range(T):
        flat = _tree_map(lambda a: Tensor._wrap(
            a.reshape((B * K,) + tuple(a.shape[2:]))), states)
        inp = Tensor._wrap(tokens.reshape(B * K))
        if embed is not None:
            inp = embed(inp)
        out, new_states = cell(inp, flat)
        logits = unwrap(out_fn(out) if out_fn is not None else out)
        logits = logits.reshape(B, K, -1)
        V = logits.shape[-1]
        # scores in f32, or in f64 for f64 logits
        logp = torch.log_softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), dim=-1)
        if eos_only is None:
            eos_only = torch.where(torch.arange(V, device=dev) == eos, 0.0,
                                   _NEG_INF)
        # finished beams: only <eos> continues, at no added cost
        logp = torch.where(finished[..., None], eos_only, logp)
        scores = log_probs[..., None] + logp                  # [B, K, V]
        top_scores, top_idx = torch.topk(scores.reshape(B, K * V), K,
                                         dim=1)
        parent = torch.div(top_idx, V, rounding_mode="floor")
        token = (top_idx % V).to(torch.int32)
        was_fin = torch.gather(finished, 1, parent)
        prev_len = torch.gather(lengths, 1, parent)
        finished = was_fin | (token == eos)
        lengths = torch.where(was_fin, prev_len, prev_len + 1)
        states = _tree_map(lambda a: _gather_beams(
            unwrap(a).reshape((B, K) + tuple(unwrap(a).shape[1:])),
            parent), new_states)
        buf = _gather_beams(buf, parent)
        buf[:, :, t] = torch.where(was_fin, torch.full_like(token, eos),
                                   token)
        log_probs, tokens = top_scores, token

    # best-first by length-normalised score (the reference's final
    # ranking of finished beams)
    norm = log_probs / torch.clamp(lengths, min=1).to(log_probs.dtype)
    order = torch.argsort(-norm, dim=1, stable=True)
    buf = _gather_beams(buf, order)
    lengths = torch.gather(lengths, 1, order)
    return (Tensor._wrap(buf.transpose(1, 2).contiguous()),
            Tensor._wrap(lengths))


# ----------------------------------------------------------------- sampling

def top_k_top_p_filtering(logits, top_k=0, top_p=1.0):
    """Mask logits outside top-k / nucleus top-p to -1e9, in f32. Top-k
    keeps every logit >= the kth largest; top-p keeps the smallest
    prefix of the sorted row whose cumulative probability reaches p (the
    best token always kept). A Tensor in gives a Tensor out, a torch
    tensor a torch tensor."""
    if isinstance(logits, Tensor):
        return Tensor._wrap(top_k_top_p_filtering(logits._data, top_k,
                                                  top_p))
    a = logits.float()
    neg = torch.full((), _NEG_INF, device=a.device)
    if top_k and top_k > 0:
        kth = torch.topk(a, min(int(top_k), a.shape[-1]), dim=-1).values
        a = torch.where(a < kth[..., -1:], neg, a)
    if top_p is not None and top_p < 1.0:
        sort_idx = torch.argsort(-a, dim=-1, stable=True)
        sorted_a = torch.gather(a, -1, sort_idx)
        probs = torch.softmax(sorted_a, dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        keep_sorted[..., 0] = True
        keep = torch.gather(keep_sorted, -1,
                            torch.argsort(sort_idx, dim=-1))
        a = torch.where(keep, a, neg)
    return a


def gumbel_(buf, gen):
    """Fill `buf` in place with Gumbel(0, 1) noise from `gen`: torch.rand's
    uniform draw, then -log(-log(u))."""
    buf.uniform_(0, 1, generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    return buf.clamp_(min=tiny).log_().neg_().log_().neg_()


def sampling_id(probs, seed=None, key=None):
    """Sample one id per row of probabilities (ref
    operators/sampling_id_op.cc), int32, by the Gumbel-max draw the JAX
    package's `jax.random.categorical` makes. `key` is a torch.Generator
    on the rows' device; else a generator seeded with `seed`; else the
    framework generator. The draws differ from the JAX package's."""
    p = unwrap(probs)
    if key is None:
        if seed is not None:
            key = torch.Generator(device=p.device).manual_seed(int(seed))
        else:
            key = state.rng_generator(p.device)
    g = gumbel_(torch.empty(p.shape, dtype=torch.float32, device=p.device),
                key)
    ids = torch.argmax(torch.log(torch.clamp(p.float(), min=1e-30)) + g,
                       dim=-1)
    return Tensor._wrap(ids.to(torch.int32))


def greedy_search(logits):
    """argmax decode helper: int32 ids."""
    return Tensor._wrap(torch.argmax(unwrap(logits), dim=-1).to(torch.int32))
