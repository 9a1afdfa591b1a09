"""GPT decoder-only LM (the port of `paddle_tpu/nlp/gpt.py`): training
forward and loss, the dense and paged serving methods, and `generate`.

Pre-norm blocks, fused QKV projection, tanh-GELU MLP, LayerNorm eps
1e-5, LM head tied to the word embeddings (`h @ word_embeddings.T`).
The model is an `nn.Layer` built from the port's `nn.Linear`,
`nn.LayerNorm`, `nn.Embedding`, `nn.Dropout` and `nn.LayerList`, as the
JAX package builds it: the same state-dict keys and shapes, Linear
weights in Paddle's [in, out] layout, so a JAX model's `state_dict()`
loads with `set_state_dict` (or `load_jax_state`) as it is, and the
JAX package reads the port's `save` of it. Weights are drawn on the CPU
by the JAX package's initializers (normal(0, initializer_range), the
output projections scaled by 1/sqrt(2 layers), biases 0, LayerNorm
1/0) from a framework generator seeded with `seed`, then moved.

Training: `GPTForPretraining.forward` -> logits, `gpt_pretrain_loss`.
The forward runs in the Paddle surface (port `Tensor`s through the op
dispatcher, so `amp.auto_cast` casts it by the AMP lists), and takes
either kind of tensor: torch ids give torch logits, `Tensor` ids give
`Tensor` logits. Attention is the registered `flash_attention` op: on
the BSHD path q/k/v are strided views of the qkv projection, read by
the kernels in place. Dropout (`nn.Dropout`, attention dropout) draws
from the framework generator of the device. When the fused head is on
(`GPTConfig.fused_head_loss`, or by size), the logits are a
`FusedHeadLogits` over the hidden states and the tied weight;
`gpt_pretrain_loss` takes the vocab-chunked loss
(`ops.chunked_ce.chunked_lm_loss`) from them, and the dense [B, S, V]
head product is computed only if something else reads the logits.

Serving runs on the layers' torch leaves (torch tensors in and out, no
dispatcher): dense, `init_cache` ([B, heads, L, head_dim] x2),
`prefill` (with `frontier=`) and `decode_step` with a scalar or [B]
position. The prefill's attention is `flash_attention` (K1 on the card)
on the BSHD views of the qkv projection: a prompt bucket that is no
multiple of 128 is computed at the next multiple when that fits the
position table (the padded tail is causally masked, so it changes no
position below the bucket), and only the bucket's K/V are written;
otherwise it takes flash_attention's dense route, as the JAX package's
`_flash_array` does (`prefill_route`).

Serving, paged: `init_paged_cache`, `decode_step(..., block_tables=)`,
`prefill_chunk` (with `frontier=`) and `decode_chunk`, the speculative
verify (C tokens for every lane at its own start). The caches and pools
are updated IN PLACE by the scatters; the methods return the same
objects so their signatures match the JAX package's.

`generate` is the model-level decode loop: a full forward per token
(`use_cache=False`) or the KV-cache step (`use_cache=True`), which on
the card replays one CUDA graph per position; the graphs are kept per
model (at most 8 programs), so a caller looping on `generate` captures
once.
"""
import math
import os

import numpy as np
import torch
from torch.nn import functional as TF
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from .. import nn
from ..device import resolve_device
from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..graphs import Program
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.decode import gumbel_, top_k_top_p_filtering
from ..nn.paged_attention import (paged_chunk_attention,
                                  paged_decode_attention)
from ..nn.transformer import (cached_decode_attention, infer_cache_dtype,
                              scatter_block_kv_at,
                              scatter_block_kv_chunk_batched, scatter_kv_at)
from ..ops.chunked_ce import chunked_lm_loss
from ..ops.dispatch import apply
from ..ops.flash_attention import flash_attention, kernel_len
from ..ops.math import matmul


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=None, max_seq_len=1024,
                 dropout=0.1, attn_dropout=0.1, initializer_range=0.02,
                 use_recompute=False, sequence_parallel=False,
                 moe_experts=0, fused_head_loss=None, attn_layout=None,
                 attn_window=None):
        if moe_experts:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP Queue 1, "
                "distributed slice: incubate/moe.py)")
        if sequence_parallel:
            raise NotImplementedError(
                "sequence parallelism is not ported yet (ROADMAP Queue 1, "
                "distributed slice: ring_attention.py / ulysses.py)")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        # torch.utils.checkpoint (non-reentrant) around every block
        self.use_recompute = bool(use_recompute)
        self.sequence_parallel = False
        self.moe_experts = 0
        # vocab-chunked fused head + CE: None = auto by logits size (see
        # _use_fused_head)
        self.fused_head_loss = (None if fused_head_loss is None
                                else bool(fused_head_loss))
        # attention layout: "bshd" (q/k/v are views of the qkv projection,
        # no transposes) or "bhsd"; PT_ATTN_LAYOUT overrides the default
        self.attn_layout = (attn_layout
                            or os.environ.get("PT_ATTN_LAYOUT", "bshd"))
        if self.attn_layout not in ("bshd", "bhsd"):
            raise ValueError(f"attn_layout must be 'bshd' or 'bhsd', got "
                             f"{self.attn_layout!r}")
        # causal sliding-window attention (last W keys per query)
        self.attn_window = None if attn_window is None else int(attn_window)


def gpt2_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def _normal_attr(std):
    return nn.ParamAttr(initializer=I.Normal(0.0, std))


def _out_std(cfg):
    """The output projections' std: initializer_range / sqrt(2 layers)."""
    return cfg.initializer_range / math.sqrt(2 * cfg.num_layers)


# ------------------------------------------- the layers' torch leaves
# (serving runs on these: torch tensors in and out, no dispatcher)

def linear_t(layer, x):
    """x @ W + b of a port `nn.Linear` ([in, out] weight) on its torch
    leaves."""
    b = layer.bias
    return TF.linear(x, layer.weight._data.t(),
                     None if b is None else b._data)


def layer_norm_t(ln, x):
    """A port `nn.LayerNorm` on its torch leaves."""
    return TF.layer_norm(x, tuple(ln._normalized_shape), ln.weight._data,
                         ln.bias._data, ln._epsilon)


def as_tensor_in(x):
    """(x as a port Tensor, whether it came as a torch tensor)."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x), True
    return x, False


class GPTAttention(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv_proj = nn.Linear(h, 3 * h, weight_attr=_normal_attr(
            cfg.initializer_range))
        self.out_proj = nn.Linear(h, h, weight_attr=_normal_attr(
            _out_std(cfg)))
        self.attn_dropout_p = cfg.attn_dropout
        self.attn_layout = cfg.attn_layout
        self.attn_window = cfg.attn_window
        self.resid_dropout = nn.Dropout(cfg.dropout)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape([b, s, 3, self.num_heads,
                                        self.head_dim])
        if self.attn_layout == "bshd" and \
                not (self.attn_dropout_p and self.training):
            # BSHD fast path: q/k/v are strided views of the projection
            # (row stride 3 * H * D); the kernels read them in place
            out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                  causal=True, layout="bshd",
                                  window=self.attn_window)
            return self.resid_dropout(self.out_proj(out.reshape([b, s, h])))
        qkv = qkv.transpose([2, 0, 3, 1, 4])          # [3, B, H, S, D]
        out = flash_attention(
            qkv[0], qkv[1], qkv[2], causal=True, window=self.attn_window,
            dropout_p=self.attn_dropout_p if self.training else 0.0)
        out = out.transpose([0, 2, 1, 3]).reshape([b, s, h])
        return self.resid_dropout(self.out_proj(out))

    def _split_heads(self, x):
        """[B, S, 3H] -> q, k, v each [B, heads, S, head_dim]."""
        b, s, _ = x.shape
        a = linear_t(self.qkv_proj, x).reshape(b, s, 3, self.num_heads,
                                               self.head_dim)
        a = a.permute(2, 0, 3, 1, 4)
        return a[0], a[1], a[2]

    def init_cache(self, batch, max_len, dtype, device):
        """Dense KV cache [B, heads, L, head_dim] x2."""
        shape = (batch, self.num_heads, max_len, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        """Block-pool KV cache [num_blocks, heads, block_size, head_dim]
        x2 — requests claim blocks named by a host-managed table."""
        shape = (num_blocks, self.num_heads, block_size, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def decode(self, x_t, cache, pos, block_tables=None):
        """One-token step for every lane: write K/V at `pos` (a scalar or
        [B]) in place and attend over the cache up to it. With
        block_tables the cache is the block pool: the write goes through
        the tables and attention reads straight out of the pool."""
        b = x_t.shape[0]
        q, k_t, v_t = self._split_heads(x_t)
        ck, cv = cache
        scale = 1.0 / math.sqrt(self.head_dim)
        if block_tables is None:
            scatter_kv_at(ck, k_t, pos)
            scatter_kv_at(cv, v_t, pos)
            out = cached_decode_attention(q, ck, cv, pos, scale,
                                          window=self.attn_window)
        else:
            scatter_block_kv_at(ck, k_t, block_tables, pos)
            scatter_block_kv_at(cv, v_t, block_tables, pos)
            out = paged_decode_attention(q, ck, cv, block_tables, pos,
                                         scale, window=self.attn_window)
        out = out.permute(0, 2, 1, 3).reshape(b, 1, -1)
        return linear_t(self.out_proj, out.to(x_t.dtype))

    def prefill_chunk(self, x, cache, block_tables, chunk_start, valid_len):
        """C tokens a lane, x [S, C, H], at chunk_start + arange(C): one
        prompt chunk (S = 1, a scalar start) or the speculative verify
        (every lane at its own [S] start). Scatter the K/V through the
        tables (positions at or past valid_len go to scratch), then
        attend each query row up to its own position over the pool."""
        b, s, h = x.shape
        q, k, v = self._split_heads(x)
        ck, cv = cache
        scatter_block_kv_chunk_batched(ck, k, block_tables, chunk_start,
                                       valid_len)
        scatter_block_kv_chunk_batched(cv, v, block_tables, chunk_start,
                                       valid_len)
        out = paged_chunk_attention(q, ck, cv, block_tables, chunk_start,
                                    1.0 / math.sqrt(self.head_dim),
                                    window=self.attn_window)
        out = out.permute(0, 2, 1, 3).reshape(b, s, h)
        return linear_t(self.out_proj, out.to(x.dtype))

    def prefill(self, x, cache, n):
        """Prompt-phase step over x [B, C, H] (C a multiple of 128 on the
        kernel route): causal flash attention on the BSHD views of the
        projection, and the K/V of positions [0, n) written into the
        fresh cache, so decode continues at pos = n."""
        b, s, h = x.shape
        qkv = linear_t(self.qkv_proj, x).reshape(b, s, 3, self.num_heads,
                                                 self.head_dim)
        ck, cv = cache
        ck[:, :, :n] = qkv[:, :n, 1].transpose(1, 2).to(ck.dtype)
        cv[:, :, :n] = qkv[:, :n, 2].transpose(1, 2).to(cv.dtype)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=True, layout="bshd",
                              window=self.attn_window)
        return linear_t(self.out_proj, out.reshape(b, s, h))


class GPTMLP(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.ffn_hidden_size,
                               weight_attr=_normal_attr(
                                   cfg.initializer_range))
        self.fc_out = nn.Linear(cfg.ffn_hidden_size, cfg.hidden_size,
                                weight_attr=_normal_attr(_out_std(cfg)))
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))

    def infer(self, x):
        """The MLP on the torch leaves (eval: no dropout)."""
        return linear_t(self.fc_out, TF.gelu(linear_t(self.fc_in, x),
                                             approximate="tanh"))


class GPTBlock(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, epsilon=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, epsilon=1e-5)
        self.mlp = GPTMLP(cfg)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def _mlp(self, x):
        return x + self.mlp.infer(layer_norm_t(self.ln_2, x))

    def decode(self, x, cache, pos, block_tables=None):
        return self._mlp(x + self.attn.decode(layer_norm_t(self.ln_1, x),
                                              cache, pos, block_tables))

    def prefill(self, x, cache, n):
        return self._mlp(x + self.attn.prefill(layer_norm_t(self.ln_1, x),
                                               cache, n))

    def prefill_chunk(self, x, cache, block_tables, chunk_start, valid_len):
        return self._mlp(x + self.attn.prefill_chunk(
            layer_norm_t(self.ln_1, x), cache, block_tables, chunk_start,
            valid_len))


class GPTEmbeddings(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        attr = _normal_attr(cfg.initializer_range)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            weight_attr=attr)
        self.position_embeddings = nn.Embedding(cfg.max_seq_len,
                                                cfg.hidden_size,
                                                weight_attr=attr)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = Tensor._wrap(torch.arange(
                input_ids.shape[-1], dtype=torch.int32,
                device=input_ids._data.device)[None])
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))

    def embed(self, input_ids, position_ids):
        """The embeddings on the torch leaves (eval: no dropout)."""
        return (TF.embedding(input_ids, self.word_embeddings.weight._data)
                + TF.embedding(position_ids,
                               self.position_embeddings.weight._data))


def _recompute(blk, x, gen):
    """blk(x) (a port Tensor) under torch.utils.checkpoint
    (non-reentrant). checkpoint replays only torch's default generators;
    dropout here draws from `gen` (the framework generator of x's device,
    or None when nothing draws): the backward's recompute replays gen's
    state from the first run, so it draws the same masks, and then puts
    gen back."""
    def call(t):
        return blk(Tensor._wrap(t))._data

    if gen is None:
        return Tensor._wrap(checkpoint(call, x._data, use_reentrant=False))
    start = gen.get_state()
    ran = []

    def run(t):
        if not ran:                     # the forward
            ran.append(True)
            return call(t)
        now = gen.get_state()           # the backward's recompute
        gen.set_state(start)
        try:
            return call(t)
        finally:
            gen.set_state(now)
    return Tensor._wrap(checkpoint(run, x._data, use_reentrant=False))


class GPTModel(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        self.blocks = nn.LayerList([GPTBlock(cfg)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, epsilon=1e-5)

    def _position_ids(self, pos):
        """Position-embedding rows, bounded to the table. Live positions
        are < max_len <= max_seq_len and are never moved; only lanes
        outside the wave (parked at max_len) or a chunk's padded tail
        reach past it, and their rows are discarded."""
        return torch.clamp(pos, 0, self.cfg.max_seq_len - 1)

    def forward(self, input_ids, position_ids=None):
        """[B, S] ids -> hidden states [B, S, hidden] (after ln_f; torch
        ids give a torch tensor, Tensors a Tensor). With
        cfg.use_recompute every block is checkpointed (non-reentrant):
        its activations are recomputed in the backward."""
        ids, torch_in = as_tensor_in(input_ids)
        if isinstance(position_ids, torch.Tensor):
            position_ids = Tensor._wrap(position_ids)
        x = self.embeddings(ids, position_ids)
        remat = self.cfg.use_recompute and torch.is_grad_enabled()
        gen = None
        if remat and (self.cfg.dropout or self.cfg.attn_dropout):
            gen = state.rng_generator(x._data.device)
        for blk in self.blocks:
            x = _recompute(blk, x, gen) if remat else blk(x)
        h = self.ln_f(x)
        return h._data if torch_in else h

    def _check_horizon(self, max_len):
        if max_len > self.cfg.max_seq_len:
            raise ValueError(
                f"decode length {max_len} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")

    def init_cache(self, batch, max_len, dtype, device):
        """Per-layer dense caches [B, heads, max_len, hd] x2. max_len
        must fit the position table."""
        self._check_horizon(max_len)
        return [blk.attn.init_cache(batch, max_len, dtype, device)
                for blk in self.blocks]

    def init_paged_cache(self, num_blocks, block_size, max_len, dtype,
                         device):
        """Per-layer block pools [num_blocks, heads, block_size, hd] x2.
        max_len (the per-request horizon) must fit the position table."""
        self._check_horizon(max_len)
        return [blk.attn.init_paged_cache(num_blocks, block_size, dtype,
                                          device)
                for blk in self.blocks]

    def prefill_route(self, n):
        """How a prompt bucket of n tokens is computed: "k1" (flash
        attention's kernel route, at n rounded up to a multiple of 128)
        when that length fits the position table, else "dense"."""
        return "k1" if kernel_len(n) <= self.cfg.max_seq_len else "dense"

    def prefill(self, input_ids, max_len, dtype):
        """Prompt-phase forward over [B, P] ids that also fills fresh
        [B, heads, max_len, hd] caches at positions [0, P). On the "k1"
        route the forward runs at P rounded up to a multiple of 128 (the
        ids padded with 0); the hidden states of [0, P) are returned.
        Returns (h, caches); decode continues at pos = P."""
        b, n = input_ids.shape
        if n > max_len:
            raise ValueError(f"prompt bucket {n} > cache length {max_len}")
        caches = self.init_cache(b, max_len, dtype, input_ids.device)
        c = kernel_len(n) if self.prefill_route(n) == "k1" else n
        x = self.embeddings.embed(
            TF.pad(input_ids, (0, c - n)),
            torch.arange(c, device=input_ids.device)[None])
        for blk, cache in zip(self.blocks, caches):
            x = blk.prefill(x, cache, n)
        return layer_norm_t(self.ln_f, x[:, :n]), caches

    def decode_step(self, tok, caches, pos, block_tables=None):
        """tok: [B, 1] ids; pos: [B] positions (or a scalar, a Python int
        or a device tensor). The caches are dense [B, heads, L, hd], or
        block pools named by block_tables; written in place. Returns
        (h, caches)."""
        pos = torch.as_tensor(pos, device=tok.device).reshape(-1)
        pos_ids = self._position_ids(pos.long()).expand(tok.shape[0])
        x = self.embeddings.embed(tok, pos_ids[:, None])
        for blk, cache in zip(self.blocks, caches):
            x = blk.decode(x, cache, pos, block_tables)
        return layer_norm_t(self.ln_f, x), caches

    def prefill_chunk(self, tok_chunk, caches, block_tables, chunk_start,
                      valid_len):
        """One prompt chunk [1, C] at chunk_start + arange(C) against the
        block pools. Returns (h, caches). `chunk_start` and `valid_len`
        are Python ints or 0-d device tensors; as tensors they are read
        on the device (K4 reads the start in place), so a CUDA graph of
        the chunk replays whatever offset its buffers hold."""
        c = tok_chunk.shape[1]
        pos_ids = chunk_start + torch.arange(c, device=tok_chunk.device)
        x = self.embeddings.embed(tok_chunk,
                                  self._position_ids(pos_ids)[None])
        for blk, cache in zip(self.blocks, caches):
            x = blk.prefill_chunk(x, cache, block_tables, chunk_start,
                                  valid_len)
        return layer_norm_t(self.ln_f, x), caches

    def decode_chunk(self, tok_chunk, caches, block_tables, start,
                     valid_len):
        """Speculative verify: C tokens per lane ([S, C] ids) at
        per-lane positions start[s] + i against the block pools. `start`
        and `valid_len` are [S] device tensors (read on the device, so a
        CUDA graph of the verify replays whatever its buffers hold).
        Position rows past the table are clamped (their K/V go to
        scratch and their logits are never accepted). Returns
        (h, caches)."""
        c = tok_chunk.shape[1]
        start = torch.as_tensor(start, device=tok_chunk.device)
        pos_ids = start.reshape(-1, 1).long() + torch.arange(
            c, device=tok_chunk.device)
        x = self.embeddings.embed(tok_chunk, self._position_ids(pos_ids))
        for blk, cache in zip(self.blocks, caches):
            x = blk.prefill_chunk(x, cache, block_tables, start, valid_len)
        return layer_norm_t(self.ln_f, x), caches


class GPTForPretraining(nn.Layer):
    """GPT with the LM head tied to the word embeddings. The weights are
    drawn on the CPU from a framework generator seeded with `seed` (the
    same weights for one seed on every device), then moved to `device`
    (None = the CUDA card) and cast to `dtype`. Dropout draws from the
    framework generator of the device (`paddle.seed`). The model starts
    in eval mode (serving); call `.train()` to train, or let
    `jit.TrainStep` do it."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        with state.host_init_ctx(int(seed)):
            self.gpt = GPTModel(cfg)
        self.cfg = cfg
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.gpt.ln_f.weight._data.device

    def _head(self, h):
        return h @ self.gpt.embeddings.word_embeddings.weight._data.t()

    def hidden_states(self, input_ids):
        """[B, S] torch ids -> hidden states after ln_f (torch)."""
        return self.gpt(input_ids)

    def head(self, h):
        """Logits [..., vocab] of hidden states h (the tied head)."""
        return self._head(h)

    def check_horizon(self, max_len):
        """Raise when positions [0, max_len) do not fit the position
        table."""
        self.gpt._check_horizon(max_len)

    def init_cache(self, batch, max_len, dtype=torch.float32):
        return self.gpt.init_cache(batch, max_len, dtype, self.device)

    def init_paged_cache(self, num_blocks, block_size, max_len,
                         dtype=torch.float32):
        return self.gpt.init_paged_cache(num_blocks, block_size, max_len,
                                         dtype, self.device)

    def prefill_route(self, n):
        return self.gpt.prefill_route(n)

    @torch.no_grad()
    def decode_step(self, tok, caches, pos, block_tables=None):
        h, caches = self.gpt.decode_step(tok, caches, pos, block_tables)
        return self._head(h), caches

    @torch.no_grad()
    def prefill_chunk(self, tok_chunk, caches, block_tables, chunk_start,
                      valid_len, frontier=None):
        """frontier (index WITHIN the chunk; an int or a 0-d device
        tensor, read on the device): logits for that one position only —
        [1, 1, V] instead of [1, C, V]."""
        h, caches = self.gpt.prefill_chunk(tok_chunk, caches, block_tables,
                                           chunk_start, valid_len)
        if frontier is not None:
            h = h.index_select(1, torch.as_tensor(
                frontier, device=h.device).reshape(1))
        return self._head(h), caches

    def forward(self, input_ids, position_ids=None):
        """[B, S] ids -> logits [B, S, vocab] in the model's dtype (torch
        ids give torch logits, Tensors give a Tensor). When the config
        asks for the fused head (`_use_fused_head`), the logits are a
        `FusedHeadLogits` over the hidden states and the tied weight:
        `gpt_pretrain_loss` computes the vocab-chunked loss from those,
        and the dense head product runs only if something else reads the
        logits."""
        ids, torch_in = as_tensor_in(input_ids)
        h = self.gpt(ids, position_ids)
        w = self.gpt.embeddings.word_embeddings.weight
        if _use_fused_head(self.cfg, (*h.shape[:-1], w.shape[0])):
            logits = Tensor._wrap(FusedHeadLogits(h._data, w._data))
        else:
            logits = matmul(h, w, transpose_y=True)
        return logits._data if torch_in else logits

    def loss(self, logits, labels):
        return gpt_pretrain_loss(logits, labels)

    @torch.no_grad()
    def prefill(self, input_ids, max_len, dtype=torch.float32,
                frontier=None):
        """frontier (an int or a 0-d device tensor, read on the device):
        logits for that one prompt position only — [B, 1, V] instead of
        [B, P, V] over the whole padded bucket."""
        h, caches = self.gpt.prefill(input_ids, max_len, dtype)
        if frontier is not None:
            h = h.index_select(1, torch.as_tensor(
                frontier, device=h.device).reshape(1))
        return self._head(h), caches

    @torch.no_grad()
    def decode_chunk(self, tok_chunk, caches, block_tables, start,
                     valid_len):
        """Speculative verify: logits for ALL C positions of every lane
        ([S, C, V] in the model's dtype — one batched forward scores the
        whole drafted span)."""
        h, caches = self.gpt.decode_chunk(tok_chunk, caches, block_tables,
                                          start, valid_len)
        return self._head(h), caches


# auto threshold for fused_head_loss=None: the fused head would be used
# once the f32 logits exceed this (the JAX package's constant)
CHUNKED_CE_AUTO_BYTES = 2 << 30


def _use_fused_head(cfg, logits_shape):
    if cfg.fused_head_loss is not None:
        return cfg.fused_head_loss
    b, s, v = (int(d) for d in logits_shape)
    return b * s * v * 4 > CHUNKED_CE_AUTO_BYTES


class FusedHeadLogits(torch.Tensor):
    """The logits [B, S, V] of the tied head, `hidden @ weight.T`, not
    yet computed: what `GPTForPretraining.forward` returns when the fused
    head is on (inside a port `Tensor` when the forward was given
    Tensors). `gpt_pretrain_loss` reads `hidden` and `weight` and never
    the product. Shape, dtype and device are answered from the pieces;
    any other use (an op, a method, indexing, printing) computes the
    dense product once (with autograd, so its gradient reaches the
    hidden states and the tied weight) and works on that. `weight` is
    the tensor the forward read, so a `functional_call`'s weight stays
    the one the product and the loss use after the call returns."""

    _METADATA = {torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
                 torch.Tensor.device.__get__, torch.Tensor.ndim.__get__,
                 torch.Tensor.is_cuda.__get__, torch.Tensor.size,
                 torch.Tensor.dim}

    @staticmethod
    def __new__(cls, hidden, weight):
        t = torch.Tensor._make_wrapper_subclass(
            cls, (*hidden.shape[:-1], weight.shape[0]), dtype=hidden.dtype,
            device=hidden.device, requires_grad=False)
        t.hidden, t.weight, t._dense = hidden, weight, None
        return t

    def dense(self):
        """The dense logits, computed at the first call."""
        if self._dense is None:
            self._dense = self.hidden @ self.weight.t()
        return self._dense

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in cls._METADATA:
            args, kwargs = tree_map(
                lambda a: a.dense() if isinstance(a, FusedHeadLogits)
                else a, (args, kwargs))
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # every op is redirected to the dense logits above dispatch
        raise RuntimeError(f"FusedHeadLogits reached {func} unresolved")


def _shifted_labels(labels, b, s):
    """labels[:, 1:] with -1 appended (the ignored last position),
    flattened to [B * S] int64."""
    return torch.cat([labels[:, 1:].long(),
                      torch.full((b, 1), -1, dtype=torch.long,
                                 device=labels.device)], dim=1).reshape(b * s)


def _fused_lm_loss_raw(h, w, labels):
    """The vocab-chunked fused head + loss over the flattened hidden
    states and the tied weight, in chunks of min(4096, V rounded up to
    128) vocab rows, as the JAX package does."""
    b, s = labels.shape
    v = w.shape[0]
    chunk = min(4096, (v + 127) // 128 * 128)
    return chunked_lm_loss(h.reshape(b * s, h.shape[-1]), w,
                           _shifted_labels(labels, b, s), -1, chunk)


def _lm_loss_raw(logits, labels):
    """Cross entropy of logits [B, S, V] against the shifted labels, a
    mean over the valid rows (at least one)."""
    b, s, v = logits.shape
    shifted = _shifted_labels(labels, b, s)
    total = TF.cross_entropy(logits.reshape(b * s, v), shifted,
                             ignore_index=-1, reduction="sum")
    valid = (shifted != -1).sum().clamp(min=1)
    return total / valid.to(total.dtype)


def gpt_pretrain_loss(logits, labels):
    """Next-token cross entropy, averaged over the valid rows. The labels
    are shifted (not the logits): position t is scored against
    labels[t + 1] and the last position is padded with -1 and ignored,
    as `_cross_entropy_raw` with ignore_index=-1 does (a mean over the
    valid rows, at least one).

    `FusedHeadLogits` take the vocab-chunked fused head + loss
    (`chunked_lm_loss`); the dense logits are never computed. Either
    runs through the op dispatcher, as the JAX package's
    `cross_entropy` (so f32 under `auto_cast`) or `chunked_lm_loss`;
    torch logits give a torch loss, Tensors a Tensor."""
    arr, lab = unwrap(logits), unwrap(labels)
    if isinstance(arr, FusedHeadLogits):
        loss = apply(_fused_lm_loss_raw, (arr.hidden, arr.weight, lab),
                     name="chunked_lm_loss")
    else:
        loss = apply(_lm_loss_raw, (arr, lab), name="cross_entropy")
    return loss if isinstance(logits, Tensor) else loss._data


def _host_array(arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes: no torch view
        arr = arr.astype(np.float32)
    return arr


@torch.no_grad()
def load_jax_state(model, state):
    """Copy a JAX model's weights into the port's model, by name, with no
    layout change (both hold Linear weights as [in, out]). `state` is
    {name: array}, as `{k: v.numpy() for k, v in
    jax_model.state_dict().items()}` gives it. Unlike `set_state_dict`,
    raises on a missing key, an extra key or a shape mismatch."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, dst in own.items():
        arr = _host_array(state[name])
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(dst.shape)}")
        dst._data.copy_(torch.tensor(arr))
    return model


@torch.no_grad()
def load_jax_optimizer_state(optimizer, state, model, global_step):
    """Carry a JAX optimizer's per-parameter slots (Adam moments, the
    multi_precision master) into the port's `optimizer`, by parameter
    name, so a resumed run continues the JAX trajectory. `state` is
    {param name: {slot: np.ndarray}}, as a JAX `TrainStep.opt_state`
    holds it; `global_step` is the number of steps taken (the JAX
    TrainStep's `_step_i`). The optimizer must have been built over
    `model`'s parameters. Raises on a name the model does not have."""
    named = dict(model.named_parameters())
    index = {id(p): i for i, p in enumerate(optimizer._parameters)}
    unknown = sorted(set(state) - set(named))
    if unknown:
        raise KeyError(f"optimizer state for unknown parameters {unknown}")
    for name, slots in state.items():
        p = unwrap(named[name])
        if id(p) not in index:
            raise KeyError(f"{name} is not among the optimizer's "
                           "parameters")
        st = optimizer._ensure_state(index[id(p)])
        for slot, arr in slots.items():
            arr = _host_array(arr)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{slot}: shape {tuple(arr.shape)} "
                                 f"!= {tuple(p.shape)}")
            dtype = st[slot].dtype if slot in st else torch.float32
            st[slot] = torch.tensor(arr).to(device=p.device, dtype=dtype)
    optimizer._global_step = int(global_step)
    return optimizer


_GEN_CACHE_MAX = 8     # distinct generate programs kept per model


def _gen_programs(model):
    """The model's cache of generate programs (insertion-ordered, at
    most `_GEN_CACHE_MAX`: the oldest is dropped), kept on the model as
    the JAX package keeps its traced programs."""
    cache = model.__dict__.get("_pt_gen_programs")
    if cache is None:
        cache = model.__dict__["_pt_gen_programs"] = {}
    return cache


class _CachedDecode:
    """One `generate(use_cache=True)` program and the device buffers its
    CUDA graph replays on: the id buffer, the finished flags, the
    position counter, the Gumbel noise, the sampling generator and the
    KV caches. Each call resets them in place and replays."""

    def __init__(self, model, b, L, prompt_len, pick, eos_token_id,
                 cuda_graph):
        dev = model.device
        eos = -1 if eos_token_id is None else int(eos_token_id)
        self.gen = torch.Generator(device=dev)
        self.buf = torch.zeros((b, L), dtype=torch.long, device=dev)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.t = torch.zeros((), dtype=torch.long, device=dev)
        self.noise = torch.empty((b, model.cfg.vocab_size), device=dev)
        self.caches = model.init_cache(b, L, dtype=infer_cache_dtype(model))
        fill = torch.full((), max(eos, 0), dtype=torch.long, device=dev)
        buf, finished, t, caches = self.buf, self.finished, self.t, \
            self.caches

        def step(_):
            # position t -> the token at t + 1: the prompt's teacher-
            # forced, the rest picked from the frontier logits
            tok_t = buf.index_select(1, t.reshape(1))
            logits, _ = model.decode_step(tok_t, caches, t)
            tok = pick(logits[:, 0].float(), self.noise, self.gen)
            t1 = t + 1
            known = buf.index_select(1, (t1 % L).reshape(1))[:, 0]
            nxt = torch.where(t1 < prompt_len, known, tok)
            nxt = torch.where(finished, fill, nxt)
            buf.index_copy_(1, torch.clamp(t1, max=L - 1).reshape(1),
                            nxt[:, None])
            if eos_token_id is not None:
                finished.logical_or_((t1 >= prompt_len) & (nxt == eos))
            t.add_(1)
            return ()

        self.program = Program("generate.decode_step", step, dev, cuda_graph,
                               [self.gen])

    def __call__(self, ids, seed, steps):
        self.buf.zero_()
        self.buf[:, :ids.shape[1]] = ids.to(self.buf.device)
        self.finished.zero_()
        self.t.zero_()
        for ck, cv in self.caches:
            ck.zero_()
            cv.zero_()
        self.gen.manual_seed(int(seed))
        for _ in range(steps):
            self.program(None)
        return self.buf.clone()


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             top_k=0, top_p=1.0, temperature=1.0, eos_token_id=None,
             seed=None, use_cache=False, cuda_graph=True):
    """Autoregressive decode for any causal LM of the port (GPT and
    LLaMA): `hidden_states(ids)`, `head(h)` and `check_horizon(n)`, and
    for use_cache=True init_cache/decode_step (the port of the JAX
    package's `generate`: greedy, or top-k/top-p sampling at a
    temperature).

    Works on a fixed [B, prompt_len + max_new_tokens] id buffer on the
    model's device. use_cache=False runs the causal forward over the
    whole buffer per new token and applies the head to the frontier row
    only.
    use_cache=True runs the KV-cache step over every position, the
    prompt's teacher-forced from the buffer, with caches in the
    parameters' majority dtype; on the card each position is one replay
    of one CUDA graph of that step (`cuda_graph=False` runs it eagerly),
    whose position counter lives on the device. The program and its
    buffers are kept on the model, one per (shape, knobs, weights)
    signature and at most 8 (the oldest dropped), so a later call with
    the same signature replays the graph it captured. Sampling draws
    Gumbel noise from a `torch.Generator` seeded with `seed` (None: a
    seed drawn from torch's global generator), so a seed replays its
    ids; it does not reproduce JAX's bits.

    Returns int64 ids [B, prompt_len + max_new_tokens] (prompt included),
    padded with eos after finish when eos_token_id is given. The model's
    training mode is restored afterwards."""
    dev = model.device
    ids = unwrap(input_ids) if isinstance(input_ids, (Tensor, torch.Tensor)) \
        else torch.as_tensor(np.asarray(input_ids))
    ids = ids.long()
    b, prompt_len = ids.shape
    L = prompt_len + int(max_new_tokens)
    model.check_horizon(L)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    if seed is None:
        seed = int(torch.randint(0, 2 ** 62, ()).item())

    def pick(lo, noise, gen):
        if temperature and temperature != 1.0:
            lo = lo / temperature
        if not do_sample:
            return torch.argmax(lo, dim=-1)
        lo = top_k_top_p_filtering(lo, top_k=top_k, top_p=top_p)
        return torch.argmax(lo + gumbel_(noise, gen), dim=-1)

    was_training = model.training
    model.eval()
    try:
        if not use_cache:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            noise = torch.empty((b, model.cfg.vocab_size), device=dev)
            buf = torch.zeros((b, L), dtype=torch.long, device=dev)
            buf[:, :prompt_len] = ids.to(dev)
            finished = torch.zeros((b,), dtype=torch.bool, device=dev)
            fill = torch.full((), max(eos, 0), dtype=torch.long, device=dev)
            for t in range(prompt_len, L):
                h = model.hidden_states(buf)[:, t - 1]
                tok = torch.where(finished, fill,
                                  pick(model.head(h).float(), noise, gen))
                buf[:, t] = tok
                if eos_token_id is not None:
                    finished |= tok == eos
            return buf
        # the weights' addresses and dtypes are part of the signature: a
        # captured graph reads the tensors it was captured on
        weights = tuple((unwrap(p).data_ptr(), unwrap(p).dtype)
                        for p in model.parameters())
        spec = (b, L, prompt_len, bool(do_sample), int(top_k), float(top_p),
                float(temperature), eos, bool(cuda_graph), str(dev), weights)
        programs = _gen_programs(model)
        run = programs.get(spec)
        if run is None:
            run = programs[spec] = _CachedDecode(
                model, b, L, prompt_len, pick, eos_token_id, cuda_graph)
            while len(programs) > _GEN_CACHE_MAX:
                programs.pop(next(iter(programs)))
        return run(ids, seed, L - 1)
    finally:
        if was_training:
            model.train()


gpt_generate = generate      # the JAX package's other name for it
