"""LLaMA-family decoder LM (the port of `paddle_tpu/nlp/llama.py`):
RMSNorm, interleaved-pair RoPE, grouped-query attention, SwiGLU.

Pre-norm blocks, a fused QKV projection sized for GQA
(`[q: heads * hd | k: kv_heads * hd | v: kv_heads * hd]`), no biases, the
LM head tied to the token embeddings unless `tie_embeddings=False` (then
an untied `lm_head`). The model is an `nn.Layer` built as the JAX
package builds it, with its state-dict keys and shapes and Paddle's
[in, out] Linear layout (`model.layers.0.self_attn.qkv_proj.weight`,
...), so a JAX model's `state_dict()` loads with `set_state_dict` or
`load_jax_state` as it is. Weights are drawn on the CPU from a framework
generator seeded with `seed` (normal(0, initializer_range); o_proj and
down_proj scaled by 1/sqrt(2 layers); RMSNorm weights 1), then moved.

RoPE: one cos/sin table pair per model ([max_seq_len, head_dim / 2],
built with numpy in f64 and cast to f32, as the JAX package builds it),
held by the model's `rope`, a plain `torch.nn.Module` beside the
layers: no state-dict key, no Parameter, and the tables follow the
model's device and stay f32 under `to(dtype=...)`. Every gather of a
table row is clamped to the table on the device: lanes parked at the
horizon and a chunk's padded tail reach past it, and their rows are
never used.

Training: `LlamaForCausalLM.forward` -> logits (`FusedHeadLogits` when
the tied head is fused), `llama_pretrain_loss`. The forward runs in the
Paddle surface (the registered `rms_norm` and `llama_attention` ops, as
the JAX package's does; torch ids give torch logits, Tensors a Tensor).
Attention rotates q and k in f32, repeats each KV head `heads /
kv_heads` times along the head axis (query head j reads KV head j //
rep) and runs
`ops.flash_attention` causal, K1 on the card, K2, K3 and dd in its
backward; autograd sums dK/dV over each group through the repeat.

Tensor parallelism: inside an mp scope (a train step over a mesh with
'mp' > 1, `distributed.parallel_layers`) each rank computes
`heads / mp` query heads over `kv_heads / mp` KV heads (the QKV
projection cut by heads in each of q, k and v; `kv_heads % mp != 0`
raises ValueError), o_proj and down_proj are row-parallel, gate and up
column-parallel, the token embedding vocab-parallel and the untied
`lm_head` column-parallel, its logits the rank's vocab shard.

Serving runs on the layers' torch leaves. Dense: `init_cache` ([B,
kv_heads, L, hd] x2), `prefill` (with `frontier=`; the bucket padded to
a multiple of 128 on the "k1" route,
`prefill_route`) and `decode_step` with a scalar or [B] position.
Serving, paged: `init_paged_cache`, `decode_step(..., block_tables=)`
(K4's decode form), `prefill_chunk` and `decode_chunk` (its chunk form).
The caches and pools are updated IN PLACE; the methods return the same
objects.
"""
import math
import os

import numpy as np
import torch
from torch.nn import functional as TF

from .. import nn
from ..device import resolve_device
from ..distributed import parallel_layers as tp
from ..distributed.mesh import MP_AXIS, PartitionSpec
from ..framework import state
from ..nn import functional as F
from ..nn.paged_attention import (paged_chunk_attention,
                                  paged_decode_attention)
from ..nn.transformer import (cached_decode_attention, scatter_block_kv_at,
                              scatter_block_kv_chunk_batched, scatter_kv_at)
from ..ops.dispatch import apply, register_op
from ..ops.flash_attention import flash_attention, kernel_len
from ..incubate.recompute import recompute
from .gpt import (_normal_attr, _out_std, as_tensor_in, gpt_pretrain_loss,
                  linear_t, tied_head)


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=768,
                 intermediate_size=None, num_layers=12, num_heads=12,
                 num_kv_heads=None, max_seq_len=2048, rope_theta=10000.0,
                 rms_eps=1e-6, initializer_range=0.02,
                 use_recompute=False, tie_embeddings=True,
                 attn_layout=None, fused_head_loss=None,
                 attn_window=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        # LLaMA sizing: 2/3 * 4h rounded down; callers may pass exact values
        self.intermediate_size = intermediate_size or int(8 * hidden_size / 3)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads   # GQA when smaller
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.rms_eps = rms_eps
        self.initializer_range = initializer_range
        # incubate.recompute (non-reentrant checkpoint) around every block
        self.use_recompute = bool(use_recompute)
        # attention layout: "bshd" (no transposes) or "bhsd";
        # PT_ATTN_LAYOUT overrides the default
        self.attn_layout = (attn_layout
                            or os.environ.get("PT_ATTN_LAYOUT", "bshd"))
        if self.attn_layout not in ("bshd", "bhsd"):
            raise ValueError(f"attn_layout must be 'bshd' or 'bhsd', got "
                             f"{self.attn_layout!r}")
        # vocab-chunked fused head + CE: None = auto by logits size
        self.fused_head_loss = (None if fused_head_loss is None
                                else bool(fused_head_loss))
        # causal sliding-window attention (last W keys per query)
        self.attn_window = None if attn_window is None else int(attn_window)
        self.tie_embeddings = tie_embeddings
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {self.num_kv_heads}")


def _rms_norm_raw(x_, w, eps=1e-6):
    """RMSNorm with the statistics and the product in f32, the result in
    x's dtype."""
    xf = x_.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x_.dtype)


register_op("rms_norm", _rms_norm_raw)


class RMSNorm(nn.Layer):
    """Root-mean-square norm (no mean subtraction, no bias):
    x / sqrt(mean(x^2) + eps) * weight, the statistics and the product in
    f32, the result in x's dtype (the registered `rms_norm` op)."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = self.create_parameter(
            [dim], default_initializer=nn.initializer.Constant(1.0))

    def forward(self, x):
        return apply(_rms_norm_raw, (x, self.weight), {"eps": float(self.eps)},
                     name="rms_norm")

    def infer(self, x):
        """The norm on the torch leaf."""
        return _rms_norm_raw(x, self.weight._data, self.eps)


def rope_tables(seq_len, head_dim, theta=10000.0):
    """cos/sin tables [S, D/2] in f32, computed in f64 with numpy and
    rounded once (the same table in torch f32, `t * inv`, drifts at
    large positions)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(seq_len), inv)          # [S, D/2]
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)),
            torch.from_numpy(np.sin(freqs).astype(np.float32)))


def _rotate_pairs(x, c, sn):
    """Rotate the interleaved pairs (x[2i], x[2i+1]) of x's last dim by
    the cos/sin rows c/sn (broadcastable to [..., D/2]) in f32, cast
    back (not the rotate_half convention)."""
    d = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    y = torch.stack([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


def _table_rows(table, positions):
    """Rows of a rope table at `positions`, clamped to the table."""
    return table[torch.clamp(positions, 0, table.shape[0] - 1)]


def _rope_range(x, cos, sin, pos_offset, head_axis):
    """RoPE over the contiguous position range pos_offset + arange(S);
    head_axis 1 ([B, H, S, D]) or 2 ([B, S, H, D]). A Python int offset
    is range-checked; a tensor offset is clamped as a start, so the
    range stays inside the table (JAX's dynamic_slice). The positions
    are made on the table's device (capturable in a CUDA graph)."""
    seq_axis = 3 - head_axis
    s_len, n = x.shape[seq_axis], cos.shape[0]
    pos = torch.arange(s_len, device=cos.device)
    if isinstance(pos_offset, int):
        if pos_offset + s_len > n:
            raise ValueError(
                f"RoPE positions [{pos_offset}, {pos_offset + s_len}) "
                f"exceed the table length {n} (raise max_seq_len)")
        pos = pos + pos_offset
    else:
        pos = pos + torch.clamp(torch.as_tensor(pos_offset,
                                                device=cos.device),
                                0, max(n - s_len, 0)).long()
    shape = [1, 1, 1, cos.shape[1]]
    shape[seq_axis] = s_len
    return _rotate_pairs(x, cos[pos].reshape(shape), sin[pos].reshape(shape))


def apply_rope_bshd(x, cos, sin, pos_offset=0):
    """x: [B, S, H, D]."""
    return _rope_range(x, cos, sin, pos_offset, head_axis=2)


def apply_rope(x, cos, sin, pos_offset=0):
    """x: [B, H, S, D]."""
    return _rope_range(x, cos, sin, pos_offset, head_axis=1)


def apply_rope_positions(x, cos, sin, positions):
    """x: [B, H, C, D] rotated at absolute positions: a [C] vector (every
    lane at the same offsets) or a [B, C] matrix (each lane its own; a
    [1, C] one broadcasts). Positions past the table take its last
    row."""
    c, sn = _table_rows(cos, positions), _table_rows(sin, positions)
    if positions.dim() == 2:
        return _rotate_pairs(x, c[:, None], sn[:, None])
    return _rotate_pairs(x, c, sn)


def apply_rope_at(x, cos, sin, pos):
    """x: [B, H, 1, D], each lane rotated at its own position pos[b]."""
    c, sn = _table_rows(cos, pos), _table_rows(sin, pos)
    return _rotate_pairs(x, c[:, None, None], sn[:, None, None])


class RoPE(torch.nn.Module):
    """A model's one pair of rope tables, as non-persistent buffers of a
    plain torch module (the `Layer`s skip it): no state-dict key, and
    `.to()` moves them but keeps them f32."""

    def __init__(self, seq_len, head_dim, theta):
        super().__init__()
        cos, sin = rope_tables(seq_len, head_dim, theta)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def _apply(self, fn, recurse=True):
        dev = fn(self.cos[:0]).device       # where fn sends the tables
        self.cos, self.sin = self.cos.to(dev), self.sin.to(dev)
        return self

    @property
    def length(self):
        return self.cos.shape[0]


def _lane_positions(start, b, c, device):
    """[B, C] int64 positions start + i from a scalar or [B] start (a
    Python int or a device tensor, read on the device)."""
    s = torch.as_tensor(start, device=device).reshape(-1, 1).long()
    return (s + torch.arange(c, device=device)).expand(b, c)


def _gqa_flash_bshd(q, k, v, window):
    """KV heads repeated along the head axis, then causal flash attention
    over [B, S, H, D]."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return flash_attention(q, k, v, causal=True, layout="bshd",
                           window=window)


class LlamaAttention(nn.Layer):
    def __init__(self, cfg, rope):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = h // cfg.num_heads
        self.attn_layout = cfg.attn_layout
        self.attn_window = cfg.attn_window
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * self.head_dim
        self.qkv_proj = nn.Linear(h, qkv_out, bias_attr=False,
                                  weight_attr=_normal_attr(
                                      cfg.initializer_range))
        self.o_proj = nn.Linear(cfg.num_heads * self.head_dim, h,
                                bias_attr=False,
                                weight_attr=_normal_attr(_out_std(cfg)))
        # the model's one table, not a sublayer of every layer
        self.__dict__["rope"] = rope
        # Megatron 'mp' split by heads: q, k and v each cut into whole
        # heads (GQA: kv_heads % mp == 0), o_proj row-parallel
        tp.shard_hint(self.qkv_proj.weight, PartitionSpec(None, MP_AXIS),
                      (self.num_heads, self.num_kv_heads, self.num_kv_heads),
                      self.head_dim, strict=True)
        tp.shard_hint(self.o_proj.weight, PartitionSpec(MP_AXIS, None),
                      (self.num_heads,), self.head_dim, strict=True)

    def _split(self, x):
        """x [B, S, hidden] -> q [B, S, H, D], k and v [B, S, Hkv, D]:
        views of the projection, split by sizes."""
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = linear_t(self.qkv_proj, x).split(
            [nh * hd, nkv * hd, nkv * hd], dim=-1)
        return (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
                v.reshape(b, s, nkv, hd))

    def _split_rope_bshd(self, x):
        """q, k (rotated at positions [0, S)) and v, [B, S, *, D]."""
        cos, sin = self.rope.cos, self.rope.sin
        q, k, v = self._split(x)
        return apply_rope_bshd(q, cos, sin), apply_rope_bshd(k, cos, sin), v

    def _rotated(self, x, positions):
        """q [B, H, C, D], k and v [B, Hkv, C, D] of x [B, C, hidden], q
        and k rotated at positions [B, C]."""
        cos, sin = self.rope.cos, self.rope.sin
        q, k, v = (t.transpose(1, 2) for t in self._split(x))
        return (apply_rope_positions(q, cos, sin, positions),
                apply_rope_positions(k, cos, sin, positions), v)

    def forward(self, x):
        """x [B, S, hidden] (a Tensor) through the registered
        `llama_attention` op, then o_proj. Inside an mp scope, the
        rank's heads, the output summed over the slice."""
        mp = tp.current_mp()
        if not tp.is_split(self.qkv_proj.weight, mp):
            mp = None
        n = mp.size if mp else 1
        out = apply(_llama_attention_raw,
                    (tp.copy_to_mp(x, mp), self.qkv_proj.weight,
                     self.rope.cos, self.rope.sin),
                    {"num_heads": self.num_heads // n,
                     "num_kv_heads": self.num_kv_heads // n,
                     "head_dim": self.head_dim,
                     "attn_layout": self.attn_layout,
                     "window": self.attn_window},
                    name="llama_attention")
        if mp is None:
            return self.o_proj(out)
        return tp.row_linear(self.o_proj, out, mp)

    def init_cache(self, batch, max_len, dtype, device):
        """Dense KV cache [B, kv_heads, L, head_dim] x2 (GQA caches the
        KV heads only)."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        """Block-pool KV cache [num_blocks, kv_heads, block_size, hd] x2."""
        shape = (num_blocks, self.num_kv_heads, block_size, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def decode(self, x_t, cache, pos, block_tables=None):
        """One token a lane at `pos` (a scalar or [B]): RoPE there, K/V
        written in place, attention over the cache up to it; through the
        block tables when the cache is the pool."""
        b = x_t.shape[0]
        q, k_t, v_t = self._rotated(x_t, _lane_positions(pos, b, 1,
                                                         x_t.device))
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
        out = out.transpose(1, 2).reshape(b, 1, -1)
        return linear_t(self.o_proj, out.to(x_t.dtype))

    def prefill_chunk(self, x, cache, block_tables, chunk_start, valid_len):
        """C tokens a lane, x [S, C, hidden], at chunk_start + arange(C):
        one prompt chunk (S = 1, a scalar start) or the speculative
        verify (each lane at its own [S] start). The K/V scatter through
        the tables (positions at or past valid_len go to scratch); each
        query row attends up to its own position over the pool."""
        b, s, _ = x.shape
        q, k, v = self._rotated(x, _lane_positions(chunk_start, b, s,
                                                   x.device))
        ck, cv = cache
        scatter_block_kv_chunk_batched(ck, k, block_tables, chunk_start,
                                       valid_len)
        scatter_block_kv_chunk_batched(cv, v, block_tables, chunk_start,
                                       valid_len)
        out = paged_chunk_attention(q, ck, cv, block_tables, chunk_start,
                                    1.0 / math.sqrt(self.head_dim),
                                    window=self.attn_window)
        out = out.transpose(1, 2).reshape(b, s, -1)
        return linear_t(self.o_proj, out.to(x.dtype))

    decode_chunk = prefill_chunk

    def prefill(self, x, cache, n):
        """Prompt-phase step over x [B, C, hidden] at positions [0, C):
        causal flash attention, and the K/V of positions [0, n) written
        into the fresh cache, so decode continues at pos = n."""
        b, s, _ = x.shape
        q, k, v = self._split_rope_bshd(x)
        ck, cv = cache
        ck[:, :, :n] = k[:, :n].transpose(1, 2).to(ck.dtype)
        cv[:, :, :n] = v[:, :n].transpose(1, 2).to(cv.dtype)
        out = _gqa_flash_bshd(q, k, v, self.attn_window)
        return linear_t(self.o_proj, out.reshape(b, s, -1).to(x.dtype))


class LlamaMLP(nn.Layer):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        attr = _normal_attr(cfg.initializer_range)
        self.gate_proj = nn.Linear(h, m, bias_attr=False, weight_attr=attr)
        self.up_proj = nn.Linear(h, m, bias_attr=False, weight_attr=attr)
        self.down_proj = nn.Linear(m, h, bias_attr=False,
                                   weight_attr=_normal_attr(_out_std(cfg)))
        tp.shard_hint(self.gate_proj.weight, PartitionSpec(None, MP_AXIS))
        tp.shard_hint(self.up_proj.weight, PartitionSpec(None, MP_AXIS))
        tp.shard_hint(self.down_proj.weight, PartitionSpec(MP_AXIS, None))

    def forward(self, x):
        mp = tp.current_mp()
        if not tp.is_split(self.gate_proj.weight, mp):
            return self.down_proj(F.silu(self.gate_proj(x))
                                  * self.up_proj(x))
        x = tp.copy_to_mp(x, mp)
        return tp.row_linear(self.down_proj,
                             F.silu(self.gate_proj(x)) * self.up_proj(x), mp)

    def infer(self, x):
        """SwiGLU on the torch leaves."""
        return linear_t(self.down_proj, TF.silu(linear_t(self.gate_proj, x))
                        * linear_t(self.up_proj, x))


class LlamaBlock(nn.Layer):
    def __init__(self, cfg, rope):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg, rope)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def _mlp(self, x):
        return x + self.mlp.infer(self.post_attention_layernorm.infer(x))

    def decode(self, x, cache, pos, block_tables=None):
        return self._mlp(x + self.self_attn.decode(
            self.input_layernorm.infer(x), cache, pos, block_tables))

    def prefill(self, x, cache, n):
        return self._mlp(x + self.self_attn.prefill(
            self.input_layernorm.infer(x), cache, n))

    def prefill_chunk(self, x, cache, block_tables, chunk_start, valid_len):
        return self._mlp(x + self.self_attn.prefill_chunk(
            self.input_layernorm.infer(x), cache, block_tables, chunk_start,
            valid_len))


class LlamaModel(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size,
            weight_attr=_normal_attr(cfg.initializer_range))
        tp.shard_hint(self.embed_tokens.weight, PartitionSpec(MP_AXIS, None))
        self.rope = RoPE(cfg.max_seq_len, cfg.hidden_size // cfg.num_heads,
                         cfg.rope_theta)
        self.layers = nn.LayerList([LlamaBlock(cfg, self.rope)
                                    for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, input_ids):
        """[B, S] ids -> hidden states [B, S, hidden] (after the final
        norm; torch ids give a torch tensor, Tensors a Tensor). With
        cfg.use_recompute every block is checkpointed."""
        ids, torch_in = as_tensor_in(input_ids)
        mp = tp.current_mp()
        if tp.is_split(self.embed_tokens.weight, mp):
            x = tp.vocab_parallel_embedding(ids, self.embed_tokens.weight,
                                            mp)
        else:
            x = self.embed_tokens(ids)
        remat = self.cfg.use_recompute and torch.is_grad_enabled()
        for blk in self.layers:
            x = recompute(blk, x, preserve_rng_state=False) if remat \
                else blk(x)
        h = self.norm(x)
        return h._data if torch_in else h

    def _embed(self, ids):
        return TF.embedding(ids, self.embed_tokens.weight._data)

    def check_horizon(self, max_len):
        if max_len > self.rope.length:
            raise ValueError(f"decode length {max_len} exceeds the RoPE "
                             f"table ({self.rope.length}); raise "
                             "max_seq_len")

    def init_cache(self, batch, max_len, dtype, device):
        """Per-layer dense caches [B, kv_heads, max_len, hd] x2; max_len
        must fit the rope table."""
        self.check_horizon(max_len)
        return [blk.self_attn.init_cache(batch, max_len, dtype, device)
                for blk in self.layers]

    def init_paged_cache(self, num_blocks, block_size, max_len, dtype,
                         device):
        """Per-layer block pools [num_blocks, kv_heads, block_size, hd]
        x2; max_len (the per-request horizon) must fit the rope table."""
        self.check_horizon(max_len)
        return [blk.self_attn.init_paged_cache(num_blocks, block_size,
                                               dtype, device)
                for blk in self.layers]

    def prefill_route(self, n):
        """"k1" (flash attention's kernel route, at n rounded up to a
        multiple of 128) when that length fits the rope table, else
        "dense"."""
        return "k1" if kernel_len(n) <= self.cfg.max_seq_len else "dense"

    def prefill(self, input_ids, max_len, dtype):
        """Prompt-phase forward over [B, P] ids that also fills fresh
        [B, kv_heads, max_len, hd] caches at positions [0, P); on the
        "k1" route at P rounded up to a multiple of 128 (the ids padded
        with 0). Returns (h of [0, P), caches)."""
        b, n = input_ids.shape
        if n > max_len:
            raise ValueError(f"prompt bucket {n} > cache length {max_len}")
        caches = self.init_cache(b, max_len, dtype, input_ids.device)
        c = kernel_len(n) if self.prefill_route(n) == "k1" else n
        x = self._embed(TF.pad(input_ids, (0, c - n)))
        for blk, cache in zip(self.layers, caches):
            x = blk.prefill(x, cache, n)
        return self.norm.infer(x[:, :n]), caches

    def decode_step(self, tok, caches, pos, block_tables=None):
        """tok: [B, 1] ids; pos: [B] positions or a scalar. Returns
        (h, caches); the caches (dense, or pools named by block_tables)
        are written in place."""
        x = self._embed(tok)
        for blk, cache in zip(self.layers, caches):
            x = blk.decode(x, cache, pos, block_tables)
        return self.norm.infer(x), caches

    def prefill_chunk(self, tok_chunk, caches, block_tables, chunk_start,
                      valid_len):
        """C tokens a lane ([S, C] ids) at chunk_start + arange(C)
        against the block pools: a prompt chunk (scalar start) or the
        speculative verify ([S] starts). Returns (h, caches)."""
        x = self._embed(tok_chunk)
        for blk, cache in zip(self.layers, caches):
            x = blk.prefill_chunk(x, cache, block_tables, chunk_start,
                                  valid_len)
        return self.norm.infer(x), caches

    decode_chunk = prefill_chunk


class LlamaForCausalLM(nn.Layer):
    """LLaMA with the LM head tied to the token embeddings (or an untied
    `lm_head`). The weights are drawn on the CPU from a framework
    generator seeded with `seed`, then moved to `device` (None = the
    CUDA card) and cast to `dtype`; the rope tables stay f32. The model
    starts in eval mode (serving); `jit.TrainStep` puts it in training
    mode."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        with state.host_init_ctx(int(seed)):
            self.model = LlamaModel(cfg)
            if not cfg.tie_embeddings:
                self.lm_head = nn.Linear(
                    cfg.hidden_size, cfg.vocab_size, bias_attr=False,
                    weight_attr=_normal_attr(cfg.initializer_range))
                # column-parallel: the rank's vocab shard of the logits
                tp.shard_hint(self.lm_head.weight,
                              PartitionSpec(None, MP_AXIS))
        self.cfg = cfg
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.model.norm.weight._data.device

    def _head(self, h):
        if self.cfg.tie_embeddings:
            return h @ self.model.embed_tokens.weight._data.t()
        return linear_t(self.lm_head, h)

    def hidden_states(self, input_ids):
        """[B, S] torch ids -> hidden states after the final norm
        (torch)."""
        return self.model(input_ids)

    def head(self, h):
        """Logits [..., vocab] of hidden states h."""
        return self._head(h)

    def check_horizon(self, max_len):
        """Raise when positions [0, max_len) do not fit the rope table."""
        self.model.check_horizon(max_len)

    def forward(self, input_ids):
        """[B, S] ids -> logits [B, S, vocab] (torch ids give torch
        logits, Tensors a Tensor); a `FusedHeadLogits` when the head is
        tied and the config asks for the fused head."""
        ids, torch_in = as_tensor_in(input_ids)
        h = self.model(ids)
        if self.cfg.tie_embeddings:
            logits = tied_head(self.cfg, h, self.model.embed_tokens.weight)
        else:
            mp = tp.current_mp()
            if tp.is_split(self.lm_head.weight, mp):
                logits = tp.mark_vocab_parallel(
                    self.lm_head(tp.copy_to_mp(h, mp)), mp)
            else:
                logits = self.lm_head(h)
        return logits._data if torch_in else logits

    def loss(self, logits, labels):
        return llama_pretrain_loss(logits, labels)

    def init_cache(self, batch, max_len, dtype=torch.float32):
        return self.model.init_cache(batch, max_len, dtype, self.device)

    def init_paged_cache(self, num_blocks, block_size, max_len,
                         dtype=torch.float32):
        return self.model.init_paged_cache(num_blocks, block_size, max_len,
                                           dtype, self.device)

    def prefill_route(self, n):
        return self.model.prefill_route(n)

    @torch.no_grad()
    def decode_step(self, tok, caches, pos, block_tables=None):
        h, caches = self.model.decode_step(tok, caches, pos, block_tables)
        return self._head(h), caches

    @torch.no_grad()
    def prefill_chunk(self, tok_chunk, caches, block_tables, chunk_start,
                      valid_len, frontier=None):
        """frontier (an index within the chunk; an int or a 0-d device
        tensor): logits for that one position only, [1, 1, V]."""
        h, caches = self.model.prefill_chunk(tok_chunk, caches,
                                             block_tables, chunk_start,
                                             valid_len)
        if frontier is not None:
            h = h.index_select(1, torch.as_tensor(
                frontier, device=h.device).reshape(1))
        return self._head(h), caches

    @torch.no_grad()
    def decode_chunk(self, tok_chunk, caches, block_tables, start,
                     valid_len):
        """Speculative verify: logits for all C positions of every lane,
        [S, C, V]."""
        h, caches = self.model.decode_chunk(tok_chunk, caches, block_tables,
                                            start, valid_len)
        return self._head(h), caches

    @torch.no_grad()
    def prefill(self, input_ids, max_len, dtype=torch.float32,
                frontier=None):
        """frontier (an int or a 0-d device tensor): logits for that one
        prompt position only, [B, 1, V]."""
        h, caches = self.model.prefill(input_ids, max_len, dtype)
        if frontier is not None:
            h = h.index_select(1, torch.as_tensor(
                frontier, device=h.device).reshape(1))
        return self._head(h), caches


def llama_pretrain_loss(logits, labels):
    """The label-shift cross entropy of `gpt_pretrain_loss`, the fused
    head included."""
    return gpt_pretrain_loss(logits, labels)


# ------------------------------------------------- the registered attention
# (the JAX package's `llama_attention`, run by the op library's
# dispatcher on the Tensor surface)

def _llama_attention_raw(x, wqkv, cos, sin, num_heads=1, num_kv_heads=1,
                         head_dim=1, attn_layout="bhsd", window=None):
    """One fused GQA attention: x @ wqkv ([hidden, (nh + 2 nkv) hd]), RoPE
    from the cos/sin table inputs (held without gradient), each KV head
    repeated nh / nkv times, then causal flash attention in the `bshd` or
    `bhsd` layout (K1 forward, dd, K2 and K3 backward on the card)."""
    nh, nkv, hd = num_heads, num_kv_heads, head_dim
    cos, sin = cos.detach(), sin.detach()
    b, s, _ = x.shape
    q, k, v = (x @ wqkv).split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    q, k, v = (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
               v.reshape(b, s, nkv, hd))
    if attn_layout == "bshd":
        out = _gqa_flash_bshd(apply_rope_bshd(q, cos, sin),
                              apply_rope_bshd(k, cos, sin), v, window)
        return out.reshape(b, s, nh * hd)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    out = flash_attention(q, k, v, causal=True, window=window)
    return out.transpose(1, 2).reshape(b, s, nh * hd)


register_op("llama_attention", _llama_attention_raw)
