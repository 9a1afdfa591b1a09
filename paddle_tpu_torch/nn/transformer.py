"""The Transformer stack and the KV-cache primitives — the port of
`paddle_tpu/nn/transformer.py` (ref python/paddle/nn/layer/
transformer.py:115-1094).

The layers: `MultiHeadAttention`, `TransformerEncoderLayer`,
`TransformerEncoder`, `TransformerDecoderLayer`, `TransformerDecoder` and
`Transformer`, with the JAX package's state-dict keys. Their attention
core is the registered `flash_attention` op: without a mask, a cache or
`need_weights`, `MultiHeadAttention` feeds it [B, S, H, D] views of the
projections (`attn_layout="bshd"`, the default), which is K1 forward
and dd, K2 and K3 backward on the card when both lengths are multiples
of 128 and there is no attention dropout; otherwise it goes through
`scaled_dot_product_attention` in [B, H, S, D], where a mask or dropout
takes the dense route, as in the JAX package.

The primitives (the serving subset): the dense cache's per-row scatter
(`scatter_kv_at`) and the paged cache's (one token per lane; a chunk of
tokens per lane, for the prefill and the speculative verify), and the
dense attention cores they feed.

The pool is `[num_blocks, Hkv, block_size, D]`; a request's cache is the
ordered sequence of pool blocks named by its block TABLE (int32 ids,
host-managed by `serving.paged.BlockPool`). Block 0 is the scratch
block: lanes outside the wave and padded chunk tails are redirected
there, its contents are garbage by design and never read at an attended
position.

JAX clamps or drops an out-of-range gather/scatter index; on the card an
out-of-range index is a device-side assert. Every table lookup below is
therefore bounded explicitly, and the bound is chosen so that it never
changes which rows a live lane writes (see each function).

The scatters update the pools IN PLACE (`index_put_`) and return them:
there is no donation in PyTorch, the engines simply keep mutating the
same tensors.
"""
import collections
import math

import torch

from ..framework.tensor import Tensor, unwrap
from ..ops.dispatch import apply
from . import functional as F
from .layer import Layer, LayerList
from .layers_common import Dropout, Linear
from .norm import LayerNorm


def _positions(pos, b, device):
    """[B] int64 positions from a Python int, a 0-d tensor or a [B]
    tensor (the scalar is the lockstep broadcast of the vector form)."""
    pos = torch.as_tensor(pos, device=device)
    return pos.reshape(-1).to(torch.int64).expand(b)


def _masked_softmax(scores, mask):
    """Softmax with HARD exclusion of masked positions: -inf before the
    max/exp, and fully-masked rows renormalise to exactly 0. The guard
    keys on denom == 0, NOT > 0: a NaN denominator from a genuine
    attended fault must divide through and propagate."""
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m)))
    denom = e.sum(dim=-1, keepdim=True)
    return torch.where(denom == 0, torch.zeros_like(e), e / denom)


def _sanitize_unattended(cv, attended):
    """Zero the V rows NO query attends (attended: [B, L] broadcastable
    against cv [B, Hkv, L, D] after the caller's any-reduction). A
    0-probability key with non-finite garbage would still give
    0 * nan == nan in the probs @ V contraction."""
    b = attended.shape[0]
    keep = attended.reshape((b, 1) + tuple(attended.shape[1:]))
    return torch.where(keep, cv, torch.zeros((), dtype=cv.dtype,
                                             device=cv.device))


def cached_decode_attention(q, ck, cv, pos, scale, window=None,
                            sanitize=False):
    """Single-token attention over a dense per-lane view. q: [B, H, 1, D];
    ck/cv: [B, Hkv, L, D], grouped (GQA) when H > Hkv without repeating
    the cache. `pos` is a scalar or a [B] vector: keys at ks <= pos are
    attended (banded to the last `window`). Returns [B, H, 1, D] in
    cv.dtype."""
    b, h, _, d = q.shape
    hkv, L = ck.shape[1], ck.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, d)
    scores = torch.einsum("bkrd,bkld->bkrl", qf, ck.float()) * scale
    p = _positions(pos, b, q.device).reshape(b, 1, 1, 1)
    ks = torch.arange(L, device=q.device).reshape(1, 1, 1, L)
    mask = ks <= p
    if window is not None:
        mask = mask & (ks > p - window)
    probs = _masked_softmax(scores, mask).to(cv.dtype)
    if sanitize:
        cv = _sanitize_unattended(cv, mask[:, 0, 0, :, None])
    out = torch.einsum("bkrl,bkld->bkrd", probs, cv)
    return out.reshape(b, h, 1, d)


def chunk_attention(q, ck, cv, start, scale, window=None, sanitize=False):
    """C queries per lane at absolute positions start + i over an
    L-position view (which already holds the chunk's own K/V). q:
    [B, H, C, D]; ck/cv: [B, Hkv, L, D]; `start` a scalar or [B]. Query
    row i masks ks <= start + i (banded to the last `window` keys).
    Returns [B, H, C, D] in cv.dtype."""
    b, h, c, d = q.shape
    hkv, L = ck.shape[1], ck.shape[2]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, c, d)
    scores = torch.einsum("bkrcd,bkld->bkrcl", qf, ck.float()) * scale
    s0 = _positions(start, b, q.device).reshape(b, 1, 1, 1, 1)
    qpos = s0 + torch.arange(c, device=q.device).reshape(1, 1, 1, c, 1)
    ks = torch.arange(L, device=q.device).reshape(1, 1, 1, 1, L)
    mask = ks <= qpos
    if window is not None:
        mask = mask & (ks > qpos - window)
    probs = _masked_softmax(scores, mask).to(cv.dtype)
    if sanitize:
        cv = _sanitize_unattended(cv, mask.any(dim=3)[:, 0, 0, :, None])
    out = torch.einsum("bkrcl,bkld->bkrcd", probs, cv)
    return out.reshape(b, h, c, d)


def scatter_kv_at(cache, kv_t, pos):
    """Write one step's K or V [B, Hkv, 1, D] into the dense cache
    [B, Hkv, L, D] at per-row positions `pos` ([B], or a scalar for the
    lockstep batch), in place, with one scatter whose indices stay on the
    device (so a CUDA graph replays whatever positions its buffers hold).

    A position past the cache is clamped to L - 1, as JAX's
    dynamic_update_slice clamps its start. A live lane always has
    pos < max_len = L; only lanes outside the wave (a retired lane parked
    at pos == L) reach the clamp, and their rows are rewritten by the
    next prefill."""
    b, hkv, L, d = cache.shape
    pos = torch.clamp(_positions(pos, b, cache.device), 0, L - 1)
    cache.scatter_(2, pos.reshape(b, 1, 1, 1).expand(b, hkv, 1, d),
                   kv_t.to(cache.dtype))
    return cache


def gather_block_kv(pool, tables):
    """Materialise per-lane views from the block pool. pool:
    [NB, Hkv, BS, D]; tables: [B, nblk] -> [B, Hkv, nblk*BS, D], position
    p of lane b at pool[tables[b, p // BS], :, p % BS]. Table entries
    are pool block ids handed out by the BlockPool, in range by
    construction."""
    g = pool[tables.long()]                    # [B, nblk, Hkv, BS, D]
    b, nblk, hkv, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, nblk * bs, d)


def scatter_block_kv_at(pool, kv_t, tables, pos):
    """Write one step's K or V [B, Hkv, 1, D] through block tables
    [B, nblk] at per-lane positions pos [B], in place: lane b lands in
    pool[tables[b, pos[b] // BS], :, pos[b] % BS].

    The table column is clamped to [0, nblk - 1]. A live lane always has
    pos < max_len = nblk * BS, so the clamp never moves its write; only
    lanes outside the wave (a retired lane parked at pos == max_len) can
    reach past the table, and the engine uploads all-scratch rows for
    exactly those lanes, so their write lands in block 0 either way."""
    bs, nblk = pool.shape[2], tables.shape[1]
    pos = _positions(pos, kv_t.shape[0], pool.device)
    col = torch.clamp(pos // bs, 0, nblk - 1)
    blk = torch.gather(tables.long(), 1, col[:, None])[:, 0]
    pool[blk, :, pos % bs, :] = kv_t[:, :, 0, :].to(pool.dtype)
    return pool


def scatter_block_kv_chunk_batched(pool, kv_c, tables, start, valid_len):
    """Write a C-token chunk's K or V [S, Hkv, C, D] for EVERY lane
    through its block table [S, nblk] at absolute positions start[s] + i,
    in place, with one `index_put_` whose indices stay on the device (a
    CUDA graph replays whatever starts and lengths its buffers hold).
    Position i of lane s at or past valid_len[s] goes to the scratch
    block: the speculative verify clamps each lane's k + 1 span this way
    (horizon, per-lane spec_len), and a prefill chunk (S = 1) its padded
    tail. `start` and `valid_len` are [S], or scalars (Python ints or
    0-d tensors) for every lane.

    The table column is clamped to nblk - 1 BEFORE the lookup (a clamped
    span can index past the table); those positions go to scratch
    regardless, and valid positions lie inside the table, so the clamp
    moves no live write. Distinct lanes write distinct blocks (frontier
    blocks are private by the copy-on-write guard), so the only
    colliding writes are the scratch redirects, garbage by design."""
    nblk, bs = tables.shape[1], pool.shape[2]
    s, c = kv_c.shape[0], kv_c.shape[2]
    arange = torch.arange(c, device=pool.device)
    positions = _positions(start, s, pool.device)[:, None] + arange
    col = torch.clamp(positions // bs, 0, nblk - 1)
    blk = torch.gather(tables.long(), 1, col)                   # [S, C]
    valid = arange < _positions(valid_len, s, pool.device)[:, None]
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    kv = kv_c.permute(0, 2, 1, 3)                       # [S, C, Hkv, D]
    pool[blk, :, positions % bs, :] = kv.to(pool.dtype)
    return pool


def infer_cache_dtype(model):
    """Majority floating dtype of the parameters: a bf16 model gets bf16
    KV caches (halving the bytes that bound decode), an f32 model f32."""
    counts = {}
    for p in model.parameters():
        p = unwrap(p)
        if p.dtype in (torch.bfloat16, torch.float16, torch.float32):
            counts[p.dtype] = counts.get(p.dtype, 0) + p.numel()
    low = {d: c for d, c in counts.items() if d != torch.float32}
    if low and sum(low.values()) > counts.get(torch.float32, 0):
        return max(low, key=low.get)
    return torch.float32


# ---------------------------------------------------------------------------
# the Transformer layers
# ---------------------------------------------------------------------------

def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 training=True, causal=False, scale=None):
    """q, k, v: [B, H, S, D] Tensors, through the registered
    flash_attention op (the kernels when the shapes allow, else the
    dense route)."""
    from ..ops.flash_attention import flash_attention
    return flash_attention(q, k, v, attn_mask=attn_mask, causal=causal,
                           dropout_p=dropout_p if training else 0.0,
                           scale=scale)


def _attention_weights(q, k, scale):
    """softmax(q k^T * scale) in f32, [B, H, Sq, Sk]."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(logits, dim=-1)


class MultiHeadAttention(Layer):
    """ref transformer.py:115: q/k/v/out projections over embed_dim
    ([in, out] Linear weights, the JAX package's layout)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, attn_layout=None):
        super().__init__()
        self.attn_layout = attn_layout or "bshd"
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _reshape_heads(self, x):
        # [B, S, E] -> [B, H, S, D]
        b, s = x.shape[0], x.shape[1]
        return x.reshape([b, s, self.num_heads, self.head_dim]) \
                .transpose([0, 2, 1, 3])

    def gen_cache(self, key, value=None, type=Cache):
        """A StaticCache of the projected key and value (cross
        attention), an empty incremental Cache ([B, H, 0, D], in key's
        dtype and on its device) when `value` is None, else
        Cache(key, value)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(value if value is not None
                                                else key))
            return self.StaticCache(k, v)
        if value is None:
            d = key._data
            empty = torch.zeros((key.shape[0], self.num_heads, 0,
                                 self.head_dim), dtype=d.dtype,
                                device=d.device)
            return self.Cache(Tensor._wrap(empty), Tensor._wrap(empty))
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if (self.attn_layout == "bshd" and cache is None
                and not self.need_weights and attn_mask is None):
            # [B, S, E] -> [B, S, H, D] views straight into the op
            from ..ops.flash_attention import flash_attention
            b, s = query.shape[0], query.shape[1]
            hd = (self.num_heads, self.head_dim)
            q = self.q_proj(query).reshape([b, s, *hd])
            k = self.k_proj(key).reshape([b, key.shape[1], *hd])
            v = self.v_proj(value).reshape([b, value.shape[1], *hd])
            out = flash_attention(
                q, k, v, causal=False,
                dropout_p=self.dropout if self.training else 0.0,
                layout="bshd")
            return self.out_proj(out.reshape([b, s, self.embed_dim]))
        q = self._reshape_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._reshape_heads(self.k_proj(key))
            v = self._reshape_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                from ..ops.manipulation import concat
                k = concat([cache.k, k], axis=2)
                v = concat([cache.v, v], axis=2)
                cache = self.Cache(k, v)
        weights = None
        if self.need_weights:
            weights = apply(_attention_weights, (q, k),
                            {"scale": 1.0 / math.sqrt(q.shape[-1])},
                            name="attn_weights")
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        # [B, H, S, D] -> [B, S, E]
        b, s = out.shape[0], out.shape[2]
        out = out.transpose([0, 2, 1, 3]).reshape([b, s, self.embed_dim])
        out = self.out_proj(out)
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if isinstance(cache, MultiHeadAttention.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _config(d_model, nhead, dim_feedforward, dropout, activation,
            attn_dropout, act_dropout, normalize_before, weight_attr,
            bias_attr):
    return dict(d_model=d_model, nhead=nhead,
                dim_feedforward=dim_feedforward, dropout=dropout,
                activation=activation, attn_dropout=attn_dropout,
                act_dropout=act_dropout, normalize_before=normalize_before,
                weight_attr=weight_attr, bias_attr=bias_attr)


class TransformerEncoderLayer(Layer):
    """ref transformer.py TransformerEncoderLayer: self-attention and the
    feed-forward block, post-norm or (`normalize_before`) pre-norm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self._config = _config(d_model, nhead, dim_feedforward, dropout,
                               activation, attn_dropout, act_dropout,
                               normalize_before, weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """`num_layers` encoder layers: the given one and fresh clones of it
    (`_clone_layer`), then `norm` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """ref transformer.py TransformerDecoderLayer: self-attention,
    cross-attention over `memory` and the feed-forward block."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self._config = _config(d_model, nhead, dim_feedforward, dropout,
                               activation, attn_dropout, act_dropout,
                               normalize_before, weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """`num_layers` decoder layers: the given one and fresh clones of it
    (`_clone_layer`), then `norm` when given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask=tgt_mask,
                                        memory_mask=memory_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """ref transformer.py:886: the encoder-decoder Transformer (a final
    LayerNorm on each stack when `normalize_before`)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] additive mask: -inf above the diagonal, 0 on
        and below it (on the current place)."""
        from ..ops.creation import full, triu
        return triu(full([length, length], float("-inf")), diagonal=1)


def _clone_layer(layer):
    """A fresh layer with the same config and its own initialisation
    (the reference rebuilds each layer from its config)."""
    return type(layer)(**layer._config)
