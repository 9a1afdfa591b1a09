"""KV-cache primitives and the dense attention cores they feed — the
serving subset of `paddle_tpu/nn/transformer.py`: the dense cache's
per-row scatter (`scatter_kv_at`) and the paged cache's (one token per
lane; a chunk of tokens per lane, for the prefill and the speculative
verify).

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
import torch


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
        if p.dtype in (torch.bfloat16, torch.float16, torch.float32):
            counts[p.dtype] = counts.get(p.dtype, 0) + p.numel()
    low = {d: c for d, c in counts.items() if d != torch.float32}
    if low and sum(low.values()) > counts.get(torch.float32, 0):
        return max(low, key=low.get)
    return torch.float32
