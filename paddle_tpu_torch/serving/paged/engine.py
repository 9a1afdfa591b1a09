"""PagedServingEngine: block-table KV cache over the ServingEngine wave
machinery (the port of `paddle_tpu/serving/paged/engine.py`), and its
speculative sibling `SpeculativePagedEngine`.

The cache is a fixed POOL of `[num_blocks, kv_heads, block_size,
head_dim]` KV blocks per layer; slots reference block TABLES
(host-managed int32 rows, `BlockPool`). Device memory scales with the
blocks configured, utilisation with the tokens actually held, and
identical prompt prefixes dedupe onto shared blocks.

Two programs (`graphs.Program`: CUDA-graph replays on the card,
eager on the CPU or with cuda_graph=False), both through the
paged-attention dispatch pinned to this engine's kernel and both reading
only their static input buffers:

  * decode wave — one token for every slot, each lane's K/V scattered
    through its table row and attention read straight out of the pools;
  * prefill chunk — one fixed-size chunk of one slot's prompt at an
    absolute offset (chunk start, valid length and frontier as 0-d
    device tensors), with the first-token selection. Long prompts run
    chunk by chunk BETWEEN decode waves (the scheduler advances one
    chunk per round); chunks fully covered by prefix-cache hits are
    skipped. Only the final chunk's token is read back, and only that
    chunk of a sampling request draws noise.

Allocation happens between waves, and so does the copy-on-write copy of
a shared block, eagerly; a lane that cannot get a block (pool exhausted)
is excluded from the wave and reported in `last_starved_slots` for the
scheduler to preempt by recompute.

A prefilled slot's blocks can move to another engine (`export_slot_kv`,
`import_handoff`): the block manifest and every pool's content at the
slot's blocks, copied to the host and sealed by a sha256 digest that
hashes what the JAX package's digest hashes, so a payload of either
package imports into the other's engine of the same geometry.
"""
import hashlib

import numpy as np
import torch

from ...graphs import Program
from ...nn import paged_attention
from ...nn.decode import gumbel_
from ..engine import ServingEngine, _filter_top_k_top_p, _select_first_token
from .block_pool import BlockPool, BlockPoolExhausted

#: block-level KV handoff payload version: a payload of another version
#: is refused rather than scattered into the wrong layout
HANDOFF_VERSION = 1


class HandoffRefused(RuntimeError):
    """A handoff payload failed verification (digest mismatch, another
    pool geometry or cache layout, a version skew). A request fault,
    never capacity: decoding over corrupt K/V would emit wrong tokens."""


def _dtype_name(a):
    """numpy's name of an array's or a tensor's dtype ("float32",
    "bfloat16")."""
    return str(a.dtype).removeprefix("torch.")


def _handoff_digest(layers, n_tokens, block_size):
    """sha256 over the geometry and every layer's dtype name, shape and
    raw bytes: the same bytes the JAX package hashes (a contiguous
    tensor read through a uint8 view stands for numpy's tobytes)."""
    h = hashlib.sha256()
    h.update(f"v{HANDOFF_VERSION}:{n_tokens}:{block_size}".encode())
    for a in layers:
        h.update(_dtype_name(a).encode())
        h.update(str(tuple(a.shape)).encode())
        if isinstance(a, torch.Tensor):
            raw = a.contiguous().view(torch.uint8).numpy()
        else:
            raw = np.ascontiguousarray(a).view(np.uint8)
        h.update(raw.reshape(-1))
    return h.hexdigest()


def _to_tensor(a):
    """A payload layer as a CPU tensor: numpy arrays (the JAX package's
    payloads; a bfloat16 one through its uint16 bits) or tensors."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class PagedServingEngine(ServingEngine):
    """Block-table batched decode executor.

    model: a causal LM exposing init_paged_cache / decode_step(...,
        block_tables=) / prefill_chunk (nlp.GPTForPretraining,
        nlp.LlamaForCausalLM).
    max_len: per-request horizon; a multiple of block_size.
    num_blocks: pool size INCLUDING the scratch block (block 0); default
        num_slots * max_len // block_size + 1 (dense-equivalent).
    prefill_chunk_len: prompt chunk size (default min(64, max_len)).
    prefix_sharing: dedupe identical full prompt blocks (copy-on-write
        guarded; see BlockPool).
    paged_kernel: "reference" | "plain" | "cuda" | "auto" (None defers
        to PT_PAGED_KERNEL, then "auto": "cuda" on the card, "plain" on
        the CPU). Resolved at construction and pinned for every wave.
    device: None = the CUDA card; pass device="cpu" for the host.
    cuda_graph: see ServingEngine.
    """

    def __init__(self, model, num_slots=4, max_len=256, block_size=16,
                 num_blocks=None, prefill_chunk_len=None, cache_dtype=None,
                 seed=0, prefix_sharing=True, paged_kernel=None,
                 device=None, cuda_graph=True):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"block_size {block_size}")
        self.block_size = int(block_size)
        self.blocks_per_slot = int(max_len) // self.block_size
        if num_blocks is None:
            num_blocks = int(num_slots) * self.blocks_per_slot + 1
        self.prefill_chunk_len = int(prefill_chunk_len
                                     or min(64, int(max_len)))
        if self.prefill_chunk_len > max_len:
            raise ValueError(f"prefill_chunk_len {self.prefill_chunk_len} "
                             f"> max_len {max_len}")
        self.prefix_sharing = bool(prefix_sharing)
        self.block_pool = BlockPool(num_blocks, self.block_size)
        super().__init__(model, num_slots=num_slots, max_len=max_len,
                         prefill_len=self.prefill_chunk_len,
                         cache_dtype=cache_dtype, seed=seed, device=device,
                         cuda_graph=cuda_graph)
        self.paged_kernel = paged_attention.resolve_kernel(paged_kernel,
                                                           self.device)
        self._slot_blocks = [[] for _ in range(self.num_slots)]
        self._tables = np.zeros((self.num_slots, self.blocks_per_slot),
                                np.int32)

    _PREFILL_NAME = "serving.prefill_chunk"

    def describe(self):
        """The engine's construction config: the paged extras on top of
        the dense fields."""
        d = super().describe()
        d.update({"engine": "paged", "block_size": self.block_size,
                  "num_blocks": self.block_pool.num_blocks,
                  "prefill_chunk_len": self.prefill_chunk_len,
                  "prefix_sharing": self.prefix_sharing,
                  "paged_kernel": self.paged_kernel})
        return d

    def _prefill_fields(self):
        return [("chunk", torch.int64, (1, self.prefill_chunk_len)),
                ("table", torch.int32, (1, self.blocks_per_slot)),
                ("chunk_start", torch.int64, ()),
                ("valid_len", torch.int64, ()),
                ("frontier", torch.int64, ()), ("sample", torch.bool, ()),
                ("temp", torch.float32, ()), ("top_k", torch.int64, ()),
                ("top_p", torch.float32, ())]

    def _wave_fields(self):
        return super()._wave_fields() + [
            ("tables", torch.int32, (self.num_slots, self.blocks_per_slot))]

    def _make_caches(self):
        return self.model.init_paged_cache(self.block_pool.num_blocks,
                                           self.block_size, self.max_len,
                                           dtype=self.cache_dtype)

    # --------------------------------------------------------- admission
    def validate_prompt(self, prompt):
        """Any prompt that fits the horizon (with one position to decode
        into) and the pool's capacity is admissible."""
        n = len(prompt)
        if n + 1 > self.max_len:
            return (f"prompt length {n} leaves no room to decode under "
                    f"max_len {self.max_len}")
        need = (n + 1 + self.block_size - 1) // self.block_size
        if need > self.block_pool.usable:
            return (f"prompt needs {need} KV blocks, pool has only "
                    f"{self.block_pool.usable} usable")
        return None

    def begin_prefill(self, slot, prompt, do_sample=False, temperature=1.0,
                      top_k=0, top_p=1.0, logit_bias=None,
                      dynamic_mask=False):
        """Admit a prompt: match shared prefix blocks, allocate the rest
        (BlockPoolExhausted = capacity, handled by the scheduler), and
        stage the chunk schedule. Chunks fully covered by prefix hits are
        skipped; a fully cached prompt still runs its LAST chunk, which
        produces the first token."""
        why = self.validate_prompt(prompt)
        if why:
            raise ValueError(why)
        if self.slot_active[slot] or slot in self._pending_prefill:
            raise RuntimeError(f"slot {slot} is busy")
        prompt = [int(t) for t in prompt]
        n, bs = len(prompt), self.block_size
        need = (n + 1 + bs - 1) // bs
        shared, hashes = [], []
        if self.prefix_sharing:
            shared, hashes = self.block_pool.match_prefix(prompt)
        try:
            fresh = self.block_pool.alloc(need - len(shared))
        except BlockPoolExhausted:
            # the matched prefix references go back, or a failed
            # admission would shrink the pool for good
            self.block_pool.release(shared)
            raise
        if self.prefix_sharing:
            self.block_pool.count_prefix(len(shared), n // bs - len(shared))
        blocks = shared + fresh
        self._slot_blocks[slot] = blocks
        self._tables[slot, :] = 0
        self._tables[slot, :len(blocks)] = blocks
        chunk = self.prefill_chunk_len
        start = (len(shared) * bs // chunk) * chunk
        start = min(start, ((n - 1) // chunk) * chunk)
        self._pending_prefill[slot] = {
            "prompt": prompt, "n": n, "next": start,
            "sampling": self._sampling_state(do_sample, temperature, top_k,
                                             top_p, logit_bias,
                                             dynamic_mask),
            "hashes": (self.block_pool.prompt_hashes(prompt)
                       if self.prefix_sharing else []),
            "next_hash": len(shared),
        }

    def prefill_step(self, slot):
        """Run ONE chunk of the slot's staged prompt. Returns the first
        generated token when the final chunk ran, None while chunks
        remain."""
        st = self._pending_prefill[slot]
        c0, C, n, bs = (st["next"], self.prefill_chunk_len, st["n"],
                        self.block_size)
        valid = min(C, n - c0)
        last = c0 + C >= n
        sampling = st["sampling"]
        sampled = last and sampling["sample"]
        host = self.prefill_inputs.stage()
        host["chunk"][...] = 0
        host["chunk"][0, :valid] = st["prompt"][c0:c0 + valid]
        host["table"][...] = self._tables[slot:slot + 1]
        host["chunk_start"][...] = c0
        host["valid_len"][...] = valid
        host["frontier"][...] = (n - 1) - c0 if last else 0
        # only the final chunk's selection is read: the bias row moves
        # then
        self._stage_sampling(host, sampling, sampled, move_bias=last)
        first, self.last_prefill_logits = self.prefill_program(sampled)
        self.prefill_chunks_run += 1
        # full prompt blocks written by this chunk enter the prefix cache
        # only now, once their content is on the device
        if self.prefix_sharing:
            end = c0 + valid
            while (st["next_hash"] < len(st["hashes"])
                   and (st["next_hash"] + 1) * bs <= end):
                i = st["next_hash"]
                self.block_pool.register_hash(self._slot_blocks[slot][i],
                                              st["hashes"][i])
                st["next_hash"] += 1
        st["next"] = c0 + C
        if not last:
            return None
        del self._pending_prefill[slot]
        first = int(first.item())
        self._arm_slot(slot, first, n, sampling)
        return first

    def _prefill_program(self, sampled):
        """One prompt chunk over the static buffers, and the first-token
        selection from its frontier logits (Gumbel noise drawn in place
        when `sampled`). Returns the token (0-d) and the f32 frontier
        logits [V]."""
        p = self.prefill_inputs.tensors
        gumbel = gumbel_(p["gumbel"], self._gen) if sampled else None
        with paged_attention.kernel_scope(self.paged_kernel):
            logits, _ = self.model.prefill_chunk(
                p["chunk"], self._caches, p["table"], p["chunk_start"],
                p["valid_len"], frontier=p["frontier"])
        lo = logits[0, 0].float()
        return _select_first_token(lo, p["sample"], p["temp"], p["top_k"],
                                   p["top_p"], p["bias"], gumbel), lo

    # -------------------------------------------------- block-level handoff
    def _pool_leaves(self):
        """Every pool tensor in the JAX package's leaf order: layer 0 K,
        layer 0 V, layer 1 K, ...; the target's pools before the
        draft's on the speculative engine."""
        return [t for pair in self._pools() for t in pair]

    def export_slot_kv(self, slot):
        """Package a prefilled slot's blocks for a handoff to another
        engine: the pool's manifest (`BlockPool.export_blocks`) and every
        pool's content at the slot's blocks, gathered after the programs
        queued on the current stream and copied to the host (numpy for
        float32, CPU tensors otherwise), digest-sealed. The slot is left
        as it is: the caller retires it once the payload is in hand."""
        if not self.slot_active[slot]:
            raise RuntimeError(f"slot {slot} is not active (handoff export "
                               "needs a completed prefill)")
        if slot in self._pending_prefill:
            raise RuntimeError(f"slot {slot} is mid-prefill")
        blocks = list(self._slot_blocks[slot])
        manifest = self.block_pool.export_blocks(blocks)
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        host = torch.stack([pool.index_select(0, idx)
                            for pool in self._pool_leaves()]).cpu()
        if host.dtype == torch.float32:
            host = host.numpy()
        layers = list(host)
        n = int(self.slot_pos[slot])
        return {
            "version": HANDOFF_VERSION,
            "n_tokens": n,
            "next_token": int(self.slot_tok[slot]),
            "block_size": self.block_size,
            "blocks": len(blocks),
            "manifest": manifest,
            "layers": layers,
            "nbytes": sum(int(a.nbytes) for a in layers),
            "digest": _handoff_digest(layers, n, self.block_size),
        }

    def import_handoff(self, slot, prompt, payload, do_sample=False,
                       temperature=1.0, top_k=0, top_p=1.0, logit_bias=None,
                       dynamic_mask=False):
        """Admit a request from an exported payload: verify version,
        geometry, layout and digest (HandoffRefused), take local blocks
        (BlockPoolExhausted is capacity), write the content into every
        pool IN PLACE (the programs' graphs hold the pools' addresses),
        and arm the slot as if its final prefill chunk had run here.
        `prompt` is the continuation, the original prompt + the first
        token the exporter produced: the slot arms at len(prompt) - 1
        holding prompt[-1]. No prefill chunk runs. Returns prompt[-1]."""
        why = self.validate_prompt(prompt)
        if why:
            raise ValueError(why)
        if self.slot_active[slot] or slot in self._pending_prefill:
            raise RuntimeError(f"slot {slot} is busy")
        prompt = [int(t) for t in prompt]
        layers = list(payload.get("layers", ()))
        if payload.get("version") != HANDOFF_VERSION:
            raise HandoffRefused(
                f"handoff version {payload.get('version')!r} != "
                f"{HANDOFF_VERSION}")
        if int(payload["block_size"]) != self.block_size:
            raise HandoffRefused(
                f"payload block_size {payload['block_size']} != pool "
                f"block_size {self.block_size}")
        n = int(payload["n_tokens"])
        if n != len(prompt) - 1 or int(payload["next_token"]) != prompt[-1]:
            raise HandoffRefused(
                "payload token state does not match the continuation "
                f"(payload n={n}, next={payload['next_token']}; "
                f"continuation len={len(prompt)})")
        nblk = len(payload["manifest"])
        if nblk * self.block_size < n + 1 or nblk != payload.get("blocks"):
            raise HandoffRefused(f"{nblk} exported block(s) cannot back {n}"
                                 " tokens plus the decode frontier")
        leaves = self._pool_leaves()
        if len(layers) != len(leaves) or any(
                tuple(a.shape) != (nblk,) + tuple(p.shape[1:])
                or _dtype_name(a) != _dtype_name(p)
                for a, p in zip(layers, leaves)):
            raise HandoffRefused(
                "payload layer layout does not match this engine's pools "
                "(engine flavour or geometry mismatch)")
        if _handoff_digest(layers, n, self.block_size) != payload["digest"]:
            raise HandoffRefused(
                "handoff digest mismatch: payload content is corrupt")
        fresh = self.block_pool.import_blocks(payload["manifest"])
        try:
            idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
            for pool, a in zip(leaves, layers):
                pool.index_copy_(0, idx, _to_tensor(a).to(self.device))
            self._slot_blocks[slot] = fresh
            self._tables[slot, :] = 0
            self._tables[slot, :len(fresh)] = fresh
            if self.prefix_sharing:
                # the content is on the device now: full prompt blocks
                # enter the prefix cache (first writer wins)
                for blk, h in zip(fresh,
                                  self.block_pool.prompt_hashes(prompt[:n])):
                    self.block_pool.register_hash(blk, h)
        except BaseException:
            self.block_pool.release(fresh)
            self._slot_blocks[slot] = []
            self._tables[slot, :] = 0
            raise
        self._arm_slot(slot, prompt[-1], n,
                       self._sampling_state(do_sample, temperature, top_k,
                                            top_p, logit_bias, dynamic_mask))
        return prompt[-1]

    # ------------------------------------------------------------- waves
    def _prepare_wave(self, active_now):
        """Back each active lane's next write position with a block; a
        lane that cannot get one is dropped from the wave and reported
        for preemption. A shared write target is copied first (COW)."""
        starved = []
        for s, live in enumerate(active_now):
            if not live:
                continue
            bi = self.slot_pos[s] // self.block_size
            blocks = self._slot_blocks[s]
            try:
                if bi >= len(blocks):
                    blk, = self.block_pool.alloc(1)
                    blocks.append(blk)
                    self._tables[s, bi] = blk
                elif self.block_pool.refcount(blocks[bi]) > 1:
                    self._ensure_private(s, bi)
            except BlockPoolExhausted:
                starved.append(s)
                active_now[s] = False
        self.last_starved_slots = starved
        return active_now

    def _stage_wave(self, host, active_now):
        # every lane's K/V is scattered (fixed shapes); a lane not in THIS
        # wave (free, mid-prefill, starved) would write its stale token
        # through its table into a live — possibly shared — block, so its
        # table row is staged as all-scratch and the write lands in block
        # 0 by design
        host["tables"][...] = np.where(
            np.asarray(active_now, bool)[:, None], self._tables,
            np.int32(BlockPool.SCRATCH))

    def _wave_logits(self, w):
        with paged_attention.kernel_scope(self.paged_kernel):
            logits, _ = self.model.decode_step(
                w["tok"][:, None], self._caches, w["pos"],
                block_tables=w["tables"])
        return logits[:, 0, :].float()

    # ----------------------------------------------------- copy-on-write
    def _pools(self):
        """Every (K, V) pool pair that a block id names."""
        return self._caches

    def _ensure_private(self, slot, bi):
        """Give the slot a private copy of table entry `bi`: the pool
        moves the reference, the device content is copied in place."""
        blocks = self._slot_blocks[slot]
        blk = blocks[bi]
        new = self.block_pool.cow(blk)
        if new == blk:
            return
        for ck, cv in self._pools():
            ck[new].copy_(ck[blk])
            cv[new].copy_(cv[blk])
        blocks[bi] = new
        self._tables[slot, bi] = new

    # ------------------------------------------------------------- slots
    def retire_slot(self, slot):
        """Free the slot AND its blocks (freed blocks keep their prefix
        hashes, so a re-admission re-hits the cache)."""
        super().retire_slot(slot)
        blocks = self._slot_blocks[slot]
        if blocks:
            self.block_pool.release(blocks)
        self._slot_blocks[slot] = []
        self._tables[slot, :] = 0

    def _health(self):
        h = super()._health()
        h.update(block_size=self.block_size, paged_kernel=self.paged_kernel,
                 cache_blocks_used=self.block_pool.used,
                 cache_blocks_total=self.block_pool.usable,
                 prefix_cache_hits=self.block_pool.prefix_hits,
                 prefix_cache_misses=self.block_pool.prefix_misses)
        return h


def _spec_verify_tail(lo, tok, pos, active, sample, temps, top_k, top_p,
                      bias, spec_len, draft_toks, draft_probs, noise=None):
    """The speculative wave's acceptance–rejection tail over the verify
    chunk's f32 target logits [S, C, V] (C = k + 1): the wave's token
    selection applied position by position, with EXACT acceptance-
    rejection, so the output follows the target model's distribution —
    and the greedy path is the target's own trajectory, token for token.

    Greedy lanes accept the longest draft prefix that agrees with the
    target argmax (over the biased logits) and emit the target's argmax
    at the first mismatch. Sampling lanes accept draft token d_i with
    probability min(1, p_t(d_i) / p_d(d_i)) and draw the first rejection
    from the normalised residual max(p_t - p_d, 0); with all k accepted,
    the bonus token is the a == k case of the same formula, because p_d
    is zero-extended at position k. Both are the PROCESSED distributions
    (temperature, top-k/top-p and the bias applied).

    `noise` is None when no lane samples, else the explicit draws
    (u [S, k] uniform in [0, 1), g_res [S, V] and g_fb [S, V] Gumbel
    noise of the residual's and the fallback's categorical draws), which
    the engine fills from its generator. Per-lane `spec_len` [S] clamps
    the acceptance (the horizon); a lane at spec_len 0 is the plain
    decode. Lanes that are inactive or non-finite emit nothing and keep
    their token and position. Returns out [S, C] (the first n_emit of a
    lane are its tokens), n_emit [S], nxt [S], new_pos [S], finite [S]."""
    s, c, v = lo.shape
    k = c - 1
    dev = lo.device
    lo = lo + bias[:, None, :]
    finite = torch.isfinite(lo).flatten(1).all(dim=1)
    greedy = torch.argmax(lo, dim=-1)                          # [S, C]
    arange_c = torch.arange(c, device=dev)
    valid = arange_c[None, :k] < spec_len[:, None]             # [S, k]
    ok = draft_toks == greedy[:, :k]
    if noise is not None:
        u, g_res, g_fb = noise
        scaled = lo / torch.clamp(temps, min=1e-6)[:, None, None]
        filt = _filter_top_k_top_p(
            scaled.reshape(s * c, v), top_k.repeat_interleave(c),
            top_p.repeat_interleave(c)).reshape(s, c, v)
        p_t = torch.softmax(filt, dim=-1)                      # [S, C, V]
        pt_d = torch.gather(p_t[:, :k], -1, draft_toks[..., None])[..., 0]
        pd_d = torch.gather(draft_probs, -1, draft_toks[..., None])[..., 0]
        ok = torch.where(sample[:, None], u * pd_d < pt_d, ok)
    ok = ok & valid
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)             # [S] in 0..k
    extra = torch.gather(greedy, 1, a[:, None])[:, 0]
    if noise is not None:
        # p_d is zeroed at every position the lane did NOT draft (i >=
        # its spec_len, position k included): there the formula must
        # come down to sampling p_t itself — a horizon-clamped lane
        # offered nothing at its frontier, and subtracting a draft
        # distribution it never proposed would skew the output away
        # from the target's
        p_d_ext = torch.cat(
            [draft_probs, torch.zeros_like(draft_probs[:, :1])], dim=1)
        drafted = arange_c[None, :] < spec_len[:, None]         # [S, C]
        p_d_ext = torch.where(drafted[:, :, None], p_d_ext,
                              torch.zeros((), device=dev))
        idx = a[:, None, None].expand(s, 1, v)
        p_t_a = torch.gather(p_t, 1, idx)[:, 0]
        p_d_a = torch.gather(p_d_ext, 1, idx)[:, 0]
        residual = torch.clamp(p_t_a - p_d_a, min=0.0)
        res_tok = torch.argmax(torch.log(torch.clamp(residual, min=1e-30))
                               + g_res, dim=-1)
        # float round-off can zero a residual row that is positive in
        # exact arithmetic: then draw from the target distribution
        # itself (a measure-zero correction)
        fallback = torch.argmax(torch.log(torch.clamp(p_t_a, min=1e-30))
                                + g_fb, dim=-1)
        res_tok = torch.where(residual.sum(dim=-1) > 0, res_tok, fallback)
        extra = torch.where(sample, res_tok, extra)
    draft_pad = torch.cat([draft_toks, torch.zeros_like(draft_toks[:, :1])],
                          dim=1)
    out = torch.where(arange_c[None, :] < a[:, None], draft_pad,
                      extra[:, None])
    ok_lane = active & finite
    n_emit = torch.where(ok_lane, a + 1, torch.zeros_like(a))
    nxt = torch.where(ok_lane, extra, tok.long())
    return out, n_emit, nxt, pos + n_emit, finite


class SpeculativePagedEngine(PagedServingEngine):
    """Draft-k / verify-once speculative decoding over the paged engine
    (the port of the JAX package's `SpeculativePagedEngine`).

    A small DRAFT model proposes up to k tokens per slot per wave; the
    target scores all k + 1 positions in ONE batched forward
    (`decode_chunk`: K4's chunk form with the lanes' [S] start, over the
    same block tables). Exact acceptance-rejection (`_spec_verify_tail`)
    keeps the output distribution the target's — token for token under
    greedy — while a wave advances each lane by 1 .. k + 1 tokens.

    Memory: the target pools and the draft pools are one bundle
    (`_caches`, `_draft_caches`) that shares the block TABLES, so the
    allocator, refcounts, prefix sharing and copy-on-write serve both:
    one block id names the same token span in both, the copy-on-write
    copies both, and `retire_slot` frees both. The prefill chunk writes
    both models' pools, so a prefix-cache hit serves the draft too.
    Blocks allocated ahead for draft tokens that the acceptance did not
    commit go back to the pool after every wave
    (`_rollback_spec_blocks`).

    Three programs (`graphs.Program`: one CUDA graph each on the card per
    sampling key; eager on the CPU or with cuda_graph=False), all over
    static buffers:
      * `draft_program` — k + 1 draft `decode_step`s (K4's decode form):
        step j writes the fed token's K/V at pos + j and proposes the
        next; the last step only writes (d_k's K/V, so a fully accepted
        span leaves the draft cache in step). A lane's steps past its
        spec_len write through the scratch table row, chosen on the
        device from the staged spec_len. The proposals and draft
        probabilities land in static buffers the verify reads;
      * `wave_program` — the verify: the target's decode_chunk at
        C = k + 1 and the acceptance tail, read back once;
      * `prefill_program` — the prompt chunk through both models.
    Per-lane spec_len (the horizon clamp) is a staged VALUE, not a
    shape. Random draws (the draft's Gumbel noise, the tail's uniforms
    and its two Gumbel rows) are drawn in place from the engine's
    generator, registered with every graph.
    """

    _WAVE_NAME = "serving.spec_verify"
    _PREFILL_NAME = "serving.spec_prefill_chunk"
    _DRAFT_NAME = "serving.spec_draft_wave"

    def __init__(self, model, draft_model, spec_k=4, **kw):
        if draft_model is None:
            raise ValueError("SpeculativePagedEngine needs a draft_model")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if int(draft_model.cfg.vocab_size) != int(model.cfg.vocab_size):
            raise ValueError(
                f"draft vocab {draft_model.cfg.vocab_size} != target "
                f"vocab {model.cfg.vocab_size}: acceptance-rejection "
                "compares distributions over ONE vocabulary")
        if draft_model.device != model.device:
            raise ValueError(f"draft model is on {draft_model.device}, "
                             f"target on {model.device}")
        self.spec_k = int(spec_k)
        self.draft_model = draft_model.eval()
        self._wave_spec_len = None
        super().__init__(model, **kw)
        self.last_spec_proposed = 0
        self.last_spec_accepted = 0
        S, k, V = self.num_slots, self.spec_k, self.vocab_size
        add = self.wave_inputs.add
        add("draft_toks", torch.zeros((S, k), dtype=torch.int64,
                                      device=self.device))
        for name, shape in (("draft_probs", (S, k, V)),
                            ("draft_gumbel", (k, S, V)), ("u", (S, k)),
                            ("g_res", (S, V)), ("g_fb", (S, V))):
            add(name, torch.zeros(shape, device=self.device))
        self.draft_program = Program(self._DRAFT_NAME, self._draft_program,
                                     self.device, self.cuda_graph,
                                     [self._gen])

    @property
    def draft_compiles(self):
        """CUDA graphs captured for the draft wave: 1 over a greedy
        stream; 0 on the eager path."""
        return self.draft_program.compiles

    def describe(self):
        d = super().describe()
        d.update({"engine": "spec_paged", "spec_k": self.spec_k,
                  "draft_layers": int(self.draft_model.cfg.num_layers)})
        return d

    def _wave_fields(self):
        return super()._wave_fields() + [
            ("spec_len", torch.int64, (self.num_slots,))]

    # ------------------------------------------------------------ caches
    def _make_caches(self):
        self._draft_caches = self.draft_model.init_paged_cache(
            self.block_pool.num_blocks, self.block_size, self.max_len,
            dtype=self.cache_dtype)
        return super()._make_caches()

    def _pools(self):
        # a shared block's content is copied in the target AND the draft
        # pools: a half-copied block would leave the draft cache out of
        # step with the tokens it claims to hold
        return list(self._caches) + list(self._draft_caches)

    # ---------------------------------------------------------- programs
    def _prefill_program(self, sampled):
        """The chunk through the target (its frontier logits select the
        first token) and through the draft, whose pools it fills for the
        first wave to draft from."""
        first, lo = super()._prefill_program(sampled)
        p = self.prefill_inputs.tensors
        with paged_attention.kernel_scope(self.paged_kernel):
            self.draft_model.prefill_chunk(
                p["chunk"], self._draft_caches, p["table"], p["chunk_start"],
                p["valid_len"], frontier=p["frontier"])
        return first, lo

    def _draft_program(self, sampled):
        """k + 1 draft decode steps over the wave buffers; writes the
        proposals [S, k] (and, when a lane samples, the draft's processed
        distributions [S, k, V]) into the static buffers the verify
        reads. Returns them."""
        w = self.wave_inputs.tensors
        k = self.spec_k
        noise = gumbel_(w["draft_gumbel"], self._gen) if sampled else None
        scratch = torch.full((), BlockPool.SCRATCH, dtype=torch.int32,
                             device=self.device)
        cur = w["tok"]
        with paged_attention.kernel_scope(self.paged_kernel):
            for j in range(k + 1):
                tab = torch.where((w["spec_len"] >= j)[:, None],
                                  w["tables"], scratch)
                logits, _ = self.draft_model.decode_step(
                    cur[:, None], self._draft_caches, w["pos"] + j,
                    block_tables=tab)
                if j == k:
                    break               # the write-only step: no proposal
                lo = logits[:, 0, :].float() + w["bias"]
                cur = torch.argmax(lo, dim=-1)
                if noise is not None:
                    scaled = lo / torch.clamp(w["temps"], min=1e-6)[:, None]
                    filt = _filter_top_k_top_p(scaled, w["top_k"],
                                               w["top_p"])
                    cur = torch.where(w["sample"],
                                      torch.argmax(filt + noise[j], dim=-1),
                                      cur)
                    w["draft_probs"][:, j].copy_(torch.softmax(filt,
                                                               dim=-1))
                w["draft_toks"][:, j].copy_(cur)
        return w["draft_toks"], w["draft_probs"]

    def _wave_program(self, sampled):
        """The verify over the wave buffers: the target's decode_chunk on
        [tok, d_1 .. d_k] at each lane's position, then the tail (its
        draws filled in place when a lane samples). Returns the packed
        int64 read-back [S * C + 4 S] (out, n_emit, nxt, new_pos, finite)
        and the f32 logits [S, C, V]."""
        w = self.wave_inputs.tensors
        noise = None
        if sampled:
            noise = (w["u"].uniform_(0, 1, generator=self._gen),
                     gumbel_(w["g_res"], self._gen),
                     gumbel_(w["g_fb"], self._gen))
        chunk = torch.cat([w["tok"][:, None], w["draft_toks"]], dim=1)
        with paged_attention.kernel_scope(self.paged_kernel):
            logits, _ = self.model.decode_chunk(
                chunk, self._caches, w["tables"], w["pos"],
                w["spec_len"] + 1)
        lo = logits.float()
        out, n_emit, nxt, new_pos, finite = _spec_verify_tail(
            lo, w["tok"], w["pos"], w["active"], w["sample"], w["temps"],
            w["top_k"], w["top_p"], w["bias"], w["spec_len"],
            w["draft_toks"], w["draft_probs"], noise)
        return torch.cat([out.reshape(-1), n_emit, nxt, new_pos,
                          finite.long()]), lo

    # ------------------------------------------------------------- waves
    def _stage_wave(self, host, active_now):
        super()._stage_wave(host, active_now)
        host["spec_len"][:] = self._wave_spec_len

    def _prepare_wave(self, active_now):
        """Back every position the wave may write — pos .. pos + spec_len
        per lane (the draft's writes and the verify chunk's span) — with
        allocated, exclusively owned blocks. Allocation is atomic per
        lane; a lane that cannot get its span is starved out of the wave
        and preempted by recompute, as on the single-token engine."""
        starved, bs = [], self.block_size
        for s, live in enumerate(active_now):
            if not live:
                continue
            last_bi = (self.slot_pos[s] + self._wave_spec_len[s]) // bs
            blocks = self._slot_blocks[s]
            try:
                missing = last_bi + 1 - len(blocks)
                if missing > 0:
                    for blk in self.block_pool.alloc(missing):
                        blocks.append(blk)
                        self._tables[s, len(blocks) - 1] = blk
                for bi in range(self.slot_pos[s] // bs, last_bi + 1):
                    if self.block_pool.refcount(blocks[bi]) > 1:
                        self._ensure_private(s, bi)
            except BlockPoolExhausted:
                starved.append(s)
                active_now[s] = False
        self.last_starved_slots = starved
        return active_now

    def _rollback_spec_blocks(self, wave_slots):
        """Return the blocks allocated ahead that the acceptance did not
        commit: after the wave a lane holds exactly the blocks covering
        its committed positions [0, pos). Fresh speculative blocks are
        never hashed and never shared, so they go straight back."""
        bs = self.block_size
        for s in wave_slots:
            blocks = self._slot_blocks[s]
            needed = max(1, (self.slot_pos[s] + bs - 1) // bs)
            if len(blocks) > needed:
                extra = blocks[needed:]
                del blocks[needed:]
                self._tables[s, needed:] = 0
                self.block_pool.release(extra)

    def decode_wave(self):
        """One speculative wave: draft k, verify once, accept exactly.
        Returns {slot: [tokens]}, 1 .. k + 1 tokens per healthy lane (the
        scheduler streams them in order and retires mid-batch). Lanes
        whose logits went non-finite emit nothing and are listed in
        `last_nonfinite_slots`; every waved lane's speculation is rolled
        back. `last_spec_proposed` / `last_spec_accepted` count the
        wave's draft tokens (0 when no wave ran)."""
        self.last_spec_proposed = self.last_spec_accepted = 0
        active_now = list(self.slot_active)
        if not any(active_now):
            self.last_nonfinite_slots = []
            self.last_starved_slots = []
            return {}
        # per-lane draft span: the horizon clamps it (writes stop at
        # max_len - 1), and a lane with a dynamic token mask runs at 0, a
        # plain decode inside the same programs: its mask depends on
        # tokens not yet emitted, so a draft ahead of it could not be
        # held to it
        spec_len = [0] * self.num_slots
        for s, live in enumerate(active_now):
            if live:
                limit = self.max_len - 1 - self.slot_pos[s]
                want = 0 if self.slot_dynamic_mask[s] else self.spec_k
                spec_len[s] = max(0, min(want, limit))
        self._wave_spec_len = spec_len
        active_now = self._prepare_wave(active_now)
        if not any(active_now):
            self.last_nonfinite_slots = []
            return {}
        sampled = self._upload_wave(active_now)
        self.draft_program(sampled)
        picked, self.last_wave_logits = self.wave_program(sampled)
        self.decode_waves_run += 1
        # the one device->host sync of the wave
        read = picked.tolist()
        S, C = self.num_slots, self.spec_k + 1
        out_toks = read[:S * C]
        n_emit, nxt, new_pos, finite = (read[S * C + i * S:S * C + (i + 1) * S]
                                        for i in range(4))
        out, bad, waved = {}, [], []
        for s, was_active in enumerate(active_now):
            if not was_active:
                continue
            waved.append(s)
            if not finite[s]:
                bad.append(s)
                continue
            n = n_emit[s]
            self.last_spec_proposed += spec_len[s]
            self.last_spec_accepted += n - 1   # the extra token is never
            self.slot_pos[s] = new_pos[s]      # a draft's
            self.slot_tok[s] = nxt[s]
            out[s] = out_toks[s * C:s * C + n]
        self.last_nonfinite_slots = bad
        # blocks of rejected tokens go back now, non-finite lanes' too
        self._rollback_spec_blocks(waved)
        return out

    def _health(self):
        h = super()._health()
        h.update(speculative=True, spec_k=self.spec_k,
                 draft_compiles=self.draft_compiles)
        return h
