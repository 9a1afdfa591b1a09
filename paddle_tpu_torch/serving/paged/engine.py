"""PagedServingEngine: block-table KV cache over the ServingEngine wave
machinery (the port of `paddle_tpu/serving/paged/engine.py`, without the
KV handoff and without speculative decoding).

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
"""
import numpy as np
import torch

from ...nn import paged_attention
from ...nn.decode import gumbel_
from ..engine import ServingEngine, _select_first_token
from .block_pool import BlockPool, BlockPoolExhausted


class PagedServingEngine(ServingEngine):
    """Block-table batched decode executor.

    model: a causal LM exposing init_paged_cache / decode_step(...,
        block_tables=) / prefill_chunk (GPTForPretraining).
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
                      top_k=0, top_p=1.0, logit_bias=None):
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
                                             top_p, logit_bias),
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
    def _ensure_private(self, slot, bi):
        """Give the slot a private copy of table entry `bi`: the pool
        moves the reference, the device content is copied in place."""
        blocks = self._slot_blocks[slot]
        blk = blocks[bi]
        new = self.block_pool.cow(blk)
        if new == blk:
            return
        for ck, cv in self._caches:
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
