"""BlockPool: host-side memory manager for the paged KV cache (the
port's own copy of `paddle_tpu/serving/paged/block_pool.py`, without the
chaos and metrics hooks).

The device side is a fixed pool of KV blocks per layer,
`[num_blocks, kv_heads, block_size, head_dim]` x2, allocated once at
engine construction. This class owns the block ids: a free list with
refcounts, per-request allocation, and a hash-based prefix cache so
identical prompt prefixes map to the SAME physical blocks.

Invariants the engine relies on:

  * block 0 is the scratch block — never allocated, never hashed; lanes
    outside the wave and padded chunk tails write there;
  * only FULL prompt blocks are hashed (chain hash over the whole token
    prefix, which for a causal LM determines the block's K/V exactly),
    and a hash is registered only AFTER the prefill chunk that wrote the
    block ran;
  * a freed block keeps its hash and stays matchable from the free list
    until allocation needs it back (oldest-freed first);
  * `cow()` is the copy-on-write guard: writing through a block with
    refcount > 1 first moves the writer onto a private copy.

Driven single-threaded from the scheduler's wave loop.
"""
import collections
import hashlib


class BlockPoolExhausted(RuntimeError):
    """Allocation failed: every usable block is referenced. The scheduler
    treats this as capacity, not as a request fault."""


class BlockPool:
    SCRATCH = 0

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (one scratch + "
                             f"one usable), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # free list in eviction order (oldest-freed first)
        self._free = collections.OrderedDict(
            (b, None) for b in range(1, self.num_blocks))
        self._ref = [0] * self.num_blocks
        self._hash_to_block = {}
        self._block_hash = {}
        self.prefix_hits = 0
        self.prefix_misses = 0

    # ------------------------------------------------------------- state
    @property
    def usable(self):
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def used(self):
        """Blocks currently referenced by at least one request."""
        return self.usable - len(self._free)

    def refcount(self, block):
        return self._ref[block]

    def outstanding(self):
        """{block_id: refcount} for every live block (empty once a stream
        has drained)."""
        return {b: r for b, r in enumerate(self._ref) if r > 0}

    # -------------------------------------------------------- allocation
    def alloc(self, n):
        """Take `n` fresh blocks (refcount 1 each), preferring blocks with
        no cached hash. All or none: raises BlockPoolExhausted when fewer
        than `n` are free."""
        n = int(n)
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"need {n} block(s), {len(self._free)} free of "
                f"{self.usable} usable")
        out = []
        for _ in range(n):
            blk = next((b for b in self._free
                        if b not in self._block_hash), None)
            if blk is None:
                blk = next(iter(self._free))       # evict oldest cached
            del self._free[blk]
            h = self._block_hash.pop(blk, None)
            if h is not None and self._hash_to_block.get(h) == blk:
                del self._hash_to_block[h]
            self._ref[blk] = 1
            out.append(blk)
        return out

    def acquire(self, block):
        """Add one reference to an already-referenced block (sharing)."""
        if self._ref[block] < 1:
            raise ValueError(f"block {block} is not live")
        self._ref[block] += 1

    def release(self, blocks):
        """Drop one reference per block; refcount 0 returns the block to
        the free list, keeping its prefix hash."""
        for blk in blocks:
            if self._ref[blk] < 1:
                raise ValueError(f"double free of block {blk}")
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                self._free[blk] = None

    def cow(self, block):
        """Copy-on-write guard: `block` itself when exclusively owned;
        otherwise a fresh block takes over one reference — the caller
        must copy the device content before writing through it."""
        if self._ref[block] <= 1:
            return block
        new, = self.alloc(1)
        self._ref[block] -= 1
        return new

    # ------------------------------------------------------ prefix cache
    @staticmethod
    def chain_hash(prev, tokens):
        """sha256 of one full block's tokens chained onto its prefix (not
        the builtin hash(): a collision would serve one request's cache
        to another)."""
        h = hashlib.sha256(b"" if prev is None else prev)
        h.update(repr(tuple(int(t) for t in tokens)).encode())
        return h.digest()

    def match_prefix(self, tokens):
        """Longest run of cached full blocks covering `tokens`' prefix.
        Returns (blocks, hashes) with one NEW reference per matched block
        (the caller releases them on failure). Counts nothing: the caller
        counts via count_prefix on a successful admission."""
        bs = self.block_size
        blocks, hashes, h = [], [], None
        for i in range(len(tokens) // bs):
            h = self.chain_hash(h, tokens[i * bs:(i + 1) * bs])
            blk = self._hash_to_block.get(h)
            if blk is None:
                break
            if self._ref[blk] == 0:            # revive off the free list
                del self._free[blk]
            self._ref[blk] += 1
            blocks.append(blk)
            hashes.append(h)
        return blocks, hashes

    def peek_prefix_hashes(self, hashes):
        """Read-only affinity probe over a chain-hash walk
        (`prompt_hashes`): how many leading hashes this pool holds now.
        Takes no reference and counts nothing (`match_prefix` is the
        acquiring form)."""
        n = 0
        for h in hashes:
            if h not in self._hash_to_block:
                break
            n += 1
        return n

    def count_prefix(self, hits, misses):
        """Count one admitted prompt's prefix-cache outcome."""
        self.prefix_hits += int(hits)
        self.prefix_misses += int(misses)

    def prompt_hashes(self, tokens):
        """Chain hashes for every full block of `tokens`."""
        bs = self.block_size
        out, h = [], None
        for i in range(len(tokens) // bs):
            h = self.chain_hash(h, tokens[i * bs:(i + 1) * bs])
            out.append(h)
        return out

    # --------------------------------------------------- block-level handoff
    def export_blocks(self, blocks):
        """The allocator's half of a block-level handoff: one manifest
        entry per live block, carrying its prefix-cache chain hash (None
        for an unhashed block: the partial tail, or a hash another block
        won). The device content travels separately
        (`PagedServingEngine.export_slot_kv`)."""
        for blk in blocks:
            if blk == self.SCRATCH:
                raise ValueError("scratch block cannot be exported")
            if self._ref[blk] < 1:
                raise ValueError(f"block {blk} is not live")
        return [{"hash": self._block_hash.get(blk)} for blk in blocks]

    def import_blocks(self, manifest):
        """Fresh local blocks to receive an exported manifest, all or
        none (BlockPoolExhausted is capacity), in manifest order. The
        caller registers the hashes only once the content is written."""
        return self.alloc(len(manifest))

    def register_hash(self, block, chain_hash):
        """Enter a WRITTEN full prompt block into the prefix cache (first
        writer wins)."""
        if self._ref[block] < 1:
            raise ValueError(f"block {block} is not live")
        if chain_hash in self._hash_to_block:
            return
        self._hash_to_block[chain_hash] = block
        self._block_hash[block] = chain_hash

    def stats(self):
        return {
            "used": self.used, "usable": self.usable,
            "block_size": self.block_size,
            "cached_hashes": len(self._hash_to_block),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
        }
