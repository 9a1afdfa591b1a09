"""Paged KV cache: the host block allocator, the block-table engine and
its speculative sibling, and the block-level KV handoff's refusal."""
from .block_pool import BlockPool, BlockPoolExhausted
from .engine import (HANDOFF_VERSION, HandoffRefused, PagedServingEngine,
                     SpeculativePagedEngine)

__all__ = ["BlockPool", "BlockPoolExhausted", "HANDOFF_VERSION",
           "HandoffRefused", "PagedServingEngine", "SpeculativePagedEngine"]
