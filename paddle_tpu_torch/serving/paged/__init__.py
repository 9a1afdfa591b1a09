"""Paged KV cache: the host block allocator, the block-table engine and
its speculative sibling."""
from .block_pool import BlockPool, BlockPoolExhausted
from .engine import PagedServingEngine, SpeculativePagedEngine

__all__ = ["BlockPool", "BlockPoolExhausted", "PagedServingEngine",
           "SpeculativePagedEngine"]
