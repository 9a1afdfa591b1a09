"""Paged KV cache: the host block allocator and the block-table engine."""
from .block_pool import BlockPool, BlockPoolExhausted
from .engine import PagedServingEngine

__all__ = ["BlockPool", "BlockPoolExhausted", "PagedServingEngine"]
