"""Neural-network pieces of the port: the paged KV-cache primitives
(`transformer`) and the fused paged-attention dispatch
(`paged_attention`)."""
from . import paged_attention, transformer

__all__ = ["paged_attention", "transformer"]
