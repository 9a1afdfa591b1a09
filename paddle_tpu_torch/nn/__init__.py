"""Neural-network pieces of the port: the paged KV-cache primitives
(`transformer`), the fused paged-attention dispatch (`paged_attention`)
and gradient clipping (`clip`)."""
from . import clip, paged_attention, transformer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["clip", "paged_attention", "transformer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue"]
