"""Neural-network pieces of the port: the dense and paged KV-cache
primitives (`transformer`), the fused paged-attention dispatch
(`paged_attention`), the sampling filters of generation (`decode`) and
gradient clipping (`clip`)."""
from . import clip, decode, paged_attention, transformer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)

__all__ = ["clip", "decode", "paged_attention", "transformer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue"]
