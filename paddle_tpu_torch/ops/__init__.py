"""Operators of the port that hold a kernel: flash attention (K1-K3)."""
from . import flash_attention

__all__ = ["flash_attention"]
