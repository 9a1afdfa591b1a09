"""Optimizers of the port (this slice: SGD, Adam, AdamW; the other
rules and `lr.py` are ROADMAP Queue 1 items)."""
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
