"""Device resolution and seeding for the PyTorch/CUDA port.

The device is always explicit: every engine, predictor and model
constructor takes `device=`. `None` means the CUDA card; when no card is
present the caller must ask for the CPU by name (`device="cpu"`, as the
tests do). Nothing falls back to the CPU quietly — a serving stack that
silently ran on the host would report host numbers under the card's
name.
"""
import random

import numpy as np
import torch


def resolve_device(device=None):
    """`torch.device` for a constructor's `device=` argument. None -> the
    current CUDA device; raises RuntimeError when that is asked for and
    no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:       # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(value):
    """Seed Python's, numpy's and torch's global generators (the
    framework-level `paddle.seed`). The serving engines draw from their
    own explicit `torch.Generator`s and do not depend on this."""
    value = int(value)
    random.seed(value)
    np.random.seed(value)
    torch.manual_seed(value)
