"""Gradient clipping (the port of `paddle_tpu/nn/clip.py`). Each clip
takes a list of (param, grad) pairs and returns new pairs; grads that
are None pass through."""
import torch


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    """Each grad scaled to at most `clip_norm` in its own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return g * scale

    def __call__(self, params_grads):
        return [(p, g if g is None else self._clip_one(g))
                for p, g in params_grads]


class ClipGradByGlobalNorm:
    """All grads scaled by clip / max(global_norm, clip), the global norm
    accumulated in f32."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _scale(self, grads):
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        return self.clip_norm / torch.clamp(torch.sqrt(sq),
                                            min=self.clip_norm)

    def __call__(self, params_grads):
        live = [g for _, g in params_grads if g is not None]
        if not live:
            return params_grads
        scale = self._scale(live)
        return [(p, g if g is None else g * scale.to(g.dtype))
                for p, g in params_grads]


# fluid aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
