"""Weight-decay regularizers (the port of `paddle_tpu/regularizer.py`;
ref python/paddle/fluid/regularizer.py L1Decay / L2Decay), appended to
the gradient when the optimizer steps.

An optimizer takes one as `weight_decay` (a float there means L2Decay),
and a parameter's own `regularizer` attribute overrides it. The term is
added in the dtype of the weight the rule updates (the f32 master under
multi_precision), as `append(base, grad)`, with the coefficient rounded
to that dtype first as the JAX package's weakly typed scalar is.
"""
import torch


class WeightDecayRegularizer:
    #: the fused Adam kernel's gradient-term mode (optimizer/fused_adam.py)
    mode = None

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def coeff_in(self, dtype):
        """The coefficient rounded to f32, then to `dtype`."""
        return float(torch.tensor(self._coeff, dtype=torch.float32).to(dtype))

    def append(self, base, grad):
        """grad + the decay term of `base`, in their dtype."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._coeff})"


class L2Decay(WeightDecayRegularizer):
    """g + coeff * p."""
    mode = "l2"

    def append(self, base, grad):
        return grad + self.coeff_in(base.dtype) * base


class L1Decay(WeightDecayRegularizer):
    """g + coeff * sign(p), with sign(0) = 0 as `jnp.sign` has it (a NaN
    weight adds 0 here, where `jnp.sign` gives NaN; the weight itself
    stays NaN either way)."""
    mode = "l1"

    def append(self, base, grad):
        return grad + self.coeff_in(base.dtype) * torch.sign(base)


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
