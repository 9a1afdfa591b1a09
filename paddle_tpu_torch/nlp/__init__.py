"""Model zoo of the port (this slice: GPT, serving methods)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt2_small,
                  load_jax_state)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt2_small",
           "load_jax_state"]
