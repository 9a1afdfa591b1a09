"""Model zoo of the port (GPT: training forward and loss, dense and
paged serving, generate)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, generate,
                  gpt2_small, gpt_generate, gpt_pretrain_loss,
                  load_jax_optimizer_state, load_jax_state)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "generate",
           "gpt2_small", "gpt_generate", "gpt_pretrain_loss",
           "load_jax_optimizer_state", "load_jax_state"]
