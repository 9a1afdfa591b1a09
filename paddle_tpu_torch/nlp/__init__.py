"""Model zoo of the port (GPT: training forward and loss, paged
serving)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt2_small,
                  gpt_pretrain_loss, load_jax_optimizer_state,
                  load_jax_state)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt2_small",
           "gpt_pretrain_loss", "load_jax_optimizer_state",
           "load_jax_state"]
