"""Model zoo of the port: GPT and LLaMA (training forward and loss,
dense, paged and speculative serving, generate)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, generate,
                  gpt2_small, gpt_generate, gpt_pretrain_loss,
                  load_jax_optimizer_state, load_jax_state)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama_pretrain_loss)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "generate", "gpt2_small",
           "gpt_generate", "gpt_pretrain_loss", "llama_pretrain_loss",
           "load_jax_optimizer_state", "load_jax_state"]
