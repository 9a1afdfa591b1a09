"""Model zoo of the port, each model an `nn.Layer`: GPT and LLaMA
(training forward and loss, dense, paged and speculative serving,
generate) and BERT (pretraining)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, generate,
                  gpt2_medium, gpt2_small, gpt_generate, gpt_pretrain_loss,
                  load_jax_optimizer_state, load_jax_state)
from .bert import (BertConfig, BertForPretraining, BertModel, bert_base,
                   bert_large, bert_pretrain_loss)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama_pretrain_loss)

__all__ = ["BertConfig", "BertForPretraining", "BertModel", "GPTConfig",
           "GPTForPretraining", "GPTModel", "LlamaConfig",
           "LlamaForCausalLM", "LlamaModel", "bert_base", "bert_large",
           "bert_pretrain_loss", "generate", "gpt2_medium", "gpt2_small",
           "gpt_generate", "gpt_pretrain_loss", "llama_pretrain_loss",
           "load_jax_optimizer_state", "load_jax_state"]
