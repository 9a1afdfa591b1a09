"""PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays in the repository as the reference;
this package is its counterpart for NVIDIA Hopper cards. It mirrors the
JAX package's layout (`nn/paged_attention.py`, `nlp/gpt.py`,
`serving/...`, `inference/`) and imports neither `jax` nor anything
under `paddle_tpu`. Kernels the JAX package wrote in Pallas are CUDA C++
sources under `csrc/`, built with nvcc at first use.

The first slice is paged serving of GPT models:
`inference.Config().enable_llm_engine(paged=True, ...)` ->
`inference.create_llm_predictor` -> `serving.Scheduler` over
`serving.PagedServingEngine` -> `nlp.GPTForPretraining.decode_step` /
`prefill_chunk` -> `nn.paged_attention`.
"""
from .device import resolve_device, seed

__all__ = ["resolve_device", "seed"]
