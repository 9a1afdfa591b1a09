"""PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays in the repository as the reference;
this package is its counterpart for NVIDIA Hopper cards. It mirrors the
JAX package's layout (`nn/paged_attention.py`, `nlp/gpt.py`,
`serving/...`, `inference/`) and imports neither `jax` nor anything
under `paddle_tpu`. Kernels the JAX package wrote in Pallas are CUDA C++
sources under `csrc/`, built with nvcc at first use.

Serving: `inference.Config().enable_llm_engine(...)` ->
`inference.create_llm_predictor` -> `serving.Scheduler` over the dense
`serving.ServingEngine` (the default: `nlp.GPTForPretraining.prefill`
on flash-attention kernel K1, dense `decode_step`) or
`serving.PagedServingEngine` (`paged=True`: `decode_step` /
`prefill_chunk` -> `nn.paged_attention`, kernel K4). Training:
`jit.TrainStep` over `nlp.GPTForPretraining` and the optimizers, on
K1-K3 and the fused Adam kernel.
"""
from .device import resolve_device, seed

__all__ = ["resolve_device", "seed"]
