"""Strategy transforms -> train-step rewrites (the port of
`paddle_tpu/jit/transforms.py`).

Each fleet meta-optimizer (`distributed/fleet/meta_optimizers.py`)
records its feature in `optimizer.transforms`; `jit.TrainStep` and
`distributed.sharded.ShardedTrainStep` read them here, so a strategy
changes what the step runs, as the reference's meta-optimizers rewrite
the program (ref fleet/base/fleet_base.py:1070, strategy_compiler.py:89):

  amp            -> the forward and loss under `amp.auto_cast` (O1: the
                    white/black lists of the op dispatcher; O2: the f32
                    parameters cast to the low dtype for the forward, the
                    f32 weights kept for the update, the casts
                    differentiable so the grads come back in f32)
  recompute      -> the forward and loss under `incubate.recompute`
                    (rematerialized in the backward)
  gradient_merge -> k-step gradient accumulation: the step adds its
                    grads into accumulators and runs the optimizer on
                    their sum (or mean) every k-th call, its step count
                    counting applied updates
  sharding       -> the ZeRO stage of ShardedTrainStep
  fp16_allreduce -> ShardedTrainStep's gradient reduction in f16/bf16
  pipeline       -> `fleet.build_train_step` builds
                    `distributed.pipeline.PipelineTrainStep` on a mesh
                    with 'pp' (its microbatches `accumulate_steps`)
  localsgd, dgc  -> recorded; the steps that consume them are ROADMAP
                    Queue 1 item 5c, and `fleet.build_train_step`
                    refuses them until then

The port's optimizers update in place (`optimizer.Optimizer.step`), so
`merged_update` and `init_grad_acc` work on lists of torch tensors
rather than on the JAX package's functional trees.
"""
import numpy as np
import torch

from ..framework import state


def resolve(optimizer):
    """The transform dict accumulated by the meta-optimizer chain."""
    return dict(getattr(optimizer, "transforms", None) or {})


def base_optimizer(optimizer):
    """The optimizer at the bottom of a meta-optimizer chain (each link
    holds the next as `inner_opt`): the one whose step() the train steps
    run."""
    while getattr(optimizer, "inner_opt", None) is not None:
        optimizer = optimizer.inner_opt
    return optimizer


def reduced_dtype(value, default=torch.float16):
    """A user-facing dtype spec ('float16', 'bf16', a numpy or torch
    dtype) as torch.float16 or torch.bfloat16."""
    if value is None:
        return default
    s = value if isinstance(value, (str, torch.dtype)) else np.dtype(value)
    s = str(s)
    if s.endswith(("bfloat16", "bf16")):
        return torch.bfloat16
    if s.endswith(("float16", "fp16", "half")):
        return torch.float16
    raise ValueError(f"unsupported reduced dtype {value!r}")


def wrap_forward(forward, transforms, model=None):
    """Apply amp/recompute to `forward(*args)` (the model's forward and
    the loss over the inputs and labels). Autocast innermost, recompute
    outermost (the recomputed segment replays the same casts). O2 needs
    `model`, an `nn.Layer`."""
    amp = transforms.get("amp")
    if amp:
        level = amp.get("level", "O1")
        low = reduced_dtype(amp.get("dtype"), default=torch.bfloat16)
        inner = forward
        if level == "O2" and not hasattr(model, "_use_state"):
            raise TypeError("amp O2 casts a Layer's parameters for the "
                            "forward: the model must be an nn.Layer")

        def amp_forward(*args):
            with state.amp_guard_ctx({"level": level, "dtype": low}):
                if level != "O2":
                    return inner(*args)
                params = {n: p.to(low) for n, p in
                          model.functional_state()[0].items()
                          if p.dtype == torch.float32}
                with model._use_state(params):
                    return inner(*args)

        forward = amp_forward
    rc = transforms.get("recompute")
    if rc is not None:
        _check_policy(rc)
        from ..incubate.recompute import recompute
        inner_rc = forward

        def rc_forward(*args):
            return recompute(inner_rc, *args)

        forward = rc_forward
    return forward


def _check_policy(rc_config):
    """The recompute strategy's `policy`: full rematerialization (None,
    "" or "full") is ported; the JAX package's "dots" (save every matmul
    output) is not."""
    pol = (rc_config or {}).get("policy")
    if pol in (None, "", "full"):
        return
    if pol == "dots":
        raise NotImplementedError(
            "recompute policy 'dots' (save the matmul outputs) is not "
            "ported; use 'full'")
    raise ValueError(f"unknown recompute policy {pol!r} "
                     "(expected 'full' or 'dots')")


def merge_config(transforms):
    """(k_steps, avg) for in-step gradient accumulation."""
    gm = transforms.get("gradient_merge") or {}
    return max(1, int(gm.get("k_steps", 1) or 1)), bool(gm.get("avg", True))


def zero_stage_of(transforms, default=0):
    """ZeRO stage implied by the sharding transform (ref
    sharding_optimizer.py 'sharding_degree'/'stage' configs)."""
    sh = transforms.get("sharding")
    if sh is None:
        return default
    return int(sh.get("stage", 1) or 1)


def init_grad_acc(params, k_steps):
    """Zero accumulators like `params` (torch tensors); empty when
    accumulation is off."""
    if k_steps <= 1:
        return []
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def merged_update(acc, grads, k_steps, avg, apply):
    """One micro-step of k-step accumulation: `grads` added into `acc`
    in place; when `apply`, returns the grads the optimizer takes (the
    sum, or the mean with `avg`) as new tensors and zeroes `acc`, else
    returns None."""
    torch._foreach_add_(acc, grads)
    if not apply:
        return None
    out = torch._foreach_div(acc, float(k_steps)) if avg else \
        [a.clone() for a in acc]
    torch._foreach_zero_(acc)
    return out
