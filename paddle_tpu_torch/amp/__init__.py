"""paddle.amp: `auto_cast`, `decorate` and `GradScaler` (the port of
`paddle_tpu/amp/__init__.py`; ref python/paddle/amp, and the
check_finite_and_unscale and update_loss_scaling operators).

`auto_cast` sets the AMP state that the op dispatcher reads
(`framework.state.amp_guard_ctx`): an op on the white list
(`ops.dispatch.AMP_WHITE_LIST`: the matmuls, `linear`, the convolutions,
`flash_attention`) casts its f32 inputs to the low dtype, one on the
black list (the norms, softmax, the losses, the reductions) casts
low-precision inputs back to f32, and the rest follow their inputs. So
an f32 model's attention under `auto_cast()` runs the bf16 flash
kernels. The low dtype is bfloat16 by default; `dtype="float16"` casts
to f16, which the flash-attention kernels do not take (their wrapper
raises on the card). A graph captured under `auto_cast` (a
`jit.TrainStep`'s) keeps the casts it captured.

`decorate` (level O2) casts the models' parameters to the low dtype.
`GradScaler` keeps the reference's loss-scaling state machine: `scale`
multiplies the loss, `unscale_` divides the optimizer's gradients
(row-sparse ones included) and records whether any is inf or NaN,
`step` skips the optimizer's step when one was, and `update` halves the
scale after `decr_every_n_nan_or_inf` bad steps in a row and doubles it
after `incr_every_n_steps` good ones. Its host reads (`unscale_`'s
finite check) make it an eager-loop tool, as in the JAX package.

Not ported: the telemetry gauge and counter and the flight-recorder
journal of a skipped step (ROADMAP Queue 1 item 6).
"""
import contextlib

import torch

from ..framework import state
from ..ops.dispatch import AMP_BLACK_LIST, AMP_WHITE_LIST


def _low_dtype(dtype):
    return torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float16


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Run the block with the AMP lists on (ref paddle/amp/auto_cast.py);
    the custom lists are added for the block and the lists put back on
    exit."""
    if not enable:
        yield
        return
    saved_w = saved_b = None
    if custom_white_list:
        saved_w = set(AMP_WHITE_LIST)
        AMP_WHITE_LIST.update(custom_white_list)
    if custom_black_list:
        saved_b = set(AMP_BLACK_LIST)
        AMP_BLACK_LIST.update(custom_black_list)
    try:
        with state.amp_guard_ctx({"level": level,
                                  "dtype": _low_dtype(dtype)}):
            yield
    finally:
        if saved_w is not None:
            AMP_WHITE_LIST.clear()
            AMP_WHITE_LIST.update(saved_w)
        if saved_b is not None:
            AMP_BLACK_LIST.clear()
            AMP_BLACK_LIST.update(saved_b)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Level O2: the models' floating parameters and buffers cast to the
    low dtype, in place (an optimizer built over them keeps them).
    Returns the models, and the optimizers when given."""
    if level == "O2":
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=_low_dtype(dtype))
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """ref paddle/amp/grad_scaler.py:20 and fluid's AmpScaler: dynamic
    loss scaling over an optimizer's gradients."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling and enable
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of the optimizer's parameters by the
        scale, in place (a row-sparse gradient's values), and record
        whether any was inf or NaN (one read back to the host)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameters:
            g = p.grad
            if g is None:
                continue
            if g.is_sparse:
                g = g.coalesce()
                finite.append(torch.isfinite(g.values()).all())
                p.grad = g * inv
                continue
            finite.append(torch.isfinite(g).all())
            g.mul_(inv)
        self._found_inf = bool(finite) and \
            not bool(torch.stack(finite).all())

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        """Unscale, then the optimizer's step unless a gradient was inf
        or NaN."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """The loss-scaling state machine (ref update_loss_scaling_op)."""
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        """The current scale and the good/bad step counters that drive
        the next change."""
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = float(sd["scale"])
        self._good_steps = int(sd["good_steps"])
        self._bad_steps = int(sd["bad_steps"])

    set_state_dict = load_state_dict


AmpScaler = GradScaler
