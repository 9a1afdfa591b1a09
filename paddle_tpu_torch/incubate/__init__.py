"""paddle_tpu_torch.incubate (the port of `paddle_tpu/incubate`; ref
python/paddle/fluid/incubate and python/paddle/incubate): recompute,
auto-checkpoint, the segment reductions, the optimizer wrappers, and the
MoE layer (`incubate.moe`, imported on first use)."""
from . import recompute  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import train_epoch_range, TrainEpochRange  # noqa: F401
# ref python/paddle/incubate: the optimizer wrappers surface here too
from ..optimizer.wrappers import (ModelAverage,  # noqa: F401
                                  LookaheadOptimizer as LookAhead)


def _segment(pool_type):
    def fn(data, segment_ids, name=None, num_segments=None):
        """ref python/paddle/incubate/tensor/math.py segment_{sum,mean,
        max,min} over the registered segment_pool op (ops/legacy.py).
        Without num_segments the output size is read from the device
        (the last id + 1): pass it inside a CUDA graph."""
        from ..ops.legacy import segment_pool
        return segment_pool(data, segment_ids, pool_type=pool_type,
                            num_segments=num_segments)
    fn.__name__ = f"segment_{pool_type.lower()}"
    return fn


segment_sum = _segment("SUM")
segment_mean = _segment("MEAN")
segment_max = _segment("MAX")
segment_min = _segment("MIN")


def __getattr__(name):
    if name == "moe":
        import importlib
        return importlib.import_module(__name__ + ".moe")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
