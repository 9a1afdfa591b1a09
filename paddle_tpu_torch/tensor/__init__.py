"""paddle.tensor namespace (the port of `paddle_tpu/tensor/__init__.py`;
ref python/paddle/tensor): re-exports the op library by category. Only
functions DEFINED in each ops module are exported (no star-import leakage
of torch/Tensor/dispatch helpers)."""
from ..ops import math, manipulation, creation, logic, linalg  # noqa: F401


def _reexport(mod):
    out = {}
    for name in dir(mod):
        if name.startswith("_"):
            continue
        obj = getattr(mod, name)
        if callable(obj) and getattr(obj, "__module__", "") == mod.__name__:
            out[name] = obj
    return out


# creation last so shared names (e.g. assign) resolve like the top-level
# package, which imports creation's explicitly
for _mod in (math, manipulation, logic, creation):
    globals().update(_reexport(_mod))
del _mod, _reexport
