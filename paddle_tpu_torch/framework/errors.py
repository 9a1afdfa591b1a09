"""Typed errors + enforce helpers (the port of
`paddle_tpu/framework/errors.py`, unchanged: it is plain Python).

The reference's error machinery (paddle/fluid/platform/enforce.h
PADDLE_ENFORCE*, platform/errors.h, platform/error_codes.proto) as a typed
taxonomy of Python exception classes; Python tracebacks carry the op call
stack the reference reconstructs via framework/op_call_stack.cc.
"""


class PaddleTpuError(Exception):
    code = "LEGACY"


class InvalidArgumentError(PaddleTpuError, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(PaddleTpuError, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(PaddleTpuError, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(PaddleTpuError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(PaddleTpuError, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(PaddleTpuError, RuntimeError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(PaddleTpuError, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(PaddleTpuError, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(PaddleTpuError, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(PaddleTpuError, RuntimeError):
    code = "UNAVAILABLE"


class FatalError(PaddleTpuError, RuntimeError):
    code = "FATAL"


class ExternalError(PaddleTpuError, RuntimeError):
    code = "EXTERNAL"


def enforce(condition, message="", error_cls=PreconditionNotMetError):
    """ref PADDLE_ENFORCE (enforce.h). Raise typed error when false."""
    if not condition:
        raise error_cls(message)


def _short_spec(a):
    dt = getattr(a, "dtype", None)
    sh = getattr(a, "shape", None)
    if dt is None or sh is None:
        return type(a).__name__
    return f"{dt}[{','.join(str(s) for s in sh)}]"


def attach_op_context(exc, op_name, arrays=(), attrs=None, callstack=None):
    """ref framework/op_call_stack.cc InsertCallStackInfo + enforce.h's
    "Error Message Summary": append the failing operator's name, input
    specs, attrs, and (for desc replay) the python call stack recorded at
    op-creation time to the exception message IN PLACE — the type is
    preserved so existing `except ValueError` handlers keep working."""
    lines = [f"  [operator < {op_name} > error]"]
    if arrays:
        lines.append("  [inputs: "
                     + ", ".join(_short_spec(a) for a in arrays) + "]")
    if attrs:
        shown = {k: v for k, v in attrs.items() if not k.startswith("__")}
        if shown:
            lines.append(f"  [attrs: {shown}]")
    if callstack:
        lines.append("  [python call stack (op creation)]:")
        lines += [f"    {fr}" for fr in callstack]
    ctx = "\n".join(lines)
    msg = str(exc.args[0]) if exc.args else ""
    try:
        exc.args = (f"{msg}\n{ctx}",) + tuple(exc.args[1:])
    except (AttributeError, TypeError):
        pass        # exotic exception with immutable args: keep original
    return exc


def user_callstack(limit=5):
    """Non-framework frames of the current python stack, innermost last
    (the reference records these at op-definition time for static graphs
    so runtime failures point at model code, not executor internals)."""
    import traceback
    import os
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for fr in traceback.extract_stack()[:-1]:
        if fr.filename.startswith(pkg):
            continue
        out.append(f"{fr.filename}:{fr.lineno} in {fr.name}: "
                   f"{(fr.line or '').strip()}")
    return out[-limit:]


def enforce_eq(a, b, message="", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"expected {a!r} == {b!r}. {message}")


def enforce_shape(tensor, expected, message=""):
    got = tuple(tensor.shape)
    want = tuple(expected)
    ok = len(got) == len(want) and all(
        w in (-1, None) or g == w for g, w in zip(got, want))
    if not ok:
        raise InvalidArgumentError(
            f"shape mismatch: got {got}, expected {want}. {message}")
