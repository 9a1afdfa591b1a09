"""paddle.compat (the port of `paddle_tpu/compat.py`; ref
python/paddle/compat.py): the py2/3 helpers the 1.x API referenced."""


def to_text(obj, encoding="utf-8"):
    if isinstance(obj, bytes):
        return obj.decode(encoding)
    return str(obj)


def to_bytes(obj, encoding="utf-8"):
    if isinstance(obj, str):
        return obj.encode(encoding)
    return bytes(obj)


def round(x, d=0):          # noqa: A001
    """Half-AWAY-FROM-ZERO rounding (the reference's compat.round exists
    to avoid Python 3's banker's rounding)."""
    import math as _math
    scale = 10 ** d
    v = x * scale
    r = _math.floor(abs(v) + 0.5) * (1 if v >= 0 else -1)
    return r / scale


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    return str(exc)
