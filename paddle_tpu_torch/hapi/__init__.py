"""paddle.hapi (the port of `paddle_tpu/hapi`): `Model` and `summary`,
and the callbacks."""
from .model import Model, summary
from . import callbacks
