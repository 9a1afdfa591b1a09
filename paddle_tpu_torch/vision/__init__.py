"""paddle.vision (the port of `paddle_tpu/vision`; ref python/paddle/vision):
the model zoo, transforms and datasets. The detection ops (`vision/ops.py`)
are not ported yet (ROADMAP Queue 1 item 4)."""
from . import models
from . import transforms
from . import datasets
