"""paddle.vision (the port of `paddle_tpu/vision`; ref python/paddle/vision):
the model zoo, transforms, datasets and the detection ops (`ops`)."""
from . import models
from . import transforms
from . import datasets
from . import ops
