"""Recommendation model zoo (the port of `paddle_tpu/rec`): the BASELINE
"Wide&Deep / DeepFM" model families (ref PaddleRec wide_deep/deepfm
nets). The embedding tables are ordinary dense Parameters, trained on
one card through `jit.TrainStep`; `wide_deep_sparse_loss`, the
parameter-server variant, waits for the distributed tier (ROADMAP
Queue 1 item 5).
"""
from .models import WideDeep, DeepFM, ctr_loss, wide_deep_sparse_loss

__all__ = ["WideDeep", "DeepFM", "ctr_loss", "wide_deep_sparse_loss"]
