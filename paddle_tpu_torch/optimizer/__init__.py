"""Optimizers of the port (`paddle_tpu.optimizer`'s counterpart): the
update rules, the learning-rate schedulers (`lr`) and the wrappers."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Dpsgd,
                        Ftrl, Lamb, Lars, Momentum, Optimizer, RMSProp)
from .wrappers import (ExponentialMovingAverage, GradientMergeOptimizer,
                       LookaheadOptimizer, ModelAverage)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "Ftrl", "Dpsgd",
           "ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
           "GradientMergeOptimizer"]
