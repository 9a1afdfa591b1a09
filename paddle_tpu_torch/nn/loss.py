"""Loss layers (the port of `paddle_tpu/nn/loss.py`; ref
python/paddle/nn/layer/loss.py)."""
from . import functional as F
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, reduction=self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, reduction=self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self.reduction,
                                delta=self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, reduction=self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, margin=self.margin,
                                     reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, margin=self.margin,
                                      reduction=self.reduction)


class CTCLoss(Layer):
    """log_probs [T, B, C] raw logits, labels [B, Lmax] padded."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree (custom
    path tables unsupported)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("HSigmoidLoss: custom trees "
                                      "unsupported")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = (self.create_parameter([num_classes - 1, 1],
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)
