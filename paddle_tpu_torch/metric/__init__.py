"""paddle.metric (the port of `paddle_tpu/metric/__init__.py`; ref
python/paddle/metric/metrics.py): `Metric`, `Accuracy`, `Precision`,
`Recall`, `Auc` and `accuracy`.

`Accuracy.compute` takes the top k on the tensor's own device
(`torch.topk`, sorted): on the card the logits stay there and only the
[N, k] hit mask comes back to the host in `update`. The JAX package
argsorts on the host; the two agree wherever the top k has no ties.
The other metrics count on the host in numpy, as the JAX package's do.
"""
import numpy as np
import torch

from ..framework.tensor import Tensor, unwrap


def _np(x):
    """A host numpy array of a Tensor, a torch tensor or array-like data
    (float32 for bfloat16)."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)


def _torch(x):
    x = unwrap(x)
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """[N, maxk] float hits: column j is 1 where the label is the
        j-th largest logit. A label of the logits' rank is one-hot (its
        argmax) or [N, 1]."""
        p = _torch(pred)
        lab = _torch(label).to(p.device)
        if lab.dim() == p.dim():             # one-hot or [N, 1]
            if lab.shape[-1] == p.shape[-1]:
                lab = lab.argmax(-1)
            else:
                lab = lab.reshape(lab.shape[0])
        k = min(self.maxk, p.shape[-1])
        idx = torch.topk(p, k, dim=-1).indices
        return Tensor._wrap((idx == lab[..., None]).float())

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        num = c.shape[0]
        for i, k in enumerate(self.topk):
            hit = c[..., :k].sum()
            self.total[i] += hit
            self.count[i] += num
            accs.append(hit / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Histogram AUC (ref metrics.py Auc: the same bucketed estimator)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _np(labels).reshape(-1).astype(np.int64)
        idx = np.clip((p * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx[lab == 1], 1)
        np.add.at(self._stat_neg, idx[lab == 0], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos[::-1].cumsum()
        tot_neg = self._stat_neg[::-1].cumsum()
        tp, fp = 0.0, 0.0
        auc = 0.0
        prev_tp, prev_fp = 0.0, 0.0
        for i in range(len(tot_pos)):
            tp, fp = tot_pos[i], tot_neg[i]
            auc += (fp - prev_fp) * (tp + prev_tp) / 2.0
            prev_tp, prev_fp = tp, fp
        if tp == 0 or fp == 0:
            return 0.0
        return float(auc / (tp * fp))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    from ..ops.math import accuracy as _acc
    return _acc(input, label, k=k)
