"""Wide&Deep and DeepFM (the port of `paddle_tpu/rec/models.py`; ref
PaddleRec models/rank/{wide_deep,deepfm}).

Both models take
  sparse_ids: int tensor [B, n_fields] of feature ids into one shared
              vocabulary (field offsets pre-applied, the usual PS layout)
  dense_x:    float tensor [B, n_dense] of continuous features
and return logits [B] (binary CTR-style objective). The layers, their
state-dict keys and their initializers are the JAX package's.
"""
from .. import nn
from ..nn import functional as F
from ..ops.manipulation import concat


class _MLP(nn.Layer):
    def __init__(self, in_dim, hidden, act="relu"):
        super().__init__()
        layers = []
        d = in_dim
        for h in hidden:
            layers.append(nn.Linear(d, h))
            layers.append(nn.ReLU())
            d = h
        layers.append(nn.Linear(d, 1))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class WideDeep(nn.Layer):
    """wide (linear-over-ids) + deep (embedding MLP) joint logit."""

    def __init__(self, vocab_size, emb_dim=8, n_fields=4, n_dense=4,
                 hidden=(64, 32)):
        super().__init__()
        self.vocab_size = vocab_size
        self.emb_dim = emb_dim
        self.n_fields = n_fields
        # wide part: per-id scalar weight == 1-dim embedding
        self.wide_emb = nn.Embedding(vocab_size, 1)
        self.deep_emb = nn.Embedding(vocab_size, emb_dim)
        self.deep_mlp = _MLP(n_fields * emb_dim + n_dense, list(hidden))
        self.bias = self.create_parameter(
            [1], default_initializer=nn.initializer.Constant(0.0))

    def forward(self, sparse_ids, dense_x):
        b = sparse_ids.shape[0]
        wide = self.wide_emb(sparse_ids).reshape([b, self.n_fields]) \
                   .sum(axis=1)
        emb = self.deep_emb(sparse_ids).reshape(
            [b, self.n_fields * self.emb_dim])
        deep_in = concat([emb, dense_x], axis=1)
        deep = self.deep_mlp(deep_in).reshape([b])
        return wide + deep + self.bias


class DeepFM(nn.Layer):
    """FM second-order interactions + deep MLP over shared embeddings
    (ref deepfm_net: first_order + sum-square trick + DNN)."""

    def __init__(self, vocab_size, emb_dim=8, n_fields=4, n_dense=0,
                 hidden=(64, 32)):
        super().__init__()
        self.vocab_size = vocab_size
        self.emb_dim = emb_dim
        self.n_fields = n_fields
        self.first_emb = nn.Embedding(vocab_size, 1)
        self.second_emb = nn.Embedding(vocab_size, emb_dim)
        self.mlp = _MLP(n_fields * emb_dim + n_dense, list(hidden))
        self.bias = self.create_parameter(
            [1], default_initializer=nn.initializer.Constant(0.0))

    def forward(self, sparse_ids, dense_x=None):
        b = sparse_ids.shape[0]
        first = self.first_emb(sparse_ids).reshape([b, self.n_fields]) \
                    .sum(axis=1)
        e = self.second_emb(sparse_ids)          # [B, F, D]
        # FM: 0.5 * sum_d((sum_f e)^2 - sum_f e^2)
        s = e.sum(axis=1)
        fm = 0.5 * (s * s - (e * e).sum(axis=1)).sum(axis=1)
        flat = e.reshape([b, self.n_fields * self.emb_dim])
        deep_in = flat if dense_x is None \
            else concat([flat, dense_x], axis=1)
        deep = self.mlp(deep_in).reshape([b])
        return first + fm + deep + self.bias


def ctr_loss(logits, labels):
    """Binary logistic loss on raw logits (ref log_loss over sigmoid)."""
    return F.binary_cross_entropy_with_logits(logits, labels)


def wide_deep_sparse_loss(n_fields, emb_dim, n_dense, hidden=(64, 32)):
    """The parameter-server variant (the deep embedding block from a host
    sparse table, for the PS trainers): not ported yet, with the
    parameter server (ROADMAP Queue 1 item 5)."""
    raise NotImplementedError(
        "wide_deep_sparse_loss feeds the parameter-server trainers, which "
        "are not ported yet (ROADMAP Queue 1 item 5)")
