"""BERT encoder and its pretraining heads (the port of
`paddle_tpu/nlp/bert.py`; BERT-base pretraining is the repo's north-star
configuration).

Built as the JAX package builds it, from the port's `nn` layers: the
embeddings (word, position and token-type tables summed, LayerNorm eps
1e-12, dropout), `nn.TransformerEncoder` over post-norm GELU
`TransformerEncoderLayer`s, a tanh pooler on the first token, and the
MLM and NSP heads with the MLM decoder weight tied to the word
embeddings. The state-dict keys, shapes and [in, out] Linear layout are
the JAX model's: the tied weight is listed once, under
`bert.embeddings.word_embeddings.weight`, so a JAX model's
`state_dict()` loads with `set_state_dict` as it is.

The word embedding carries the JAX model's vocab-parallel hint
(`sharding` = PartitionSpec('mp', None)) but no split layout: it feeds
the tied MLM head, which has no sharded form here, so a step over a mesh
with 'mp' keeps it (and all of BERT) replicated over 'mp'. Under GSPMD a
hint only changes where the table is stored, so the results are the
same.

Attention is `MultiHeadAttention`'s: with no `attention_mask` and no
attention dropout it feeds the registered `flash_attention` op [B, S,
H, D] views, non-causal (K1 forward, dd, K2 and K3 backward on the card
when S is a multiple of 128); a padding mask (added as -1e9 to the
scores of the masked keys) or attention dropout takes the dense route,
as in the JAX package.

The models take either kind of tensor: torch ids give torch outputs,
port `Tensor`s give Tensors. `BertForPretraining` draws its weights on
the CPU from a framework generator seeded with `seed`, then moves them
to `device` (None = the CUDA card) and casts them to `dtype`.
"""
import torch

from .. import nn
from ..device import resolve_device
from ..distributed.mesh import MP_AXIS, PartitionSpec
from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..nn import functional as F
from ..ops.math import matmul
from .gpt import _normal_attr, as_tensor_in


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_seq_len=512,
                 type_vocab_size=2, dropout=0.1, attn_dropout=0.1,
                 initializer_range=0.02, use_recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute


def bert_base(**kw):
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072, **kw)


def bert_large(**kw):
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, **kw)


def _wrap(x):
    return Tensor._wrap(x) if isinstance(x, torch.Tensor) else x


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        attr = _normal_attr(cfg.initializer_range)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            weight_attr=attr)
        self.word_embeddings.weight.sharding = PartitionSpec(MP_AXIS, None)
        self.position_embeddings = nn.Embedding(cfg.max_seq_len,
                                                cfg.hidden_size,
                                                weight_attr=attr)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size,
                                                  weight_attr=attr)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        ids = _wrap(input_ids)
        d = ids._data
        if position_ids is None:        # int32, as the JAX package's
            position_ids = torch.arange(d.shape[-1], dtype=torch.int32,
                                        device=d.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(d)
        x = (self.word_embeddings(ids)
             + self.position_embeddings(_wrap(position_ids))
             + self.token_type_embeddings(_wrap(token_type_ids)))
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu",
            attn_dropout=cfg.attn_dropout, act_dropout=0.0,
            weight_attr=_normal_attr(cfg.initializer_range))
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(sequence output [B, S, H], pooled [B, H]). `attention_mask`
        [B, S] is 1 for a token and 0 for padding; it takes the dense
        route."""
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            m = _wrap(attention_mask).astype("float32")
            mask = (1.0 - m.unsqueeze(1).unsqueeze(2)) * -1e9
        seq_out = self.encoder(x, src_mask=mask)
        pooled = F.tanh(self.pooler_dense(seq_out[:, 0]))
        return seq_out, pooled


class BertPretrainingHeads(nn.Layer):
    def __init__(self, cfg, embedding_weights):
        super().__init__()
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.decoder_weight = embedding_weights          # tied
        self.decoder_bias = self.create_parameter([cfg.vocab_size],
                                                  is_bias=True)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(F.gelu(self.transform(sequence_output)))
        mlm_logits = matmul(h, self.decoder_weight,
                            transpose_y=True) + self.decoder_bias
        nsp_logits = self.seq_relationship(pooled_output)
        return mlm_logits, nsp_logits


class BertForPretraining(nn.Layer):
    """BERT with the MLM and NSP heads. Starts in eval mode; call
    `.train()` to train, or let `jit.TrainStep` do it."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        with state.host_init_ctx(int(seed)):
            self.bert = BertModel(cfg)
            self.cls = BertPretrainingHeads(
                cfg, self.bert.embeddings.word_embeddings.weight)
        self.cfg = cfg
        self.to(device=dev, dtype=dtype)
        self.eval()

    @property
    def device(self):
        return self.bert.pooler_dense.weight._data.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(MLM logits [B, S, vocab], NSP logits [B, 2])."""
        ids, torch_in = as_tensor_in(input_ids)
        seq_out, pooled = self.bert(ids, token_type_ids, attention_mask)
        mlm, nsp = self.cls(seq_out, pooled)
        return (mlm._data, nsp._data) if torch_in else (mlm, nsp)


def bert_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    """The MLM loss over the positions whose label is not -100, plus the
    NSP loss (torch logits give a torch loss, Tensors a Tensor). Inside
    a `distributed.ShardedTrainStep` each term is this rank's share of
    the global mean (`sharded.global_mean`): a rank's count of masked
    positions is its own, so the mean of the ranks' means would not be
    the global batch's loss."""
    from ..distributed.sharded import global_mean
    torch_in = isinstance(mlm_logits, torch.Tensor)
    mlm_logits, nsp_logits = _wrap(mlm_logits), _wrap(nsp_logits)
    mlm_labels, nsp_labels = _wrap(mlm_labels), _wrap(nsp_labels)
    b, s, v = mlm_logits.shape
    mlm = F.cross_entropy(mlm_logits.reshape([b * s, v]),
                          mlm_labels.reshape([b * s]), ignore_index=-100)
    mlm = global_mean(mlm, (mlm_labels._data != -100).sum())
    nsp = global_mean(F.cross_entropy(nsp_logits, nsp_labels),
                      int(nsp_labels.shape[0]))
    loss = mlm + nsp
    return unwrap(loss) if torch_in else loss
