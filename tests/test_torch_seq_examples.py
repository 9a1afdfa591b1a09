"""Port twins of the JAX package's recurrent examples, trained on the CPU:
`examples/rnn_encoder_decoder.py` (GRU encoder -> GRU decoder,
`TrainStep`), `examples/label_semantic_roles.py` (bidirectional GRU +
`linear_chain_crf`, `crf_decoding` for tag accuracy, on `text.Conll05st`),
`examples/machine_translation.py` (a GRU encoder, then a per-step
`GRUCell` + dot-attention loop; greedy and `BeamSearchDecoder` /
`dynamic_decode` decoding; on `text.WMT16`), `examples/word2vec.py`
(an n-gram model on `text.Imikolov`) and, beside the recurrent ones,
`examples/long_context_window.py` (a sliding-window GPT with recompute
on lag-7 streams, at seq 256 and window 32 here).

Each twin builds the example's model and data in the port at the
example's own sizes and arguments. The same model is built in the JAX
package (the example's code with the package as a parameter), its
weights are loaded into the port's, and both take the example's first 3
steps on the same batches: the losses within 1e-4 relative (Adam's first
steps move a weight by about lr whatever the size of its gradient, so a
near-zero gradient's rounding moves the JAX and port weights apart by up
to ~lr). `machine_translation`'s JAX side runs without `to_static`,
which is the same arithmetic. The port twin then trains on to the
example's default step count and meets the JAX example's bar in
`tests/test_examples.py`: token accuracy > 0.8; loss < 0.2 x first with
tag accuracy > 0.9; beam token accuracy > 0.7; loss < 0.6 x uniform
nats.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_seq_examples", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_jax_weights(jm, tm):
    assert tm.set_state_dict({k: v.numpy() for k, v in
                              jm.state_dict().items()}) == ([], [])


def first_losses_held(jax_losses, port_losses):
    np.testing.assert_allclose(port_losses[:len(jax_losses)], jax_losses,
                               rtol=LOSS_RTOL)


# ------------------------------------------------------ rnn_encoder_decoder

def seq2seq(P, V, H):
    nn = P.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(V, H)
            self.tgt_emb = nn.Embedding(V, H)
            self.encoder = nn.GRU(H, H)
            self.decoder = nn.GRU(H, H)
            self.out = nn.Linear(H, V)

        def forward(self, src, dec_in):
            _, enc_state = self.encoder(self.src_emb(src))
            dec_seq, _ = self.decoder(self.tgt_emb(dec_in), enc_state)
            return self.out(dec_seq)
    return Seq2Seq()


def test_rnn_encoder_decoder_twin():
    steps, B, L, V, H, BOS = 450, 64, 8, 24, 96, 0

    def batches(n):
        rng = np.random.RandomState(5)

        def batch(b):
            src = rng.randint(2, V, (b, L)).astype("int64")
            tgt = src[:, ::-1].copy()
            dec_in = np.concatenate(
                [np.full((b, 1), BOS, "int64"), tgt[:, :-1]], axis=1)
            return src, dec_in, tgt
        return [batch(B) for _ in range(n)] + [batch(256)]

    def train(P, model, Step, data):
        def loss_fn(logits, tgt):
            return P.nn.functional.cross_entropy(
                logits.reshape([-1, V]), tgt.reshape([-1]))
        step = Step(model, loss_fn, P.optimizer.Adam(
            learning_rate=3e-3, parameters=model.parameters()))
        losses = [float(step((P.to_tensor(s), P.to_tensor(d)),
                             P.to_tensor(t)).numpy()) for s, d, t in data]
        step.sync()
        return losses

    pj.seed(5)
    jm, tm = seq2seq(pj, V, H), seq2seq(pt, V, H)
    load_jax_weights(jm, tm)
    data = batches(steps)
    first_losses_held(train(pj, jm, JTrainStep, data[:3]),
                      losses := train(pt, tm, TrainStep, data[:steps]))
    src, dec_in, tgt = data[-1]
    tm.eval()
    pred = np.argmax(tm(pt.to_tensor(src), pt.to_tensor(dec_in)).numpy(), -1)
    tok_acc = float((pred == tgt).mean())
    assert losses[-1] < 0.3 * losses[0] and tok_acc > 0.8, \
        (losses[0], losses[-1], tok_acc)


# ------------------------------------------------------ label_semantic_roles

def test_label_semantic_roles_twin():
    cs = _chip_smoke()
    steps, B, T, H, E = 160, 64, 32, 64, 32
    train = pt.text.Conll05st(mode="train", vocab_size=512, seq_len=T,
                              num_samples=4096)
    test = pt.text.Conll05st(mode="test", vocab_size=512, seq_len=T,
                             num_samples=512)
    V, N = train.vocab_size, pt.text.Conll05st.NUM_LABELS
    lengths = np.full((B,), T, dtype="int64")

    def step_fn(P, model, Step):
        def loss_fn(emission, labels):
            nll = P.ops.legacy.linear_chain_crf(
                emission, model.transition, labels,
                P.to_tensor(lengths[:emission.shape[0]]))
            return P.mean(nll)
        return Step(model, loss_fn, P.optimizer.Adam(
            learning_rate=2e-3, parameters=model.parameters()))

    np.random.seed(11)
    loader = pt.io.DataLoader(train, batch_size=B, shuffle=True,
                              drop_last=True)
    batches = []
    while len(batches) < steps:
        batches += [tuple(t.numpy() for t in b) for b in loader]
    pj.seed(11)
    jm = cs.srl_tagger(pj, V, N, E, H, T)
    tm = cs.srl_tagger(pt, V, N, E, H, T)
    load_jax_weights(jm, tm)
    res = {}
    for P, m, Step, n in ((pj, jm, JTrainStep, 3), (pt, tm, TrainStep,
                                                     steps)):
        step = step_fn(P, m, Step)
        res[P] = [float(step((P.to_tensor(w), P.to_tensor(p)),
                             P.to_tensor(lab)).numpy())
                  for w, p, lab in batches[:n]]
        step.sync()
    first_losses_held(res[pj], losses := res[pt])
    correct = total = 0
    for words, pred, labels in pt.io.DataLoader(test, batch_size=B,
                                                drop_last=True):
        emission = tm(words, pred)
        path = pt.ops.legacy.crf_decoding(emission, tm.transition,
                                          pt.to_tensor(lengths))
        correct += int((path.numpy() == labels.numpy()).sum())
        total += path.numpy().size
    tag_acc = correct / total
    assert losses[-1] < 0.2 * losses[0] and tag_acc > 0.9, \
        (losses[0], losses[-1], tag_acc)


# ------------------------------------------------------ machine_translation

def translator(P, V_SRC, V_TRG, H, T):
    nn = P.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(V_SRC, H)
            self.trg_emb = nn.Embedding(V_TRG, H)
            self.encoder = nn.GRU(H, H)
            self.dec_cell = nn.GRUCell(2 * H, H)
            self.attn_q = nn.Linear(H, H)
            self.out = nn.Linear(2 * H, V_TRG)

        def attend(self, h, enc):
            q = self.attn_q(h)
            scores = P.matmul(enc, q.unsqueeze(-1)).squeeze(-1)
            w = P.nn.functional.softmax(scores, axis=-1)
            return P.matmul(w.unsqueeze(1), enc).squeeze(1)

        def forward(self, src, trg_in):
            enc, h = self.encoder(self.src_emb(src))
            h = h.squeeze(0)
            emb = self.trg_emb(trg_in)
            outs = []
            for t in range(T):
                ctx = self.attend(h, enc)
                x = P.concat([emb[:, t], ctx], axis=-1)
                h, _ = self.dec_cell(x, h)
                outs.append(self.out(P.concat([h, ctx], axis=-1)))
            return P.stack(outs, axis=1)
    return Seq2Seq()


def test_machine_translation_twin():
    steps, B, H, K, T = 120, 64, 96, 4, 8
    train = pt.text.WMT16(mode="train", src_dict_size=64, trg_dict_size=64,
                          seq_len=T, num_samples=4096)
    V_SRC, V_TRG = train.src_vocab, train.trg_vocab
    np.random.seed(7)
    loader = pt.io.DataLoader(train, batch_size=B, shuffle=True,
                              drop_last=True)
    batches = []
    while len(batches) < steps:
        batches += [tuple(t.numpy() for t in b) for b in loader]
    pj.seed(7)
    jm = translator(pj, V_SRC, V_TRG, H, T)
    tm = translator(pt, V_SRC, V_TRG, H, T)
    load_jax_weights(jm, tm)
    res = {}
    for P, m, n in ((pj, jm, 3), (pt, tm, steps)):
        opt = P.optimizer.Adam(learning_rate=2e-3,
                               parameters=m.parameters())
        ce = P.nn.CrossEntropyLoss()
        losses = []
        for src, trg_in, trg in batches[:n]:
            logits = m(P.to_tensor(src), P.to_tensor(trg_in))
            loss = ce(logits.reshape([-1, V_TRG]),
                      P.to_tensor(trg).reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        res[P] = losses
    first_losses_held(res[pj], losses := res[pt])
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    test = pt.text.WMT16(mode="test", src_dict_size=64, trg_dict_size=64,
                         seq_len=T, num_samples=256)
    src = pt.to_tensor(np.stack([test[i][0] for i in range(128)]))
    want = np.stack([test[i][2] for i in range(128)])
    with pt.no_grad():
        enc, h0 = tm.encoder(tm.src_emb(src))
        h0 = h0.squeeze(0)
        # greedy: the argmax token fed back
        h, tok, greedy = h0, pt.full([128], 1, dtype="int64"), []
        for _ in range(T):
            ctx = tm.attend(h, enc)
            h, _ = tm.dec_cell(pt.concat([tm.trg_emb(tok), ctx], axis=-1), h)
            tok = pt.argmax(tm.out(pt.concat([h, ctx], axis=-1)), axis=-1)
            greedy.append(tok.numpy())
        greedy_acc = float((np.stack(greedy, 1) == want).mean())
        enc_beam = pt.nn.BeamSearchDecoder.tile_beam_merge_with_batch(enc, K)

        def cell(tok_emb, states):
            ctx = tm.attend(states, enc_beam)
            h, _ = tm.dec_cell(pt.concat([tok_emb, ctx], axis=-1), states)
            return tm.out(pt.concat([h, ctx], axis=-1)), h
        decoder = pt.nn.BeamSearchDecoder(cell, start_token=1, end_token=0,
                                          beam_size=K,
                                          embedding_fn=tm.trg_emb)
        ids, _ = pt.nn.dynamic_decode(decoder, inits=h0, max_step_num=T)
    beam_acc = float((np.asarray(ids.numpy())[:, :, 0] == want).mean())
    assert beam_acc > 0.7 and greedy_acc > 0.7, (beam_acc, greedy_acc)


# ------------------------------------------------------ word2vec

def ngram(P, V, E):
    nn = P.nn

    class NGram(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, E)
            self.fc = nn.Linear(4 * E, 128)
            self.out = nn.Linear(128, V)

        def forward(self, ctx):
            e = self.emb(ctx).reshape([ctx.shape[0], 4 * E])
            return self.out(P.nn.functional.sigmoid(self.fc(e)))
    return NGram()


def test_word2vec_twin():
    steps, B, E, V = 300, 128, 32, 128
    train = pt.text.Imikolov(data_type="NGRAM", window_size=5, mode="train",
                             vocab_size=V, num_samples=20000)
    np.random.seed(11)
    loader = pt.io.DataLoader(train, batch_size=B, shuffle=True,
                              drop_last=True)
    batches = []
    while len(batches) < steps:
        for *ctx_cols, label in loader:
            batches.append((np.stack([c.numpy() for c in ctx_cols], 1),
                            label.numpy()))
    pj.seed(11)
    jm, tm = ngram(pj, V, E), ngram(pt, V, E)
    load_jax_weights(jm, tm)
    res = {}
    for P, m, n in ((pj, jm, 3), (pt, tm, steps)):
        opt = P.optimizer.Adam(learning_rate=0.01,
                               parameters=m.parameters())
        ce = P.nn.CrossEntropyLoss()
        losses = []
        for ctx, label in batches[:n]:
            loss = ce(m(P.to_tensor(ctx)), P.to_tensor(label).reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        res[P] = losses
    first_losses_held(res[pj], losses := res[pt])
    assert losses[-1] < 0.6 * math.log(V), (losses[-1], math.log(V))


# ------------------------------------------------------ long_context_window

def long_context_batches(n, batch, seq, lag, V):
    """examples/long_context_window.py's stream: ids[t] = ids[t - lag]."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        head = rng.randint(0, V, (batch, lag))
        out.append(np.tile(head, (1, seq // lag + 1))[:, :seq]
                   .astype("int32"))
    return out


def test_long_context_window_twin():
    """The sliding-window GPT with recompute at a CPU smoke size (seq 256,
    window 32, 100 steps; the example's widths, batch and lr otherwise):
    the JAX model's weights, the first 3 AdamW TrainStep losses against
    the JAX example's, then the loss falls below 0.1 x the first, the
    JAX example's bar (tests/test_examples.py:106-112)."""
    from paddle_tpu.nlp import gpt as jgpt
    from paddle_tpu_torch.nlp import gpt as tgpt
    steps, B, S, W, LAG, V = 100, 8, 256, 32, 7, 64
    cfg = dict(vocab_size=V, hidden_size=128, num_layers=2, num_heads=2,
               max_seq_len=S, dropout=0.0, attn_dropout=0.0, attn_window=W,
               use_recompute=True)
    batches = long_context_batches(steps, B, S, LAG, V)
    pj.seed(5)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**cfg))
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy() for k, v in
                             jm.state_dict().items()})
    jstep = JTrainStep(jm, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=3e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, tgpt.gpt_pretrain_loss, pt.optimizer.AdamW(
        3e-3, parameters=tm.parameters()))
    jl = [float(jstep(ids, ids).numpy()) for ids in batches[:3]]
    losses = []
    for ids in batches:
        t = torch.from_numpy(ids).long()
        losses.append(float(tstep(t, t)))
    first_losses_held(jl, losses)
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
