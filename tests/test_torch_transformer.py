"""The port's `nn.transformer` layers against the JAX package's on the
CPU, from the same state-dict numpy weights, at 2 + 2 layers, d_model
128 and 2 heads of 64, sequences of 128 and 256: the attention without a
mask takes the flash kernels' route in both packages (the port's plain
K1-K3 blocks, JAX's Pallas kernels in interpret mode), a mask the dense
route.

`MultiHeadAttention` on the BSHD kernel route (self and cross, sq < sk),
on the mask route, with `need_weights`, with `Cache` and `StaticCache`;
the encoder and decoder layers with `normalize_before` both ways; the
whole `Transformer`, forward and every gradient; incremental decoding
through `gen_cache` against the full decoder; `_clone_layer`'s fresh
weights under the JAX package's keys.

Tolerances (f32, the packages sum in different orders): outputs within
1e-4 x max(1, |ref|) elementwise, gradients within 1e-4 x max(1,
max|g|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

RTOL = 1e-4
D, H, FF = 128, 2, 256


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def rnd(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("f4")


def close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= rtol * np.maximum(1.0, np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


def gclose(got, want, what):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max err {err} > {RTOL} x {scale}"


def twins(make, seed=0):
    """The JAX layer `make(pj)` and the port's `make(pt)` loaded from its
    state dict."""
    pj.seed(seed)
    jm = make(pj)
    tm = make(pt)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert list(tm.state_dict()) == list(state)
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def run_both(jm, tm, call, inputs, diff=()):
    """`call(P, model, *Tensors)` on both packages: the outputs, and the
    gradients of sum(out_i * w_i) over every parameter and the inputs in
    `diff`. Returns {package: (outs, {name: grad})}."""
    res = {}
    for P, m in ((pj, jm), (pt, tm)):
        ts = [P.to_tensor(a, stop_gradient=i not in diff)
              for i, a in enumerate(inputs)]
        out = call(P, m, *ts)
        outs = out if isinstance(out, tuple) else (out,)
        loss = None
        for i, o in enumerate(outs):
            w = P.to_tensor(rnd(o.shape, 100 + i))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {k: p.grad.numpy().copy() for k, p in m.named_parameters()
                 if p.grad is not None}
        grads.update({f"input{i}": ts[i].grad.numpy().copy() for i in diff})
        res[P] = ([o.numpy().copy() for o in outs], grads)
    return res


def check_both(res, what):
    (jo, jg), (to, tg) = res[pj], res[pt]
    assert len(jo) == len(to)
    for i, (a, b) in enumerate(zip(to, jo)):
        close(a, b, f"{what} output {i}")
    assert set(tg) == set(jg), (sorted(set(tg) ^ set(jg)))
    for k in jg:
        gclose(tg[k], jg[k], f"{what} grad {k}")


def test_multihead_attention_kernel_route_self_and_cross():
    jm, tm = twins(lambda P: P.nn.MultiHeadAttention(D, H), 1)
    q, kv = rnd((2, 128, D), 2), rnd((2, 256, D), 3)
    from paddle_tpu_torch.ops import flash_attention as fa
    before = dict(fa.routes)
    res = run_both(jm, tm, lambda P, m, a, b: (m(a), m(a, b, b)), [q, kv],
                   diff=(0, 1))
    assert fa.routes["kernel"] - before["kernel"] == 2
    assert fa.routes["dense"] == before["dense"]
    check_both(res, "mha bshd")


def test_multihead_attention_mask_weights_and_caches():
    jm, tm = twins(lambda P: P.nn.MultiHeadAttention(D, H,
                                                     need_weights=True), 4)
    q, kv = rnd((2, 128, D), 5), rnd((2, 256, D), 6)
    mask = np.triu(np.full((128, 128), -np.inf, "f4"), 1)
    res = run_both(jm, tm, lambda P, m, a, b, msk: m(a, b, b, msk),
                   [q, q, mask], diff=(0,))
    check_both(res, "mha mask + weights")

    def cached(P, m, a, b):
        cls = type(m)
        static = m.gen_cache(b, b, cls.StaticCache)
        o1, w1 = m(a, b, b, None, static)
        inc = m.gen_cache(a)
        o2, w2, inc = m(a[:, :3], None, None, None, inc)
        o3, w3, inc = m(a[:, 3:4], None, None, None, inc)
        return o1, w1, o2, w2, o3, w3, inc.k, inc.v
    res = run_both(jm, tm, cached, [q, kv], diff=(0, 1))
    check_both(res, "mha caches")
    assert res[pt][0][6].shape == (2, H, 4, D // H)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_and_decoder_layers(normalize_before):
    def enc(P):
        return P.nn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                            normalize_before=normalize_before)

    def dec(P):
        return P.nn.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                            activation="gelu",
                                            normalize_before=normalize_before)
    src, mem = rnd((2, 128, D), 7), rnd((2, 256, D), 8)
    jm, tm = twins(enc, 9)
    check_both(run_both(jm, tm, lambda P, m, a: m(a), [src], diff=(0,)),
               f"encoder layer nb={normalize_before}")
    jm, tm = twins(dec, 10)
    mask = np.triu(np.full((128, 128), -np.inf, "f4"), 1)
    check_both(run_both(jm, tm, lambda P, m, a, b, msk: m(a, b, msk),
                        [src, mem, mask], diff=(0, 1)),
               f"decoder layer nb={normalize_before}")


def _transformer(P, normalize_before=False):
    return P.nn.Transformer(D, H, 2, 2, FF, dropout=0.0,
                            normalize_before=normalize_before)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_and_every_gradient(normalize_before):
    jm, tm = twins(lambda P: _transformer(P, normalize_before), 11)
    src, tgt = rnd((2, 256, D), 12), rnd((2, 128, D), 13)

    def call(P, m, s, t):
        return m(s, t, tgt_mask=m.generate_square_subsequent_mask(128))
    res = run_both(jm, tm, call, [src, tgt], diff=(0, 1))
    check_both(res, f"transformer nb={normalize_before}")
    assert len(res[pt][1]) == len(tm.parameters()) + 2


def test_incremental_decoding_matches_the_full_decoder():
    jm, tm = twins(_transformer, 14)
    src, tgt = rnd((2, 128, D), 15), rnd((2, 8, D), 16)
    out = {}
    for P, m in ((pj, jm), (pt, tm)):
        m.eval()
        s, t = P.to_tensor(src), P.to_tensor(tgt)
        memory = m.encoder(s)
        full = m.decoder(t, memory,
                         tgt_mask=m.generate_square_subsequent_mask(8))
        cache = m.decoder.gen_cache(memory)
        steps = []
        for i in range(8):
            o, cache = m.decoder(t[:, i:i + 1], memory, cache=cache)
            steps.append(o.numpy()[:, 0])
        out[P] = (full.numpy(), np.stack(steps, 1))
    close(out[pt][1], out[pt][0], "port incremental vs full")
    close(out[pt][0], out[pj][0], "full decoder vs JAX")
    close(out[pt][1], out[pj][1], "incremental decoder vs JAX")


def test_clone_layer_gives_fresh_weights_under_the_jax_keys():
    from paddle_tpu_torch.nn.transformer import _clone_layer
    pj.seed(17)
    jenc = pj.nn.TransformerEncoder(
        pj.nn.TransformerEncoderLayer(D, H, FF), 3)
    layer = pt.nn.TransformerEncoderLayer(D, H, FF)
    tenc = pt.nn.TransformerEncoder(layer, 3)
    assert list(tenc.state_dict()) == list(jenc.state_dict())
    w = [tenc.layers[i].linear1.weight.numpy().copy() for i in range(3)]
    assert not np.array_equal(w[0], w[1]) and not np.array_equal(w[1], w[2])
    assert tenc.layers[0] is layer
    clone = _clone_layer(layer)
    assert type(clone) is type(layer) and clone._config == layer._config
    assert [tuple(p.shape) for p in clone.parameters()] == \
        [tuple(p.shape) for p in layer.parameters()]
    clone.linear1.weight.set_value(np.zeros((D, FF), "f4"))
    np.testing.assert_array_equal(tenc.layers[0].linear1.weight.numpy(),
                                  w[0])
