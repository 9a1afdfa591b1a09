"""The port's beam search (`nn.decode`) against the JAX package's on the
CPU: `BeamSearchDecoder` + `dynamic_decode` over a small recurrent cell
written once for both packages (an embedding, a tanh cell whose state is
a tuple holding a dict, a vocabulary head), from the same numpy weights:
the ids and lengths equal JAX's, `<eos>` absorbing (a finished beam's
later ids are `<eos>` and its length stops), `tile_beam_merge_with_batch`,
`greedy_search` and `sampling_id`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

V, E, HID = 12, 8, 16
EOS, START = 1, 0


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def weights(seed=0, eos_bias=0.0):
    r = np.random.RandomState(seed)
    w = {"emb": r.randn(V, E), "wx": r.randn(E, HID) * 0.5,
         "wh": r.randn(HID, HID) * 0.3, "wc": r.randn(HID, HID) * 0.3,
         "out": r.randn(HID, V) * 1.5, "bias": np.zeros(V)}
    w["bias"][EOS] = eos_bias
    return {k: v.astype("f4") for k, v in w.items()}


def decoder(P, w, beam):
    t = {k: P.to_tensor(v) for k, v in w.items()}

    def embed(ids):
        return P.gather(t["emb"], ids)

    def cell(x, states):
        h, c = states[0], states[1]["c"]
        h2 = P.tanh(P.matmul(x, t["wx"]) + P.matmul(h, t["wh"]) +
                    P.matmul(c, t["wc"]))
        return h2, (h2, {"c": c * 0.5 + h2 * 0.5})

    def head(out):
        return P.matmul(out, t["out"]) + t["bias"]
    return P.nn.BeamSearchDecoder(cell, START, EOS, beam,
                                  embedding_fn=embed, output_fn=head)


def decode(P, w, beam, batch, steps, seed=1):
    r = np.random.RandomState(seed)
    h0 = r.randn(batch, HID).astype("f4")
    c0 = r.randn(batch, HID).astype("f4")
    ids, lens = P.nn.dynamic_decode(decoder(P, w, beam),
                                    inits=(P.to_tensor(h0),
                                           {"c": P.to_tensor(c0)}),
                                    max_step_num=steps)
    return ids.numpy(), lens.numpy()


@pytest.mark.parametrize("eos_bias", [0.0, 2.5])
def test_beam_ids_and_lengths_equal_jax(eos_bias):
    w = weights(2, eos_bias)
    jids, jlens = decode(pj, w, 4, 3, 10)
    tids, tlens = decode(pt, w, 4, 3, 10)
    assert tids.shape == (3, 10, 4) and tlens.shape == (3, 4)
    assert tids.dtype == jids.dtype == np.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlens, jlens)
    if eos_bias:
        assert (tlens < 10).any()


def test_eos_absorbs_finished_beams():
    ids, lens = decode(pt, weights(3, 2.5), 4, 3, 12)
    finished = 0
    for b in range(3):
        for k in range(4):
            n = int(lens[b, k])
            seq = ids[b, :, k]
            assert (seq[n:] == EOS).all()
            if n < 12:
                # the finishing token counts; nothing after it
                assert seq[n - 1] == EOS and (seq[:n - 1] != EOS).all()
                finished += 1
    assert finished > 0


def test_tile_beam_merge_with_batch_and_helpers():
    x = np.arange(24, dtype="f4").reshape(3, 2, 4)
    j = pj.nn.BeamSearchDecoder.tile_beam_merge_with_batch(pj.to_tensor(x),
                                                            3)
    t = pt.nn.BeamSearchDecoder.tile_beam_merge_with_batch(pt.to_tensor(x),
                                                            3)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.shape == [9, 2, 4]
    logits = np.random.RandomState(4).randn(5, 7).astype("f4")
    np.testing.assert_array_equal(
        pt.nn.greedy_search(pt.to_tensor(logits)).numpy(),
        pj.nn.greedy_search(pj.to_tensor(logits)).numpy())
    probs = np.full((4000, 3), 1e-9, "f4")
    probs[:, 2] = 1.0
    probs[::2, 2], probs[::2, 0] = 0.25, 0.75
    got = pt.nn.sampling_id(pt.to_tensor(probs), seed=5).numpy()
    assert got.dtype == np.int32 and set(np.unique(got)) <= {0, 2}
    assert (got[1::2] == 2).all()
    share = float((got[::2] == 0).mean())
    assert abs(share - 0.75) < 5 * (0.75 * 0.25 / 2000) ** 0.5
    again = pt.nn.sampling_id(pt.to_tensor(probs), seed=5).numpy()
    np.testing.assert_array_equal(got, again)
