"""paddle_tpu_torch.nlp.gpt against paddle_tpu.nlp.gpt with the same
weights (carried across by `load_jax_state`).

Small model (the CPU smoke size of bench.py: vocab 512, hidden 128, 2
layers, 4 heads, max_seq_len 128, dropout 0) with initializer_range 0.2
so the logits are O(1..10) and distinguish tokens. Inputs are numpy
arrays from a seed handed to both packages. Tolerance: atol 1e-4 on the
logits and the written pools (f32; both sides sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nn import paged_attention as jpa
from paddle_tpu_torch.nlp import gpt as tgpt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ATOL = 1e-4
SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)
NB, BS, MAX_LEN = 13, 8, 48


def _pair(**over):
    cfg = dict(SMALL, **over)
    pt.seed(3)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _pools_close(jc, tc):
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_load_jax_state_round_trip(pair):
    """Every key lands, with its shape, as it is: the port's Linear
    weights are [in, out] like the JAX package's, so nothing is
    transposed in either direction (the JAX state is the port's, and
    the port's `state_dict()` loads back into a JAX model unchanged)."""
    jm, tm = pair
    jsd = {k: v.numpy() for k, v in jm.state_dict().items()}
    tsd = tm.state_dict()
    assert list(jsd) == list(tsd) and len(tsd) == 28
    qkv = "gpt.blocks.0.attn.qkv_proj.weight"
    assert tuple(tsd[qkv].shape) == (128, 3 * 128)
    for k, arr in jsd.items():
        got = tsd[k].numpy()
        assert got.shape == arr.shape, k
        np.testing.assert_array_equal(got, arr, err_msg=k)
    back = JGPT(JConfig(**SMALL))
    missing, unexpected = back.set_state_dict(
        {k: v.numpy() for k, v in tsd.items()})
    assert not missing and not unexpected
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)


def test_load_jax_state_rejects_mismatches(pair):
    jm, _ = pair
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    missing = dict(state)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="missing"):
        tgpt.load_jax_state(tm, missing)
    extra = dict(state, **{"gpt.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        tgpt.load_jax_state(tm, extra)
    bad = dict(state)
    bad["gpt.blocks.0.attn.qkv_proj.weight"] = np.zeros((128, 128),
                                                        np.float32)
    with pytest.raises(ValueError, match="shape"):
        tgpt.load_jax_state(tm, bad)


def _jax_prefill(jm, caches, tokens, table, start, valid, frontier=None):
    with jpa.kernel_scope("lax"):
        return jm.prefill_chunk(Tensor(jnp.asarray(tokens)), caches,
                                jnp.asarray(table), jnp.int32(start),
                                jnp.int32(valid), frontier=frontier)


def _port_prefill(tm, caches, tokens, table, start, valid, frontier=None):
    return tm.prefill_chunk(torch.from_numpy(tokens).long(), caches,
                            torch.from_numpy(table), start, valid,
                            frontier=frontier)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_chunk_and_decode_step_match_jax(window):
    """Two prefill chunks (the second partial, with a frontier) then a
    decode wave over three lanes — one of them outside the wave on a
    scratch table row at pos == max_len — give the JAX model's logits
    and pools."""
    jm, tm = _pair(attn_window=window)
    rng = np.random.default_rng(11)
    jc = jm.init_paged_cache(NB, BS, MAX_LEN)
    tc = tm.init_paged_cache(NB, BS, MAX_LEN)
    table = np.array([[1, 2, 3, 0, 0, 0]], np.int32)
    toks = rng.integers(0, 512, (1, 16)).astype(np.int32)
    jl, jc = _jax_prefill(jm, jc, toks, table, 0, 16)
    tl, tc = _port_prefill(tm, tc, toks, table, 0, 16)
    assert tl.shape == (1, 16, 512)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)
    toks2 = rng.integers(0, 512, (1, 16)).astype(np.int32)
    jl, jc = _jax_prefill(jm, jc, toks2, table, 16, 5, frontier=4)
    tl, tc = _port_prefill(tm, tc, toks2, table, 16, 5, frontier=4)
    assert tl.shape == (1, 1, 512)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)
    _pools_close(jc, tc)

    tables = np.array([[1, 2, 3, 0, 0, 0],
                       [4, 5, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    tok = rng.integers(0, 512, (3, 1)).astype(np.int32)
    pos = np.array([21, 9, MAX_LEN], np.int32)
    with jpa.kernel_scope("lax"):
        jl, jc = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                                jnp.asarray(pos),
                                block_tables=jnp.asarray(tables))
    tl, tc = tm.decode_step(torch.from_numpy(tok).long(), tc,
                            torch.from_numpy(pos).long(),
                            block_tables=torch.from_numpy(tables))
    # lanes in the wave agree; the parked lane only wrote scratch
    np.testing.assert_allclose(tl.numpy()[:2], _np(jl)[:2], atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:],
                                   atol=ATOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:],
                                   atol=ATOL)


@pytest.mark.parametrize("kernel", ["plain", "reference"])
def test_decode_kernels_agree(pair, kernel):
    """The model's decode wave gives the same logits through the port's
    two CPU kernels and through JAX's Pallas kernel (interpret mode)."""
    jm, tm = pair
    rng = np.random.default_rng(12)
    jc = jm.init_paged_cache(NB, BS, MAX_LEN)
    tc = tm.init_paged_cache(NB, BS, MAX_LEN)
    tables = np.array([[3, 7, 0, 0, 0, 0], [5, 0, 0, 0, 0, 0]], np.int32)
    tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
    pos = np.array([12, 0], np.int32)
    with jpa.kernel_scope("pallas"):
        jl, _ = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                               jnp.asarray(pos),
                               block_tables=jnp.asarray(tables))
    from paddle_tpu_torch.nn import paged_attention as tpa
    with tpa.kernel_scope(kernel):
        tl, _ = tm.decode_step(torch.from_numpy(tok).long(), tc,
                               torch.from_numpy(pos).long(),
                               block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)


def test_unported_entry_points_name_the_roadmap(pair):
    _, tm = pair
    ids = torch.zeros((1, 4), dtype=torch.long)
    # the training forward, the dense serving methods and the
    # speculative verify are ported (tests/test_torch_train.py,
    # tests/test_torch_dense_serving.py, tests/test_torch_spec.py)
    assert tm(ids).shape == (1, 4, SMALL["vocab_size"])
    logits, caches = tm.prefill(ids, 8)
    assert logits.shape == (1, 4, SMALL["vocab_size"])
    assert tm.decode_step(ids[:, :1], caches, 4)[0].shape == \
        (1, 1, SMALL["vocab_size"])
    pools = tm.init_paged_cache(NB, BS, MAX_LEN)
    tables = torch.tensor([[1, 2, 0, 0, 0, 0]], dtype=torch.int32)
    logits, _ = tm.decode_chunk(ids, pools, tables, torch.tensor([3]),
                                torch.tensor([4]))
    assert logits.shape == (1, 4, SMALL["vocab_size"])
    assert bool(torch.isfinite(logits).all())
    # MoE blocks are ported (tests/test_torch_moe.py); so is sequence
    # parallelism (tests/test_torch_sequence_parallel.py), with the JAX
    # package's refusals: a window, and an unknown mode
    moe = tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(SMALL, moe_experts=4)),
                                 device="cpu")
    assert moe(ids).shape == (1, 4, SMALL["vocab_size"])
    assert tgpt.GPTConfig(sequence_parallel=True).sequence_parallel is True
    with pytest.raises(ValueError, match="attn_window with sequence_para"):
        tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(
            SMALL, sequence_parallel="ring", attn_window=2)), device="cpu")
    with pytest.raises(ValueError, match="unknown sequence_parallel"):
        tgpt.GPTForPretraining(tgpt.GPTConfig(**dict(
            SMALL, sequence_parallel="zigzag")), device="cpu")


def test_paged_cache_horizon_is_checked(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.init_paged_cache(NB, BS, SMALL["max_seq_len"] + BS)
