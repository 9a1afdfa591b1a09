"""paddle_tpu_torch.nn.paged_attention against the JAX package's paged
attention — the reference (gather-then-attend), `_lax_core` and the
Pallas kernel (interpret mode on the CPU, as tests/test_paged_attention.py
runs it).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol/rtol 1e-5 in f32 (the two sides sum in different orders;
the values are O(1)).

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against `plain_core` there. Here the port's `plain` and `reference`
paths carry the contract, and the `cuda` wrapper must refuse CPU
tensors rather than fall back.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import paged_attention as jpa
from paddle_tpu_torch.nn import paged_attention as tpa

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

PORT = ("plain", "reference")
JAX = ("reference", "lax", "pallas")
ATOL = RTOL = 1e-5
SCALE = 0.35


def _case(seed, b=3, h=4, hkv=2, c=4, d=8, nblk=5, nb=11, bs=4,
          poison_scratch=False):
    """numpy q [B,H,C,D], pools [NB,Hkv,BS,D], tables into REAL blocks."""
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    pv = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    if poison_scratch:
        pk[0] = np.nan
        pv[0] = np.nan
    tables = rng.integers(1, nb, (b, nblk)).astype(np.int32)
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    return q, pk, pv, tables


def _jax(form, kernel, q, pk, pv, tables, pos, window=None):
    fn = (jpa.paged_decode_attention if form == "decode"
          else jpa.paged_chunk_attention)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(tables), jnp.asarray(pos), SCALE,
                         window=window, kernel=kernel))


def _port(form, kernel, q, pk, pv, tables, pos, window=None):
    fn = (tpa.paged_decode_attention if form == "decode"
          else tpa.paged_chunk_attention)
    return fn(torch.from_numpy(q), torch.from_numpy(pk),
              torch.from_numpy(pv), torch.from_numpy(tables),
              torch.as_tensor(pos), SCALE, window=window,
              kernel=kernel).numpy()


_FORMS = {"decode": dict(seed=0, c=1, pos=np.array([3, 9, 17], np.int32)),
          "chunk": dict(seed=1, c=4, pos=np.array([0, 5, 12], np.int32))}


@functools.lru_cache(maxsize=None)
def _jax_outputs(form, window):
    """JAX outputs for every JAX kernel, computed once per case."""
    spec = _FORMS[form]
    q, pk, pv, tables = _case(spec["seed"], c=spec["c"])
    return {k: _jax(form, k, q, pk, pv, tables, spec["pos"], window)
            for k in JAX}


@pytest.mark.parametrize("kernel", PORT)
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_parity_vs_jax_kernels(form, window, kernel):
    spec = _FORMS[form]
    q, pk, pv, tables = _case(spec["seed"], c=spec["c"])
    out = _port(form, kernel, q, pk, pv, tables, spec["pos"], window)
    for jk, ref in _jax_outputs(form, window).items():
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"port {kernel} vs jax {jk}")


@pytest.mark.parametrize("kernel", PORT)
def test_scalar_position_matches_vector(kernel):
    """A scalar start is the broadcast of the per-lane vector form."""
    q, pk, pv, tables = _case(2)
    vec = _port("chunk", kernel, q, pk, pv, tables,
                np.array([7, 7, 7], np.int32))
    sca = _port("chunk", kernel, q, pk, pv, tables, np.int32(7))
    np.testing.assert_array_equal(vec, sca)


@pytest.mark.parametrize("kernel", PORT)
def test_poisoned_scratch_block_cannot_leak(kernel):
    """NaN in the scratch block (read only at masked positions) reaches
    no output, and the outputs still agree with JAX's."""
    q, pk, pv, tables = _case(3, c=1, poison_scratch=True)
    pos = np.array([3, 9, 17], np.int32)
    for window in (None, 6):
        out = _port("decode", kernel, q, pk, pv, tables, pos, window)
        assert np.isfinite(out).all(), (kernel, window)
        np.testing.assert_allclose(
            out, _jax("decode", "lax", q, pk, pv, tables, pos, window),
            rtol=RTOL, atol=ATOL)
    q, pk, pv, tables = _case(4, poison_scratch=True)
    # the engine's table rows past a lane's frontier map scratch
    tables[0, 1:] = 0
    start = np.array([0, 5, 12], np.int32)
    out = _port("chunk", kernel, q, pk, pv, tables, start)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(
        out, _jax("chunk", "pallas", q, pk, pv, tables, start),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", PORT)
def test_attended_nonfinite_still_propagates(kernel):
    """A non-finite value at an ATTENDED position (lane 1 maps scratch at
    its first block) reaches that lane's output, and only that lane's —
    the same pattern the JAX kernels give."""
    q, pk, pv, tables = _case(5, c=1, poison_scratch=True)
    tables[1, 0] = 0
    pos = np.array([3, 9, 17], np.int32)
    out = _port("decode", kernel, q, pk, pv, tables, pos)
    assert not np.isfinite(out[1]).all()
    assert np.isfinite(out[0]).all() and np.isfinite(out[2]).all()
    ref = _jax("decode", "lax", q, pk, pv, tables, pos)
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))


@pytest.mark.parametrize("kernel", PORT)
def test_fully_masked_rows_are_exactly_zero(kernel):
    """Rows attending nothing (pos < 0) renormalise to exactly 0 even
    over a poisoned scratch pool."""
    q, pk, pv, tables = _case(6, c=1, poison_scratch=True)
    out = _port("decode", kernel, q, pk, pv, tables,
                np.array([-1, -1, -1], np.int32))
    assert (out == 0).all()


def test_bf16_pools_return_pool_dtype():
    """bf16 pools: the result comes back in the pool dtype and agrees with
    the f32 computation to bf16 precision (one ulp at unit scale)."""
    q, pk, pv, tables = _case(7, c=1)
    pos = torch.tensor([3, 9, 17])
    bk = torch.from_numpy(pk).bfloat16()
    bv = torch.from_numpy(pv).bfloat16()
    out = tpa.paged_decode_attention(torch.from_numpy(q), bk, bv,
                                     torch.from_numpy(tables), pos, SCALE,
                                     kernel="plain")
    assert out.dtype == torch.bfloat16
    ref = tpa.paged_decode_attention(torch.from_numpy(q), bk.float(),
                                     bv.float(), torch.from_numpy(tables),
                                     pos, SCALE, kernel="plain")
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


def test_cuda_kernel_refuses_cpu_tensors():
    """The cuda route launches the kernel or raises — it never falls back
    to the plain version for a CPU tensor."""
    q, pk, pv, tables = _case(8, c=1)
    before = dict(tpa.launches)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        _port("decode", "cuda", q, pk, pv, tables,
              np.array([3, 9, 17], np.int32))
    assert tpa.launches == before


def test_kernel_resolution_order(monkeypatch):
    monkeypatch.delenv("PT_PAGED_KERNEL", raising=False)
    assert tpa.resolve_kernel("plain") == "plain"
    # auto resolves by device: plain on the CPU, cuda on a card
    assert tpa.resolve_kernel() == "plain"
    assert tpa.resolve_kernel("auto", torch.device("cpu")) == "plain"
    assert tpa.resolve_kernel("auto", torch.device("cuda", 0)) == "cuda"
    monkeypatch.setenv("PT_PAGED_KERNEL", "reference")
    assert tpa.resolve_kernel() == "reference"
    # scope beats env; inner scope beats outer; explicit beats scope
    with tpa.kernel_scope("cuda"):
        assert tpa.resolve_kernel() == "cuda"
        with tpa.kernel_scope("plain"):
            assert tpa.resolve_kernel() == "plain"
            assert tpa.resolve_kernel("reference") == "reference"
        assert tpa.resolve_kernel() == "cuda"
    assert tpa.resolve_kernel() == "reference"
    monkeypatch.delenv("PT_PAGED_KERNEL")
    tpa.set_paged_kernel("reference")
    try:
        assert tpa.resolve_kernel() == "reference"
    finally:
        tpa.set_paged_kernel("auto")


def test_unknown_kernel_rejected(monkeypatch):
    with pytest.raises(ValueError, match="unknown paged kernel"):
        tpa.resolve_kernel("pallas")
    with pytest.raises(ValueError, match="unknown paged kernel"):
        tpa.set_paged_kernel("nope")
    monkeypatch.setenv("PT_PAGED_KERNEL", "bogus")
    with pytest.raises(ValueError, match="unknown paged kernel"):
        tpa.resolve_kernel()


# ---------------------------------------------------------------------------
# the split plain version (the CUDA kernel's split-K and combine rule)
# ---------------------------------------------------------------------------

SPLITS = (1, 2, 5)          # one pool block, two, and the whole table


def _split(q, pk, pv, tables, start, split, window=None):
    return tpa.plain_core(torch.from_numpy(q), torch.from_numpy(pk),
                          torch.from_numpy(pv), torch.from_numpy(tables),
                          start, SCALE, window, split_blocks=split).numpy()


def _all_jax(form, q, pk, pv, tables, pos, window=None):
    return {k: _jax(form, k, q, pk, pv, tables, pos, window) for k in JAX}


def _assert_matches(out, refs):
    """Within 1e-5 of every JAX path, with non-finite entries at the same
    places (assert_allclose treats NaN == NaN)."""
    for jk, ref in refs.items():
        np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref),
                                      err_msg=f"finite pattern vs jax {jk}")
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"split plain vs jax {jk}")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_split_plain_matches_jax(form, window, split):
    spec = _FORMS[form]
    q, pk, pv, tables = _case(spec["seed"], c=spec["c"])
    out = _split(q, pk, pv, tables, torch.as_tensor(spec["pos"]), split,
                 window)
    _assert_matches(out, _jax_outputs(form, window))


@functools.lru_cache(maxsize=None)
def _nan_split_case():
    """Lane 2 (pos 17, 4-key blocks) maps a NaN block at table entry 3
    (keys 12-15): split 1 of 2-block splits, split 3 of 1-block ones; no
    other lane maps it."""
    q, pk, pv, tables = _case(9, c=1)
    pk = np.concatenate([pk, np.full_like(pk[:1], np.nan)])
    pv = np.concatenate([pv, np.ones_like(pv[:1])])
    tables[2, 3] = pk.shape[0] - 1
    pos = np.array([3, 9, 17], np.int32)
    return (q, pk, pv, tables, pos), _all_jax("decode", q, pk, pv, tables,
                                              pos)


@pytest.mark.parametrize("split", SPLITS)
def test_split_nan_in_one_split_stays_in_its_lane(split):
    (q, pk, pv, tables, pos), refs = _nan_split_case()
    out = _split(q, pk, pv, tables, torch.as_tensor(pos), split)
    assert not np.isfinite(out[2]).any()
    assert np.isfinite(out[:2]).all()
    _assert_matches(out, refs)


@functools.lru_cache(maxsize=None)
def _window_case():
    """Window 3 at pos 17 keeps keys 15-17 (blocks 3 and 4): every split
    before them is empty, over a poisoned scratch block."""
    q, pk, pv, tables = _case(10, c=1, poison_scratch=True)
    pos = np.array([3, 9, 17], np.int32)
    return (q, pk, pv, tables, pos), _all_jax("decode", q, pk, pv, tables,
                                              pos, window=3)


@pytest.mark.parametrize("split", SPLITS)
def test_split_window_empties_leading_splits(split):
    (q, pk, pv, tables, pos), refs = _window_case()
    out = _split(q, pk, pv, tables, torch.as_tensor(pos), split, window=3)
    assert np.isfinite(out).all()
    _assert_matches(out, refs)


@functools.lru_cache(maxsize=None)
def _empty_lane_case():
    q, pk, pv, tables = _case(11, c=1, poison_scratch=True)
    pos = np.array([-1, 9, 17], np.int32)
    return (q, pk, pv, tables, pos), _all_jax("decode", q, pk, pv, tables,
                                              pos)


@pytest.mark.parametrize("split", SPLITS)
def test_split_lane_with_no_attended_key_is_exactly_zero(split):
    (q, pk, pv, tables, pos), refs = _empty_lane_case()
    out = _split(q, pk, pv, tables, torch.as_tensor(pos), split)
    assert (out[0] == 0).all()
    _assert_matches(out, refs)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_split_gqa_rep2_matches_jax(form, split):
    q, pk, pv, tables = _case(12, h=6, hkv=3, c=1 if form == "decode" else 3)
    pos = np.array([5, 11, 18], np.int32)
    out = _split(q, pk, pv, tables, torch.as_tensor(pos), split)
    _assert_matches(out, _all_jax(form, q, pk, pv, tables, pos))


@functools.lru_cache(maxsize=None)
def _start_case():
    q, pk, pv, tables = _case(13, c=3)
    return (q, pk, pv, tables), _all_jax("chunk", q, pk, pv, tables,
                                         np.int32(6))


@pytest.mark.parametrize("start", ["int", "int32", "int64"])
def test_split_start_as_int_or_tensor(start):
    """start as a Python int, an int32 tensor and an int64 tensor of one
    value per lane give JAX's result for the same positions."""
    (q, pk, pv, tables), refs = _start_case()
    arg = {"int": 6,
           "int32": torch.full((3,), 6, dtype=torch.int32),
           "int64": torch.full((3,), 6, dtype=torch.int64)}[start]
    _assert_matches(_split(q, pk, pv, tables, arg, 2), refs)


def test_merge_states_rules():
    """The combine rule on hand-made states: a NaN max or accumulator
    survives, the shift is 0 while the max is -inf, and l == 0 gives 0."""
    inf, nan = float("inf"), float("nan")
    m = [torch.tensor([1.0, -inf, nan, -inf]),
         torch.tensor([-inf, -inf, 0.5, 2.0])]
    l = [torch.tensor([2.0, 0.0, 1.0, 0.0]),
         torch.tensor([0.0, 0.0, 1.0, 4.0])]
    acc = [torch.tensor([[4.0], [0.0], [1.0], [0.0]]),
           torch.tensor([[0.0], [0.0], [1.0], [8.0]])]
    out = tpa.merge_states(m, l, acc)[:, 0]
    assert out[0].item() == 2.0          # one state, the other empty
    assert out[1].item() == 0.0          # every state empty: exactly 0
    assert np.isnan(out[2].item())       # a NaN max propagates
    assert out[3].item() == 2.0          # an empty state before a live one
