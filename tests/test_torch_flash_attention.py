"""paddle_tpu_torch.ops.flash_attention against the JAX package's
`_flash_array` (ops/pallas/flash_attention.py).

Sequence lengths 128/256 make `_kernel_eligible` hold, so the JAX side
runs the real Pallas kernels K1-K3 (interpret mode on the CPU). The
port's `plain` path (the CUDA kernels' arithmetic in torch ops) and its
`reference` path (dense, torch autograd) are held to it, forward and
dq/dk/dv, across both layouts, causal or not, window or not, q_len ==
kv_len and q_len < kv_len, f32 and bf16. Inputs and the upstream
gradient are numpy arrays from a seed handed to both packages.

Tolerances: f32 atol 1e-4 (the sums run in different orders); bf16
atol 0.15 / rtol 0.1, those of tests/test_transformer_flash.py's bf16
backward test (both sides round P and dS to bf16, at places that differ
by one ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_flash_array,
                                                   _sdpa_reference)
from paddle_tpu_torch.ops import flash_attention as fa

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

B, H, D = 1, 2, 64
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=0.15, rtol=0.1)}
MODES = {"full": (False, None), "causal": (True, None),
         "window": (True, 64)}
SHAPES = {"sq=sk": (256, 256), "sq<sk": (128, 256)}


def _shape(layout, s):
    return (B, s, H, D) if layout == "bshd" else (B, H, s, D)


@functools.lru_cache(maxsize=None)
def _case(layout, mode, shape, dtype):
    """Inputs (numpy f32) and the JAX package's out and dq/dk/dv."""
    causal, window = MODES[mode]
    sq, sk = SHAPES[shape]
    rng = np.random.RandomState(sum(map(ord, layout + mode + shape)))
    q = rng.randn(*_shape(layout, sq)).astype("f4")
    k = rng.randn(*_shape(layout, sk)).astype("f4")
    v = rng.randn(*_shape(layout, sk)).astype("f4")
    g = rng.randn(*_shape(layout, sq)).astype("f4")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def fwd(a, b, c):
        return _flash_array(a, b, c, causal=causal, layout=layout,
                            window=window)

    args = tuple(jnp.asarray(x, jdt) for x in (q, k, v))
    out, vjp = jax.vjp(fwd, *args)
    grads = vjp(jnp.asarray(g, jdt))
    if window is not None and sq < sk:
        # the Pallas K2 gives wrong dK/dV for causal + window with
        # q_len < kv_len (ROADMAP Queue 3): hold the port to the dense
        # `_sdpa_reference` under autograd for that case
        def ref(a, b, c):
            t = (lambda x: jnp.swapaxes(x, 1, 2)) if layout == "bshd" \
                else (lambda x: x)
            return t(_sdpa_reference(t(a), t(b), t(c), None, True, None,
                                     window))
        _, vjp_ref = jax.vjp(ref, *args)
        grads = vjp_ref(jnp.asarray(g, jdt))
    as_np = [np.asarray(x, np.float32) for x in (out, *grads)]
    return (q, k, v, g), as_np


@pytest.mark.parametrize("impl", ["plain", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_forward_and_grads_match_jax(layout, mode, shape, dtype, impl):
    (q, k, v, g), want = _case(layout, mode, shape, dtype)
    causal, window = MODES[mode]
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, layout=layout,
                             window=window, kernel=impl)
    assert out.dtype == tdt and out.shape == tq.shape
    out.backward(torch.tensor(g).to(tdt))
    got = [out.detach(), tq.grad, tk.grad, tv.grad]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == tdt, name
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_plain_dkv_on_the_kernel_schedule_matches_jax(layout, mode, shape,
                                                      dtype):
    """plain_bwd_dkv walking the bf16 K2's schedule (64-row q tiles over
    128-key blocks) gives the JAX package's dK and dV (the dense
    reference's where the Pallas K2's bounds are wrong, see `_case`)."""
    (q, k, v, g), want = _case(layout, mode, shape, dtype)
    causal, window = MODES[mode]
    bshd = layout == "bshd"
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.tensor(x).to(tdt) for x in (q, k, v, g))
    out, lse = fa.plain_fwd(tq, tk, tv, causal, 0.125, bshd, window)
    dd = fa.row_dot(tg, out, bshd, "plain")
    dk, dv = fa.plain_bwd_dkv(tq, tk, tv, tg, lse, dd, causal, 0.125, bshd,
                              window, bq=64, bk=128)
    for name, a, b in (("dk", dk, want[2]), ("dv", dv, want[3])):
        assert a.dtype == tdt and a.shape == tk.shape, name
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_plain_dq_on_the_kernel_schedule_matches_jax(layout, mode, shape,
                                                     dtype):
    """plain_bwd_dq walking the bf16 K3's schedule (128-row q blocks over
    64-key tiles, the mask on straddling tiles only) gives the JAX
    package's dQ (the dense reference's where `_case` takes it)."""
    (q, k, v, g), want = _case(layout, mode, shape, dtype)
    causal, window = MODES[mode]
    bshd = layout == "bshd"
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.tensor(x).to(tdt) for x in (q, k, v, g))
    out, lse = fa.plain_fwd(tq, tk, tv, causal, 0.125, bshd, window)
    dd = fa.row_dot(tg, out, bshd, "plain")
    dq = fa.plain_bwd_dq(tq, tk, tv, tg, lse, dd, causal, 0.125, bshd,
                         window, bq=128, bk=64)
    assert dq.dtype == tdt and dq.shape == tq.shape
    np.testing.assert_allclose(dq.float().numpy(), want[1], err_msg="dq",
                               **TOL[dtype])


def test_plain_dq_nan_in_k_reaches_the_rows_its_schedule_visits():
    """A NaN in key 300 reaches dQ through dS = 0 times a NaN key in
    every row whose q block visits key 300's tile: at 128-row q blocks
    over 64-key tiles (causal), rows 256-299 as well as the rows that
    attend key 300, and no row before 256."""
    rng = np.random.RandomState(10)
    q, k, v, do = (torch.tensor(rng.randn(1, 2, 512, 64).astype("f4"))
                   for _ in range(4))
    k[0, 0, 300, 0] = float("nan")
    out, lse = fa.plain_fwd(q, k, v, True, 0.125)
    dd = fa.row_dot(do, out, False, "plain")
    dq = fa.plain_bwd_dq(q, k, v, do, lse, dd, True, 0.125, bq=128, bk=64)
    bad = ~torch.isfinite(dq[0, 0]).all(dim=-1)
    assert bool(bad[256:].all()) and not bool(bad[:256].any())
    assert bool(torch.isfinite(dq[0, 0, 256:300, 1:]).all())
    assert bool(torch.isfinite(dq[0, 1]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_plain_row_dot_is_the_f32_rowsum(layout, dtype):
    """row_dot(impl="plain") is rowsum(dO * O) in f32, [B, H, Sq]
    contiguous, from either layout and either input dtype."""
    rng = np.random.RandomState(11)
    shp = (2, 128, 3, 64) if layout == "bshd" else (2, 3, 128, 64)
    do, out = (rng.randn(*shp).astype("f4") for _ in range(2))
    tdt = getattr(torch, dtype)
    tdo, tout = torch.tensor(do).to(tdt), torch.tensor(out).to(tdt)
    dd = fa.row_dot(tdo, tout, layout == "bshd", "plain")
    want = (tdo.float() * tout.float()).numpy().astype("f8").sum(-1)
    if layout == "bshd":
        want = want.transpose(0, 2, 1)
    assert dd.dtype == torch.float32 and dd.shape == (2, 3, 128)
    assert dd.is_contiguous()
    np.testing.assert_allclose(dd.numpy(), want, rtol=1e-5, atol=1e-5)


def test_backward_takes_dd_from_its_impl(monkeypatch):
    """_FlashCore.backward computes dd through `row_dot` with the impl of
    its forward."""
    calls = []
    plain = fa._ROW_DOTS["plain"]

    def counted(do, out, bshd):
        calls.append(bshd)
        return plain(do, out, bshd)
    monkeypatch.setitem(fa._ROW_DOTS, "plain", counted)
    rng = np.random.RandomState(12)
    q, k, v = (torch.tensor(rng.randn(1, 128, 2, 64).astype("f4"),
                            requires_grad=True) for _ in range(3))
    fa.flash_attention(q, k, v, causal=True, layout="bshd",
                       kernel="plain").sum().backward()
    assert calls == [True]


def test_plain_lse_matches_the_dense_logsumexp():
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(2, 3, 256, 64).astype("f4"))
               for _ in range(3))
    for causal, window in ((False, None), (True, None), (True, 64)):
        _, lse = fa.plain_fwd(q, k, v, causal, 0.125, False, window)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
        if causal:
            logits = fa._causal_mask(logits, window)
        np.testing.assert_allclose(lse.numpy(),
                                   torch.logsumexp(logits, -1).numpy(),
                                   atol=1e-5)


def test_fully_masked_rows_are_exactly_zero():
    """q_len > kv_len, causal: the first q_len - kv_len rows see no key.
    Their output, lse's clamp and dq are exactly 0, as in the Pallas
    kernels."""
    rng = np.random.RandomState(6)
    q = torch.tensor(rng.randn(1, 2, 256, 64).astype("f4"),
                     requires_grad=True)
    k, v = (torch.tensor(rng.randn(1, 2, 128, 64).astype("f4"),
                         requires_grad=True) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True, kernel="plain")
    out.backward(torch.ones_like(out))
    assert bool((out[:, :, :128] == 0).all())
    assert bool((q.grad[:, :, :128] == 0).all())
    assert torch.isfinite(k.grad).all() and torch.isfinite(v.grad).all()
    _, lse = fa.plain_fwd(q.detach(), k.detach(), v.detach(), True, 0.125)
    np.testing.assert_allclose(lse[:, :, :128].numpy(), np.log(1e-30),
                               rtol=1e-6)
    jout = _flash_array(*(jnp.asarray(t.detach().numpy()) for t in (q, k, v)),
                        causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)


def test_attended_nan_propagates_and_stays_in_its_rows():
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(1, 2, 256, 64).astype("f4"))
               for _ in range(3))
    k[0, 0, 100, 0] = float("nan")
    out = fa.flash_attention(q, k, v, causal=True, kernel="plain")
    assert not torch.isfinite(out[0, 0, 100:]).any()
    assert torch.isfinite(out[0, 0, :100]).all()
    assert torch.isfinite(out[0, 1]).all()


def test_dkv_bounds_are_clamped_where_the_pallas_bounds_are_not():
    """causal + window, q_len < kv_len: no k block's q range is negative
    or reversed, and every (q, k) pair in the band is visited."""
    off, bq, bk, window = 512, 128, 128, 64
    nqb, nkb = 128 // bq, 640 // bk
    seen = set()
    for kb in range(nkb):
        start, end = fa._dkv_block_bounds(off, kb, bq, bk, nqb, window)
        assert 0 <= start <= end <= nqb
        seen.update((i, kb) for i in range(start, end))
    for i in range(nqb):
        for kb in range(nkb):
            qi = off + i * bq + np.arange(bq)[:, None]
            ki = kb * bk + np.arange(bk)[None, :]
            if fa._band_keep(qi, ki, window).any():
                assert (i, kb) in seen


@pytest.mark.parametrize("sq,sk", [(512, 512), (128, 640), (256, 640)])
@pytest.mark.parametrize("window", [None, 64, 100, 256])
def test_dkv_bounds_on_the_kernel_schedule(window, sq, sk):
    """At the bf16 K2's 64-row q tiles and 128-key blocks, causal: every
    (q, k) pair in the band lies in a visited tile, and the first and
    last tile of each k block's range hold a kept pair."""
    bq, bk = 64, 128
    off, nqb = sk - sq, sq // bq
    qi = off + np.arange(sq)[:, None]
    keep = fa._band_keep(qi, np.arange(sk)[None, :], window)
    for kb in range(sk // bk):
        start, end = fa._dkv_block_bounds(off, kb, bq, bk, nqb, window)
        assert 0 <= start <= end <= nqb
        cols = keep[:, kb * bk:(kb + 1) * bk]
        rows = np.nonzero(cols.any(axis=1))[0]
        if rows.size == 0:
            assert start == end
            continue
        assert start <= rows[0] // bq and rows[-1] // bq < end
        assert cols[start * bq:(start + 1) * bq].any()
        assert cols[(end - 1) * bq:end * bq].any()


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("window", [None, 64, 100, 256])
def test_tiles_that_do_not_straddle_keep_every_pair(window, bk):
    """The bf16 kernels mask only tiles that straddle the band's edge:
    every other tile keeps all of its pairs, so skipping the mask there
    changes nothing. A window narrower than bq + bk - 1 cuts every tile
    it reaches. Tile shapes: K2's 64 q rows over 64 or 128 keys, and
    K3's 64 keys against a warpgroup's 64 q rows or plain's 128."""
    for bq in ((64, 128) if bk == 64 else (64,)):
        seen = set()
        for off in (-128, 0, 512):
            for q0 in range(0, 512, bq):
                for k0 in range(0, 1024, bk):
                    straddles = fa._tile_straddles(off, q0, k0, bq, bk,
                                                   window)
                    seen.add(straddles)
                    if not straddles:
                        assert bool(fa._keep_tile(off, q0, k0, bq, bk,
                                                  window, "cpu").all())
        assert True in seen
        assert (False in seen) == (window is None or window >= bq + bk - 1)


@pytest.mark.parametrize("sq,sk", [(512, 512), (128, 640), (256, 640),
                                   (256, 128)])
@pytest.mark.parametrize("window", [None, 64, 100, 256])
def test_dq_bounds_on_the_kernel_schedule(window, sq, sk):
    """At the bf16 K3's 128-row q blocks and 64-key tiles, causal: every
    (q, k) pair in the band lies in a visited tile, the last tile of each
    block's range holds a kept pair, and a block whose rows see no key
    visits none."""
    bq, bk = 128, 64
    off = sk - sq
    keep = fa._band_keep(off + np.arange(sq)[:, None],
                         np.arange(sk)[None, :], window)
    for qb in range(sq // bq):
        lower, upper = fa._causal_block_bounds(off, qb, bq, bk, sk // bk,
                                               window)
        rows = keep[qb * bq:(qb + 1) * bq]
        cols = np.nonzero(rows.any(axis=0))[0]
        if cols.size == 0:
            assert upper <= max(lower, 0)
            continue
        assert 0 <= lower <= cols[0] // bk and cols[-1] // bk < upper
        assert upper <= sk // bk
        assert rows[:, (upper - 1) * bk:upper * bk].any()


def test_cuda_kernel_raises_for_cpu_tensors():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention(q, q, q, causal=True, kernel="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.cuda_fwd(q, q, q, True, 0.125)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.cuda_bwd_dkv(q, q, q, q, lse, lse, True, 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.cuda_bwd_dq(q, q, q, q, lse, lse, True, 0.125)
    assert fa.launches == {"fwd": 0, "dkv": 0, "dq": 0, "dd": 0}


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_row_dot_raises_for_cpu_tensors(layout):
    """The dd kernel's wrapper raises for CPU tensors, whatever the
    dispatch asked for, and counts no launch."""
    before = dict(fa.launches)
    x = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.cuda_row_dot(x, x, layout == "bshd")
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.row_dot(x, x, layout == "bshd", "cuda")
    assert fa.launches == before


# (data pointer, (batch, seq, head) strides in elements, element size)
# -> whether a bf16 operand may be read by TMA / 16-byte loads
ALIGNMENT_CASES = {
    "qkv view": (0x7f0000000000 + 2 * 12 * 64, (1024 * 2304, 2304, 64), 2,
                 True),
    "bhsd": (0x7f0000000200, (12 * 1024 * 64, 64, 1024 * 64), 2, True),
    "base 2 bytes off": (0x7f0000000002, (1024 * 768, 768, 64), 2, False),
    "base 8 bytes off": (0x7f0000000008, (1024 * 768, 768, 64), 2, False),
    "odd row stride": (0x7f0000000000, (1024 * 772, 772, 64), 2, False),
    "head stride 4 elements": (0x7f0000000000, (4096, 64, 4), 2, False),
    "f32, 4-element strides": (0x7f0000000000, (4096, 64, 4), 4, True),
}


@pytest.mark.parametrize("case", list(ALIGNMENT_CASES))
def test_tma_alignment_rule(case):
    ptr, strides, elt, ok = ALIGNMENT_CASES[case]
    assert fa.tma_aligned(ptr, strides, elt) is ok


def test_misaligned_bf16_operand_is_refused_by_name():
    """A [B, S, H, 64] view one element into a flat bf16 buffer (base 2
    bytes off 16) is refused, naming the tensor; aligned views of the
    qkv projection pass."""
    qkv = torch.zeros(2, 128, 3, 2, 64, dtype=torch.bfloat16)
    views = {"q": qkv[:, :, 0], "k": qkv[:, :, 1], "v": qkv[:, :, 2]}
    fa._check_aligned(views, bshd=True)
    flat = torch.zeros(2 * 128 * 2 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 128, 2, 64)
    assert shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="bf16 v needs a 16-byte"):
        fa._check_aligned({**views, "v": shifted}, bshd=True)
    # f32 operands go to the CUDA-core kernels, which take any alignment
    fa._check_aligned({"q": shifted.float()[:, :, :, 1:]}, bshd=True)


def test_window_requires_causal_and_a_positive_width():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, q, q, window=16)
    with pytest.raises(ValueError, match="positive"):
        fa.flash_attention(q, q, q, causal=True, window=0)


def test_dispatch_resolution_order(monkeypatch):
    monkeypatch.delenv("PT_FLASH_KERNEL", raising=False)
    assert fa.resolve_kernel(None, "cpu") == "plain"
    monkeypatch.setenv("PT_FLASH_KERNEL", "reference")
    assert fa.resolve_kernel(None, "cpu") == "reference"
    with fa.kernel_scope("plain"):
        assert fa.resolve_kernel(None, "cpu") == "plain"
        assert fa.resolve_kernel("cuda", "cpu") == "cuda"
    monkeypatch.delenv("PT_FLASH_KERNEL")
    fa.set_flash_kernel("reference")
    try:
        assert fa.resolve_kernel(None, "cpu") == "reference"
    finally:
        fa.set_flash_kernel("auto")
    with pytest.raises(ValueError):
        fa.resolve_kernel("pallas")


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_mask_and_short_sequences_take_the_dense_path(layout):
    """A boolean mask, or a sequence length that is not a multiple of
    128, runs dense attention, as `_flash_array` does; the results match
    the JAX package's."""
    rng = np.random.RandomState(8)
    shp = (1, 96, 2, 64) if layout == "bshd" else (1, 2, 96, 64)
    q, k, v = (rng.randn(*shp).astype("f4") for _ in range(3))
    mask = rng.rand(1, 1, 96, 96) > 0.3
    mask[..., 0] = True
    before = dict(fa.routes)
    for m in (None, mask):
        got = fa.flash_attention(
            *(torch.tensor(x) for x in (q, k, v)), causal=True,
            layout=layout, attn_mask=None if m is None else torch.tensor(m))
        want = _flash_array(*(jnp.asarray(x) for x in (q, k, v)),
                            None if m is None else jnp.asarray(m),
                            causal=True, layout=layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert fa.routes["dense"] == before["dense"] + 2
    assert fa.routes["kernel"] == before["kernel"]


def test_attention_dropout_draws_from_the_given_generator():
    rng = np.random.RandomState(9)
    q, k, v = (torch.tensor(rng.randn(1, 2, 128, 64).astype("f4"))
               for _ in range(3))
    with pytest.raises(ValueError, match="Generator"):
        fa.flash_attention(q, k, v, causal=True, dropout_p=0.5)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return fa.flash_attention(q, k, v, causal=True, dropout_p=0.5,
                                  generator=gen)
    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    full = fa.flash_attention(q, k, v, causal=True)
    assert not torch.allclose(draw(1), full)
