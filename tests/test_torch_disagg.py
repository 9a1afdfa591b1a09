"""The block-level KV handoff in the port (paddle_tpu_torch) against the
JAX package: a prefill-role and a decode-role scheduler joined by the
loop the JAX fleet's DisaggFleetRouter runs (`step` / `_handoff`), the
payload's refusals and the pool's manifest, and payloads crossing from
one package's engine to the other's.

Model: the speculative tests' target (vocab 128, 2 layers, hidden 128,
2 heads, initializer_range 0.2; both packages hold the same numpy
weights through `load_jax_state`) and a 1-layer draft made of its
embeddings, first block and final norm. Engines: 4 slots, horizon 64,
blocks of 8, chunks of 16; the prompts span one and two chunks.

Tolerances: tokens, counts, block lists and digests exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.serving import HandoffRefused as JHandoffRefused
from paddle_tpu.serving import PagedServingEngine as JPaged
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JDense
from paddle_tpu.serving import SpeculativePagedEngine as JSpec
from paddle_tpu.serving.paged import engine as jpaged
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.serving import (HandoffRefused, PagedServingEngine,
                                      Request, Scheduler, ServingEngine,
                                      SpeculativePagedEngine)
from paddle_tpu_torch.serving.paged import engine as tpaged

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB = 128
TARGET = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=64, dropout=0.0, attn_dropout=0.0,
              initializer_range=0.2)
DRAFT = dict(TARGET, num_layers=1)
MAX_LEN, BLOCK, CHUNK, SPEC_K, MAX_NEW = 64, 8, 16, 2, 6
ENGINE = dict(num_slots=4, max_len=MAX_LEN, block_size=BLOCK,
              num_blocks=33, prefill_chunk_len=CHUNK)


def _pair(cfg, state):
    """The JAX model and the port's, both holding `state`."""
    jm = JGPT(JConfig(**cfg))
    jm.set_state_dict(state)
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    state = {k: v.numpy() for k, v in JGPT(JConfig(**TARGET)).state_dict()
             .items()}
    target = _pair(TARGET, state)
    draft = _pair(DRAFT, {k: v for k, v in state.items()
                          if ".blocks.1." not in k})
    return target, draft


# flavour -> (JAX engine, port engine) factories over (target, draft)
FLAVOURS = {
    "paged": (lambda t, d: JPaged(t[0], paged_kernel="lax", **ENGINE),
              lambda t, d: PagedServingEngine(t[1], device="cpu", **ENGINE)),
    "spec": (lambda t, d: JSpec(t[0], d[0], spec_k=SPEC_K,
                                paged_kernel="lax", **ENGINE),
             lambda t, d: SpeculativePagedEngine(t[1], d[1], spec_k=SPEC_K,
                                                 device="cpu", **ENGINE)),
}


def _jobs(n=6, seed=500):
    """Mixed lengths (the JAX disagg tests' set), including prompts that
    span two prefill chunks."""
    lens = [4, 6, CHUNK + 2, 5, CHUNK + 4, 7]
    return [(np.random.RandomState(seed + i)
             .randint(0, VOCAB, (lens[i % len(lens)],)).tolist(), MAX_NEW)
            for i in range(n)]


def _unified(sched, jobs):
    reqs = [sched.submit(prompt=p, max_tokens=m) for p, m in jobs]
    sched.run()
    return [r.output_tokens for r in reqs]


def _handoff_loop(prefill, decode, jobs, request_cls):
    """The disaggregated fleet's round: step the prefill replica, hand
    every staged (request, payload) to the decode replica as the
    continuation prompt + first token with the remaining budget, step
    the decode replica; until both are idle. Returns the streams (the
    prefill hop's token + the decode hop's) and the payloads."""
    firsts = [prefill.submit(prompt=p, max_tokens=m) for p, m in jobs]
    hops, payloads = {}, []
    while True:
        pending = prefill.step()
        for req, payload in prefill.take_handoffs():
            assert payload is not None, "export failed"
            i = next(i for i, r in enumerate(firsts) if r is req)
            hops[i] = decode.submit(request=request_cls(
                prompt=req.prompt + req.output_tokens,
                max_tokens=req.max_tokens - len(req.output_tokens),
                handoff=payload))
            payloads.append(payload)
        pending += decode.step()
        if not pending:
            break
    assert all(r.finish_reason is None for r in firsts) and \
        sorted(hops) == list(range(len(jobs)))
    return ([firsts[i].output_tokens + hops[i].output_tokens
             for i in range(len(jobs))], payloads)


_RUNS = {}


def _runs(flavour, models):
    """(JAX unified, JAX disagg, port unified, port disagg, the engines)
    for a flavour, computed once."""
    if flavour not in _RUNS:
        make_j, make_t = FLAVOURS[flavour]
        target, draft = models
        jobs = _jobs()
        out = {"jax_unified": _unified(JScheduler(make_j(target, draft)),
                                       jobs),
               "port_unified": _unified(Scheduler(make_t(target, draft)),
                                        jobs)}
        jp, jd = make_j(target, draft), make_j(target, draft)
        out["jax_disagg"], _ = _handoff_loop(
            JScheduler(jp, role="prefill"), JScheduler(jd, role="decode"),
            jobs, JRequest)
        tp, td = make_t(target, draft), make_t(target, draft)
        out["port_disagg"], out["payloads"] = _handoff_loop(
            Scheduler(tp, role="prefill"), Scheduler(td, role="decode"),
            jobs, Request)
        out["engines"] = (jp, jd, tp, td)
        _RUNS[flavour] = out
    return _RUNS[flavour]


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_disagg_streams_equal_unified_in_both_packages(flavour, models):
    r = _runs(flavour, models)
    assert r["jax_disagg"] == r["jax_unified"]
    assert r["port_unified"] == r["jax_unified"]
    assert r["port_disagg"] == r["jax_unified"]
    assert max(len(set(s)) for s in r["port_disagg"]) >= 3, \
        "every stream repeats one or two tokens: the weights compare nothing"
    # two-chunk prompts travelled: some payload carries three blocks
    assert max(p["blocks"] for p in r["payloads"]) >= 3


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_roles_stay_pure(flavour, models):
    """The prefill replica never runs a decode wave, the decode replica
    never a prefill chunk: in the port by its program counters, in JAX
    by its compiled programs (lazy jit)."""
    jp, jd, tp, td = _runs(flavour, models)["engines"]
    assert tp.decode_waves_run == 0 and tp.prefill_chunks_run > 0
    assert td.prefill_chunks_run == 0 and td.decode_waves_run > 0
    assert (jp.decode_compiles, jd.prefill_compiles) == (0, 0)
    assert jp.prefill_compiles >= 1 and jd.decode_compiles == 1
    for eng in (tp, td):
        assert eng.block_pool.used == 0


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_payload_layers_follow_jax_leaf_order(flavour, models):
    """One layer per pool, in JAX's tree_leaves order (target K, V per
    layer, then the draft's), float32 numpy arrays, nbytes their sum."""
    target, draft = models
    payload = _runs(flavour, models)["payloads"][0]
    n_pools = 2 * (TARGET["num_layers"]
                   + (DRAFT["num_layers"] if flavour == "spec" else 0))
    assert len(payload["layers"]) == n_pools
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               and a.shape == (payload["blocks"], 2, BLOCK, 64)
               for a in payload["layers"])
    assert payload["nbytes"] == sum(a.nbytes for a in payload["layers"])
    assert payload["digest"] == jpaged._handoff_digest(
        payload["layers"], payload["n_tokens"], BLOCK)


def test_role_checks_match_jax(models):
    """A role needs the handoff surface (the dense engine lacks it); an
    unknown role raises; a decode replica refuses a fresh prompt and a
    prefill replica a payload, without resolving the request."""
    (jm, tm), _ = models
    with pytest.raises(ValueError, match="handoff"):
        JScheduler(JDense(jm, num_slots=2, max_len=MAX_LEN), role="decode")
    with pytest.raises(ValueError, match="handoff"):
        Scheduler(ServingEngine(tm, num_slots=2, max_len=MAX_LEN,
                                device="cpu"), role="prefill")
    for sched_cls, req_cls, make in (
            (JScheduler, JRequest, FLAVOURS["paged"][0]),
            (Scheduler, Request, FLAVOURS["paged"][1])):
        eng = make(*models)
        with pytest.raises(ValueError, match="role"):
            sched_cls(eng, role="bogus")
        fresh = req_cls(prompt=[1, 2, 3], max_tokens=2)
        with pytest.raises(ValueError, match="handoff"):
            sched_cls(eng, role="decode").submit(request=fresh)
        carried = req_cls(prompt=[1, 2, 3], max_tokens=2, handoff={})
        with pytest.raises(ValueError, match="handoff"):
            sched_cls(eng, role="prefill").submit(request=carried)
        assert fresh.finish_reason is None and carried.finish_reason is None


def _export_one(engine, prompt):
    sched = Scheduler(engine, role="prefill")
    req = sched.submit(prompt=prompt, max_tokens=MAX_NEW)
    while sched.step():
        pass
    (got, payload), = sched.take_handoffs()
    assert got is req
    return req, payload


def test_corrupt_payload_refused_and_pool_rolled_back(models):
    """One flipped byte: both packages' engines refuse the payload
    (HandoffRefused) with the importing pool unchanged, then import the
    pristine payload."""
    target, draft = models
    prompt = list(range(1, CHUNK + 3))
    req, payload = _export_one(FLAVOURS["paged"][1](target, draft), prompt)
    corrupt = dict(payload)
    layers = [np.array(a) for a in payload["layers"]]
    layers[0].view(np.uint8).flat[0] ^= 1
    corrupt["layers"] = layers
    cont = prompt + req.output_tokens
    for make, refused in ((FLAVOURS["paged"][1], HandoffRefused),
                          (FLAVOURS["paged"][0], JHandoffRefused)):
        dst = make(target, draft)
        used = dst.block_pool.used
        with pytest.raises(refused, match="digest"):
            dst.import_handoff(0, cont, corrupt)
        assert dst.block_pool.used == used
        assert not dst.slot_active[0]
        assert dst.import_handoff(0, cont, payload) == cont[-1]
        assert dst.slot_active[0] and dst.slot_pos[0] == len(prompt)


def test_refusals_of_geometry_and_token_state(models):
    """The checks before the digest: another block size, a continuation
    that does not match the payload, another engine flavour's layout, a
    version skew, each refused with the pool unchanged."""
    target, draft = models
    prompt = list(range(3, 12))
    req, payload = _export_one(FLAVOURS["paged"][1](target, draft), prompt)
    cont = prompt + req.output_tokens
    dst = FLAVOURS["spec"][1](target, draft)
    cases = [(dict(payload, version=2), cont, "version"),
             (dict(payload, block_size=4), cont, "block_size"),
             (payload, cont + [1], "token state"),
             (payload, cont[:-1] + [cont[-1] ^ 1], "token state"),
             (payload, cont, "layout")]
    for bad, c, why in cases:
        with pytest.raises(HandoffRefused, match=why):
            dst.import_handoff(0, c, bad)
        assert dst.block_pool.used == 0


def test_block_pool_manifest_semantics_match_jax(models):
    """export_blocks refuses the scratch block and a freed one; the
    manifest carries each block's chain hash (None unhashed);
    import_blocks allocates as many fresh blocks; peek_prefix_hashes
    counts the leading cached hashes without a reference. Every answer
    equals the JAX pool's on the same script."""
    from paddle_tpu.serving.paged.block_pool import BlockPool as JPool
    from paddle_tpu_torch.serving import BlockPool
    toks = list(range(40))
    out = []
    for pool in (JPool(9, 8), BlockPool(9, 8)):
        with pytest.raises(ValueError):
            pool.export_blocks([pool.SCRATCH])
        freed = pool.alloc(1)
        pool.release(freed)
        with pytest.raises(ValueError):
            pool.export_blocks(freed)
        live = pool.alloc(3)
        hashes = pool.prompt_hashes(toks)
        pool.register_hash(live[0], hashes[0])
        pool.register_hash(live[1], hashes[1])
        manifest = pool.export_blocks(live)
        assert manifest == [{"hash": hashes[0]}, {"hash": hashes[1]},
                            {"hash": None}]
        fresh = pool.import_blocks(manifest)
        used = pool.used
        peeks = [pool.peek_prefix_hashes(hashes[:k]) for k in range(5)]
        peeks.append(pool.peek_prefix_hashes(pool.prompt_hashes([9] + toks)))
        assert pool.used == used
        out.append((manifest, fresh, peeks, pool.used, pool.prefix_hits,
                    pool.prefix_misses))
    assert out[0] == out[1]
    assert out[1][2] == [0, 1, 2, 2, 2, 0]


def test_digest_hashes_what_jax_hashes():
    """The same content gives the same digest in both packages: f32
    numpy layers, and bf16 layers (the port's CPU tensors against JAX's
    numpy bfloat16 arrays holding the same bits)."""
    rng = np.random.default_rng(0)
    f32 = [rng.standard_normal((3, 2, 8, 64)).astype(np.float32)
           for _ in range(4)]
    bits = [rng.integers(0, 1 << 16, (3, 2, 8, 64), dtype=np.uint16)
            for _ in range(4)]
    jax_bf16 = [b.view(np.dtype(jnp.bfloat16)) for b in bits]
    port_bf16 = [torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
                 for b in bits]
    for jl, tl in ((f32, f32), (jax_bf16, port_bf16)):
        assert tpaged._handoff_digest(tl, 17, 8) == \
            jpaged._handoff_digest(jl, 17, 8)
    assert tpaged._handoff_digest(f32, 17, 8) != \
        tpaged._handoff_digest(f32, 16, 8)


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_payloads_cross_packages(flavour, models):
    """A JAX prefill replica hands off to the port's decode replica, and
    the port's prefill replica to JAX's decode replica (the role engines
    of the runs above, each keeping its role): each payload's digest is
    the one the other package computes over its layers, and the streams
    equal the unified engines'."""
    r = _runs(flavour, models)
    jp, jd, tp, td = r["engines"]
    jobs = _jobs()
    j2t, j_payloads = _handoff_loop(JScheduler(jp, role="prefill"),
                                    Scheduler(td, role="decode"), jobs,
                                    Request)
    t2j, t_payloads = _handoff_loop(Scheduler(tp, role="prefill"),
                                    JScheduler(jd, role="decode"), jobs,
                                    JRequest)
    assert j2t == r["jax_unified"] and t2j == r["jax_unified"]
    for p in j_payloads:
        assert tpaged._handoff_digest(p["layers"], p["n_tokens"],
                                      BLOCK) == p["digest"]
    for p in t_payloads:
        assert jpaged._handoff_digest(p["layers"], p["n_tokens"],
                                      BLOCK) == p["digest"]
    # the same prompts' manifests agree block for block (chain hashes)
    by_len = {p["n_tokens"]: p["manifest"] for p in j_payloads}
    assert all(by_len[p["n_tokens"]] == p["manifest"] for p in t_payloads)


def test_jax_bf16_payload_imports_bit_for_bit(models):
    """bf16 pools: a JAX prefill replica's payload (numpy bfloat16
    arrays) imports into the port's engine, its digest checked by the
    port, every pool holding the payload's bits at the fresh blocks."""
    target, draft = models
    jeng = JPaged(target[0], paged_kernel="lax", cache_dtype=jnp.bfloat16,
                  **ENGINE)
    sched = JScheduler(jeng, role="prefill")
    prompt = _jobs(1, seed=700)[0][0] + list(range(20))
    req = sched.submit(prompt=prompt, max_tokens=MAX_NEW)
    while sched.step():
        pass
    (_, payload), = sched.take_handoffs()
    assert str(payload["layers"][0].dtype) == "bfloat16"
    dst = PagedServingEngine(target[1], device="cpu",
                             cache_dtype=torch.bfloat16, **ENGINE)
    dst.import_handoff(1, prompt + req.output_tokens, payload)
    idx = torch.tensor(dst._slot_blocks[1])
    for pool, a in zip(dst._pool_leaves(), payload["layers"]):
        got = pool.index_select(0, idx).view(torch.int16).numpy()
        np.testing.assert_array_equal(got, np.asarray(a).view(np.int16))
