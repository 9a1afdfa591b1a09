"""The port's LLaMA serving path against the JAX package's: the dense and
paged `decode_step`, `prefill`, `prefill_chunk` and `decode_chunk`; the
dense, paged and speculative engines under the Scheduler; the front door
with `draft_config=LlamaConfig(...)`; a GQA handoff payload crossing
from one package's engine to the other's.

Target: vocab 128, hidden 96, 2 layers, 6 heads over 2 KV heads (GQA rep
3, head_dim 16), max_seq_len 64, initializer_range 0.2 (every stream
test asserts a stream of at least three distinct tokens). Draft: the
target's embeddings, first block and final norm (1 layer). Both packages
hold the same numpy weights through `load_jax_state`. Engines: 4 slots,
horizon 64, blocks of 8, chunks of 16, a 32-token dense bucket. Each
job set runs once on one engine of each kind and package, and the
module's tests share the streams.

Tolerances: logits and pools within 1e-4 x max(1, |JAX|) (f32; the two
sum, and round RoPE and RMSNorm, in different orders: 2 layers and up to
8 steps move logits of magnitude ~4 by about 1e-5); tokens, finish
reasons, counts and digests exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.nn import paged_attention as jpa
from paddle_tpu.serving import PagedServingEngine as JPaged
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JDense
from paddle_tpu.serving import SpeculativePagedEngine as JSpec
from paddle_tpu.serving.paged import engine as jpaged
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import llama as tllama
from paddle_tpu_torch.nlp import load_jax_state
from paddle_tpu_torch.nn import paged_attention as tpa
from paddle_tpu_torch.serving import (PagedServingEngine, Request,
                                      Scheduler, ServingEngine,
                                      SpeculativePagedEngine)
from paddle_tpu_torch.serving.paged import engine as tpaged

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

RTOL = 1e-4
VOCAB = 128
TARGET = dict(vocab_size=VOCAB, hidden_size=96, num_layers=2, num_heads=6,
              num_kv_heads=2, max_seq_len=64, initializer_range=0.2)
DRAFT = dict(TARGET, num_layers=1)
MAX_LEN, BLOCK, CHUNK, SPEC_K = 64, 8, 16, 3
PAGED = dict(num_slots=4, max_len=MAX_LEN, block_size=BLOCK, num_blocks=33,
             prefill_chunk_len=CHUNK)
DENSE = dict(num_slots=4, max_len=MAX_LEN, prefill_len=32)


def _pair(cfg, state):
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**cfg))
    jm.set_state_dict(state)
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**cfg), device="cpu")
    load_jax_state(tm, state)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    state = {k: v.numpy() for k, v in jllama.LlamaForCausalLM(
        jllama.LlamaConfig(**TARGET)).state_dict().items()}
    target = _pair(TARGET, state)
    draft = _pair(DRAFT, {k: v for k, v in state.items()
                          if ".layers.1." not in k})
    return target, draft


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    assert (err <= RTOL * np.maximum(1.0, np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


def _caches_close(jc, tc, rows=slice(None)):
    """Every K and V cache (or pool) at `rows` of its first axis."""
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk.numpy()[rows], np.asarray(jk)[rows], "K")
        _close(tv.numpy()[rows], np.asarray(jv)[rows], "V")


# ---------------------------------------------------------------------------
# the model's serving methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vector,window", [(False, None), (True, None),
                                           (True, 5)],
                         ids=["scalar", "vector", "vector-window"])
def test_dense_decode_step_matches_jax(models, vector, window):
    """Six dense decode steps over three rows, lockstep (scalar pos) or
    each at its own depth ([B] pos, one row parked at the horizon, whose
    rope row clamps): logits and the GQA caches [B, 2, L, 16] equal
    JAX's."""
    jm, tm = models[0]
    if window:
        state = {k: v.numpy() for k, v in jm.state_dict().items()}
        jm, tm = _pair(dict(TARGET, attn_window=window), state)
    L = 24
    rng = np.random.default_rng(3 + vector)
    jc, tc = jm.init_cache(3, L), tm.init_cache(3, L)
    assert tc[0][0].shape == (3, 2, L, 16)
    start = np.array([0, 4, L] if vector else [2, 2, 2], np.int32)
    for t in range(6):
        tok = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
        pos = np.minimum(start + t, L) if vector else int(start[0] + t)
        jl, jc = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                                jnp.asarray(pos) if vector
                                else jnp.int32(pos))
        tl, tc = tm.decode_step(torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long() if vector
                                else pos)
        live = slice(0, 2) if vector else slice(0, 3)
        _close(tl.numpy()[live], _np(jl)[live], f"step {t}")
    _caches_close(jc, tc, slice(0, 2) if vector else slice(0, 3))


@pytest.mark.parametrize("bucket,max_seq_len,route", [(32, 64, "dense"),
                                                      (16, 128, "k1")])
def test_dense_prefill_matches_jax(models, bucket, max_seq_len, route):
    """Frontier logits and the cache rows [0, P) against JAX's prefill:
    at a 32 bucket both take the dense route; with a 128-row table the
    port pads 16 to 128 for flash attention's kernel route."""
    state = {k: v.numpy() for k, v in models[0][0].state_dict().items()}
    jm, tm = _pair(dict(TARGET, max_seq_len=max_seq_len), state)
    assert tm.prefill_route(bucket) == route
    ids = np.random.default_rng(bucket).integers(
        0, VOCAB, (1, bucket)).astype(np.int32)
    jl, jc = jm.prefill(Tensor(jnp.asarray(ids)), 48, dtype=jnp.float32,
                        frontier=jnp.int32(bucket - 3))
    tl, tc = tm.prefill(torch.from_numpy(ids).long(), 48,
                        frontier=torch.tensor(bucket - 3))
    assert tl.shape == (1, 1, VOCAB)
    _close(tl.numpy(), _np(jl), "frontier logits")
    for (jk, jv), (tk, tv) in zip(jc, tc):
        assert tk.shape == (1, 2, 48, 16)
        _close(tk.numpy()[:, :, :bucket], np.asarray(jk)[:, :, :bucket], "K")
        _close(tv.numpy()[:, :, :bucket], np.asarray(jv)[:, :, :bucket], "V")
        assert not tk[:, :, bucket:].any()


def test_paged_decode_step_matches_jax(models):
    """Three lanes decode four steps through their block tables (one lane
    outside the wave on an all-scratch table at the horizon): logits of
    the live lanes and every pool block but scratch equal JAX's."""
    jm, tm = models[0]
    rng = np.random.default_rng(7)
    nb = 13
    jc = jm.init_paged_cache(nb, BLOCK, MAX_LEN)
    tc = tm.init_paged_cache(nb, BLOCK, MAX_LEN)
    assert tc[0][0].shape == (nb, 2, BLOCK, 16)
    tables = np.zeros((3, MAX_LEN // BLOCK), np.int32)
    tables[0, :3], tables[1, :3] = [1, 2, 3], [4, 5, 6]
    start = np.array([3, 11, MAX_LEN], np.int32)
    for t in range(4):
        tok = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
        pos = np.minimum(start + t, MAX_LEN)
        with jpa.kernel_scope("lax"):
            jl, jc = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                                    jnp.asarray(pos),
                                    block_tables=jnp.asarray(tables))
        with tpa.kernel_scope("plain"):
            tl, tc = tm.decode_step(torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(pos).long(),
                                    block_tables=torch.from_numpy(tables))
        _close(tl.numpy()[:2], _np(jl)[:2], f"step {t}")
    _caches_close(jc, tc, slice(1, None))       # all but scratch block 0


def test_prefill_chunk_and_decode_chunk_match_jax(models):
    """Two lanes prefilled by chunks (the frontier row's logits checked),
    then one decode_chunk at C = 4 with per-lane starts and valid
    lengths 4, 2 and 0 (a lane outside the wave at the horizon, whose
    rope rows clamp): the [S, C, V] logits of the live lanes and the
    pools equal JAX's."""
    jm, tm = models[0]
    rng = np.random.default_rng(3)
    nb = 13
    jc = jm.init_paged_cache(nb, BLOCK, MAX_LEN)
    tc = tm.init_paged_cache(nb, BLOCK, MAX_LEN)
    tables = np.zeros((3, MAX_LEN // BLOCK), np.int32)
    tables[0, :3], tables[1, :3] = [1, 2, 3], [4, 5, 6]
    for lane, n in ((0, 14), (1, 9)):
        toks = rng.integers(0, VOCAB, (1, 16)).astype(np.int32)
        table = tables[lane:lane + 1]
        with jpa.kernel_scope("lax"):
            jl, jc = jm.prefill_chunk(Tensor(jnp.asarray(toks)), jc,
                                      jnp.asarray(table), jnp.int32(0),
                                      jnp.int32(n),
                                      frontier=jnp.int32(n - 1))
        tl, tc = tm.prefill_chunk(torch.from_numpy(toks).long(), tc,
                                  torch.from_numpy(table), torch.tensor(0),
                                  torch.tensor(n),
                                  frontier=torch.tensor(n - 1))
        assert tl.shape == (1, 1, VOCAB)
        _close(tl.numpy(), _np(jl), f"lane {lane} frontier")
    chunk = rng.integers(0, VOCAB, (3, 4)).astype(np.int32)
    start = np.array([14, 9, MAX_LEN], np.int32)
    valid = np.array([4, 2, 0], np.int32)
    with jpa.kernel_scope("lax"):
        jl, jc = jm.decode_chunk(Tensor(jnp.asarray(chunk)), jc,
                                 jnp.asarray(tables), jnp.asarray(start),
                                 jnp.asarray(valid))
    tl, tc = tm.decode_chunk(torch.from_numpy(chunk).long(), tc,
                             torch.from_numpy(tables),
                             torch.from_numpy(start).long(),
                             torch.from_numpy(valid).long())
    assert tl.shape == (3, 4, VOCAB)
    _close(tl.numpy()[:2], _np(jl)[:2], "verify logits")
    _caches_close(jc, tc, slice(1, None))


# ---------------------------------------------------------------------------
# the engines under the Scheduler, token for token against JAX's
# ---------------------------------------------------------------------------

# kind -> (JAX engine, port engine) over (target, draft)
KINDS = {
    "dense": (lambda t, d, **kw: JDense(t[0], **dict(DENSE, **kw)),
              lambda t, d, **kw: ServingEngine(t[1], device="cpu",
                                               **dict(DENSE, **kw))),
    "paged": (lambda t, d, **kw: JPaged(t[0], paged_kernel="lax",
                                        **dict(PAGED, **kw)),
              lambda t, d, **kw: PagedServingEngine(
                  t[1], device="cpu", **dict(PAGED, **kw))),
    "spec": (lambda t, d, **kw: JSpec(t[0], d[0], spec_k=SPEC_K,
                                      paged_kernel="lax",
                                      **dict(PAGED, **kw)),
             lambda t, d, **kw: SpeculativePagedEngine(
                 t[1], d[1], spec_k=SPEC_K, device="cpu",
                 **dict(PAGED, **kw))),
}


def _mixed_jobs():
    """Ten requests over 4 slots: retire and refill mid-stream, two run
    into the 64-token horizon."""
    rng = np.random.RandomState(11)
    jobs = [(rng.randint(0, VOCAB, (int(rng.randint(2, 30)),)).tolist(),
             int(rng.randint(3, 12))) for _ in range(10)]
    jobs[3] = (rng.randint(0, VOCAB, (20,)).tolist(), 1000)
    jobs[7] = (rng.randint(0, VOCAB, (31,)).tolist(), 1000)
    return jobs


def _preempt_jobs():
    rng = np.random.RandomState(6)
    return [(rng.randint(0, VOCAB, (14,)).tolist(), 12) for _ in range(4)]


_STREAMS = {}


def _run(sched, jobs, eos):
    reqs = [sched.submit(prompt=p, max_tokens=m, eos_token_id=eos)
            for p, m in jobs]
    sched.run()
    return reqs


def _streams(kind, scenario, models):
    """(JAX requests, port requests, port scheduler, JAX engine) of a
    scenario, computed once: "mixed" (eos and the horizon) on one engine
    of the kind in each package, "preemption" on engines of 9 pool
    blocks."""
    key = (kind, scenario)
    if key not in _STREAMS:
        make_j, make_t = KINDS[kind]
        target, draft = models
        over = {"num_blocks": 9} if scenario == "preemption" else {}
        jobs = _mixed_jobs() if scenario == "mixed" else _preempt_jobs()
        eos = None
        if scenario == "mixed":
            # a token the plain paged stream of the first job emits
            probe = Scheduler(KINDS["paged"][1](target, draft))
            eos = probe.generate(jobs[0][0], max_tokens=4)[2]
        jeng = make_j(target, draft, **over)
        jreqs = _run(JScheduler(jeng), jobs, eos)
        sched = Scheduler(make_t(target, draft, **over))
        _STREAMS[key] = (jreqs, _run(sched, jobs, eos), sched, jeng)
    return _STREAMS[key]


@pytest.mark.parametrize("kind,scenario", [
    ("dense", "mixed"), ("paged", "mixed"), ("spec", "mixed"),
    ("paged", "preemption"), ("spec", "preemption")])
def test_engine_streams_equal_jax(models, kind, scenario):
    jreqs, treqs, sched, _ = _streams(kind, scenario, models)
    want = [(r.output_tokens, r.finish_reason) for r in jreqs]
    assert [(r.output_tokens, r.finish_reason) for r in treqs] == want
    assert max(len(set(r.output_tokens)) for r in treqs) >= 3
    reasons = {r.finish_reason for r in treqs}
    eng = sched.engine
    if scenario == "mixed":
        assert {"eos", "length", "max_tokens"} <= reasons
    else:
        assert sum(r.preemptions for r in treqs) >= 1
        assert reasons == {"max_tokens"}
    if kind != "dense":
        assert eng.block_pool.used == 0
    assert (eng.decode_compiles, eng.prefill_compiles) == (0, 0)


def test_all_engines_serve_one_stream(models):
    """Greedy: the dense, paged and speculative engines emit the same
    tokens on the mixed jobs; the draft is accepted in part."""
    streams = [[(r.output_tokens, r.finish_reason)
                for r in _streams(kind, "mixed", models)[1]]
               for kind in ("dense", "paged", "spec")]
    assert streams[0] == streams[1] == streams[2]
    snap = _streams("spec", "mixed", models)[2].metrics.snapshot()
    assert 0 < snap["spec_acceptance_rate"] < 1


def test_front_door_paged_dense_and_draft_config(models):
    """create_llm_predictor takes the LLaMA unchanged: paged=False (the
    dense engine), paged=True, and speculative=True with
    draft_config=LlamaConfig(...), whose draft is built in the target's
    class on its device and dtype; all serve JAX's paged stream."""
    tm = models[0][1]
    prompt = _mixed_jobs()[1][0]
    want = JScheduler(_streams("paged", "mixed", models)[3]).generate(
        prompt, max_tokens=8)
    common = dict(num_slots=2, max_len=MAX_LEN, prefill_len=32,
                  block_size=BLOCK, device="cpu")
    for opts, cls in (({"paged": False}, ServingEngine),
                      ({"paged": True}, PagedServingEngine),
                      ({"speculative": True, "k": 2,
                        "draft_config": tllama.LlamaConfig(**DRAFT)},
                       SpeculativePagedEngine)):
        cfg = inference.Config().enable_llm_engine(**common, **opts)
        pred = inference.create_llm_predictor(cfg, model=tm)
        assert type(pred.engine) is cls
        assert pred.generate(prompt, max_tokens=8) == want, opts
    built = pred.engine.draft_model
    assert type(built) is tllama.LlamaForCausalLM
    assert built.cfg.num_layers == 1 and built.device == tm.device
    assert built.parameters()[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# the GQA handoff across packages
# ---------------------------------------------------------------------------

def _handoff_loop(prefill, decode, jobs, request_cls):
    """Step the prefill role, hand every staged (request, payload) to the
    decode role as prompt + first token with the remaining budget, step
    the decode role; until both are idle. Returns the streams and the
    payloads."""
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
    return ([firsts[i].output_tokens + hops[i].output_tokens
             for i in range(len(jobs))], payloads)


def test_gqa_handoff_payload_crosses_packages(models):
    """A JAX prefill role hands off to the port's decode role, and the
    port's prefill role to JAX's decode role (each package's paged
    engine of the mixed streams, under a scheduler of each role in
    turn): each payload holds GQA blocks [n, 2, 8, 16] per pool in the
    JAX leaf order, its digest is the one the other package computes,
    and the streams equal JAX's unified paged engine's."""
    _, _, sched, jeng = _streams("paged", "mixed", models)
    teng = sched.engine
    jobs = [(p, 6) for p, _ in _mixed_jobs()[:4]]
    want = [r.output_tokens for r in _run(JScheduler(jeng), jobs, None)]
    j2t, j_payloads = _handoff_loop(JScheduler(jeng, role="prefill"),
                                    Scheduler(teng, role="decode"), jobs,
                                    Request)
    t2j, t_payloads = _handoff_loop(Scheduler(teng, role="prefill"),
                                    JScheduler(jeng, role="decode"), jobs,
                                    JRequest)
    assert j2t == want and t2j == want
    for p in t_payloads:
        assert len(p["layers"]) == 2 * TARGET["num_layers"]
        assert all(a.shape == (len(p["manifest"]), 2, BLOCK, 16)
                   for a in p["layers"])
        assert jpaged._handoff_digest(p["layers"], p["n_tokens"],
                                      BLOCK) == p["digest"]
    for p in j_payloads:
        assert tpaged._handoff_digest(p["layers"], p["n_tokens"],
                                      BLOCK) == p["digest"]
    by_len = {p["n_tokens"]: p["manifest"] for p in j_payloads}
    assert all(by_len[p["n_tokens"]] == p["manifest"] for p in t_payloads)
