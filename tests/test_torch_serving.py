"""paddle_tpu_torch.serving against paddle_tpu.serving.

The port's BlockPool, its Scheduler over PagedServingEngine and the
create_llm_predictor front door must give the JAX paged engine's greedy
streams token for token, with the same weights (load_jax_state), on 8
mixed-length requests over 4 slots — with multi-chunk prefills, prefix
sharing, and preemption under pool pressure. The sampling tail is held
to JAX's mask for mask, and, fed the same Gumbel noise, token for token.

Model: bench.py's CPU smoke size with initializer_range 0.2 (at the
default 0.02 random GPT streams repeat one token and compare nothing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.serving import PagedServingEngine as JEngine
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving.paged.block_pool import BlockPool as JBlockPool
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.serving import (BlockPool, BlockPoolExhausted,
                                      PagedServingEngine, Scheduler)
from paddle_tpu_torch.serving import engine as tengine

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB = 512
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)
ENGINE = dict(num_slots=4, max_len=64, block_size=8, prefill_chunk_len=16)


@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    jm = JGPT(JConfig(**SMALL))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _jobs(seed, n=8):
    """Mixed lengths: some prompts span 2-3 prefill chunks; the last two
    repeat a 20-token prefix (prefix-cache hits on full blocks)."""
    rng = np.random.RandomState(seed)
    jobs = [(rng.randint(0, VOCAB, (int(rng.randint(2, 40)),)).tolist(),
             int(rng.randint(2, 12))) for _ in range(n)]
    shared = rng.randint(0, VOCAB, (20,)).tolist()
    jobs[-2] = (shared + [1, 2], 6)
    jobs[-1] = (shared + [3], 5)
    return jobs


def _stream(sched, jobs):
    reqs = [sched.submit(prompt=p, max_tokens=m) for p, m in jobs]
    sched.run()
    return reqs


_JAX_STREAMS = {}


def _jax_stream(jm, seed, **kw):
    """JAX paged engine (lax kernel) streams, computed once per case."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _JAX_STREAMS:
        eng = JEngine(jm, paged_kernel="lax", **dict(ENGINE, **kw))
        _JAX_STREAMS[key] = [(r.output_tokens, r.finish_reason)
                             for r in _stream(JScheduler(eng), _jobs(seed))]
    return _JAX_STREAMS[key]


def _port_engine(tm, kernel="plain", **kw):
    return PagedServingEngine(tm, paged_kernel=kernel, device="cpu",
                              **dict(ENGINE, **kw))


# ---------------------------------------------------------------------------
# BlockPool
# ---------------------------------------------------------------------------

def test_block_pool_alloc_release_and_exhaustion():
    pool = BlockPool(6, 4)
    assert pool.usable == 5 and pool.used == 0
    a = pool.alloc(3)
    assert BlockPool.SCRATCH not in a and len(set(a)) == 3
    with pytest.raises(BlockPoolExhausted):
        pool.alloc(3)                      # all or none
    assert pool.used == 3
    pool.release(a)
    assert pool.used == 0 and pool.outstanding() == {}
    with pytest.raises(ValueError, match="double free"):
        pool.release([a[0]])
    with pytest.raises(ValueError):
        BlockPool(1, 4)


def test_block_pool_prefix_sharing_and_cow():
    pool = BlockPool(8, 4)
    toks = list(range(10))                 # two full blocks + a tail
    hashes = pool.prompt_hashes(toks)
    blocks = pool.alloc(3)
    for blk, h in zip(blocks, hashes):
        pool.register_hash(blk, h)
    shared, got = pool.match_prefix(toks[:8] + [99])
    assert shared == blocks[:2] and got == hashes
    assert pool.refcount(blocks[0]) == 2
    new = pool.cow(blocks[0])              # shared -> private copy
    assert new != blocks[0] and pool.refcount(blocks[0]) == 1
    assert pool.cow(new) == new            # exclusive -> itself
    pool.release(blocks)
    assert pool.refcount(blocks[0]) == 0 and pool.refcount(blocks[1]) == 1
    # a freed block keeps its hash: a later request revives it
    again, _ = pool.match_prefix(toks)
    assert again == blocks[:2] and pool.refcount(blocks[0]) == 1


def test_block_pool_matches_jax_pool_on_a_script():
    """The same operation script gives the same block ids and counters
    as the JAX package's BlockPool."""
    def script(pool):
        log = []
        a = pool.alloc(3)
        hs = pool.prompt_hashes(list(range(12)))
        for blk, h in zip(a, hs):
            pool.register_hash(blk, h)
        log.append(a)
        s, _ = pool.match_prefix(list(range(9)))
        pool.count_prefix(len(s), 2 - len(s))
        log.append(s)
        pool.release(a)
        log.append(pool.alloc(4))
        log.append(pool.match_prefix(list(range(12)))[0])
        log.append((pool.used, pool.prefix_hits, pool.prefix_misses))
        return log
    assert script(BlockPool(9, 4)) == script(JBlockPool(9, 4))


def test_block_pool_acquire_and_stats_match_jax_pool():
    """acquire() adds a reference to a live block and refuses a free
    one, as the JAX pool's does; stats() has the JAX pool's keys and
    values after the same allocations, acquires and releases."""
    def script(pool):
        log = []
        a = pool.alloc(3)
        for blk, h in zip(a, pool.prompt_hashes(list(range(12)))):
            pool.register_hash(blk, h)
        pool.acquire(a[0])
        pool.acquire(a[0])
        log.append([pool.refcount(b) for b in a])
        s, _ = pool.match_prefix(list(range(8)))
        pool.count_prefix(len(s), 0)
        pool.release(a)
        log.append(pool.stats())
        with pytest.raises(ValueError, match="not live"):
            pool.acquire(a[2])
        pool.release([a[0], a[0]] + s)
        log.append(pool.stats())
        return log
    got, want = script(BlockPool(9, 4)), script(JBlockPool(9, 4))
    assert got == want
    assert set(got[-1]) == {"used", "usable", "block_size",
                            "cached_hashes", "prefix_hits",
                            "prefix_misses"}


def test_request_tpot_matches_jax():
    """tpot: the mean gap between output tokens, None under two tokens,
    from the same token times as the JAX Request."""
    from paddle_tpu.serving import Request as JRequest
    from paddle_tpu_torch.serving import Request
    times = [10.0, 10.5, 11.25, 12.0]
    for cls in (Request, JRequest):
        req = cls(prompt=[1, 2], max_tokens=8)
        tpots = []
        for i, t in enumerate(times):
            if i:
                req.output_tokens.append(i)
                req.first_token_time = req.first_token_time or t
                req.last_token_time = t
            tpots.append(req.tpot)
        assert tpots == [None, None, 0.75, 0.75], cls
    req = Request(prompt=[1], max_tokens=2)
    req._emit(5)
    assert req.tpot is None
    req._emit(6)
    assert req.tpot == req.last_token_time - req.first_token_time


# ---------------------------------------------------------------------------
# streams against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["plain", "reference"])
def test_scheduler_stream_token_exact_vs_jax(models, kernel):
    jm, tm = models
    want = _jax_stream(jm, 1)
    eng = _port_engine(tm, kernel)
    got = [(r.output_tokens, r.finish_reason)
           for r in _stream(Scheduler(eng), _jobs(1))]
    assert got == want
    assert eng.block_pool.outstanding() == {}
    assert eng.block_pool.prefix_hits > 0


def test_front_door_token_exact_vs_jax(models):
    """inference.Config -> create_llm_predictor reaches the paged engine
    with the configured kernel and device, token-exact with JAX."""
    jm, tm = models
    cfg = inference.Config().enable_llm_engine(
        paged=True, num_slots=4, max_len=64, block_size=8, prefill_len=16,
        paged_kernel="plain", device="cpu")
    pred = inference.create_llm_predictor(cfg, model=tm)
    assert pred.engine.paged_kernel == "plain"
    got = [(r.output_tokens, r.finish_reason)
           for r in _stream(pred.scheduler, _jobs(1))]
    assert got == _jax_stream(jm, 1)
    snap = pred.metrics.snapshot()
    assert snap["requests_completed"] == 8
    assert snap["prefill_chunks"] == pred.engine.prefill_chunks_run
    assert snap["decode_waves"] == pred.engine.decode_waves_run
    assert snap["ttft_p50_s"] is not None and snap["tpot_p50_s"] is not None
    prompt = _jobs(2)[0][0]
    assert pred.generate(prompt, max_tokens=4) == \
        JScheduler(JEngine(jm, paged_kernel="lax", **ENGINE)).generate(
            prompt, max_tokens=4)


def test_preemption_under_pool_pressure_token_exact_vs_jax(models):
    """Four lanes that fill an 8-block pool at admission and then grow:
    starved lanes are preempted by recompute (requeued with prompt +
    output, re-prefilled) and the streams still equal JAX's."""
    jm, tm = models
    rng = np.random.RandomState(3)
    jobs = [(rng.randint(0, VOCAB, (10,)).tolist(), 30) for _ in range(4)]

    def run(sched):
        return [(r.output_tokens, r.finish_reason)
                for r in _stream(sched, jobs)]
    want = run(JScheduler(JEngine(jm, paged_kernel="lax", num_blocks=9,
                                  **ENGINE)))
    sched = Scheduler(_port_engine(tm, num_blocks=9))
    assert run(sched) == want
    assert all(reason == "max_tokens" for _, reason in want)
    assert sched.metrics.snapshot()["faults"].get("preempted", 0) > 0
    assert sched.engine.block_pool.outstanding() == {}


def test_scratch_poison_after_warmup(models):
    """NaN in the live pools' scratch block after warm-up: the stream is
    unchanged and no non-finite fault fires."""
    jm, tm = models
    eng = _port_engine(tm)
    Scheduler(eng).generate([1, 2, 3], max_tokens=2)      # warm-up
    for pk, pv in eng._caches:
        pk[0] = float("nan")
        pv[0] = float("nan")
    sched = Scheduler(eng)
    got = [(r.output_tokens, r.finish_reason)
           for r in _stream(sched, _jobs(1))]
    assert got == _jax_stream(jm, 1)
    assert sched.metrics.snapshot()["faults"] == {}


def test_nonfinite_lane_retires_alone(models):
    """A lane whose cache turns NaN resolves with "error"; the other
    lanes stream on exactly as in a clean run."""
    _, tm = models
    jobs = _jobs(4, n=3)
    clean = [r.output_tokens for r in _stream(Scheduler(_port_engine(tm)),
                                              jobs)]
    eng = _port_engine(tm)
    sched = Scheduler(eng)
    reqs = [sched.submit(prompt=p, max_tokens=m) for p, m in jobs]
    while reqs[0].slot is None or eng.slot_pos[reqs[0].slot] == 0:
        sched.step()
    for pk, pv in eng._caches:
        pv[eng._slot_blocks[reqs[0].slot][0]] = float("nan")
    sched.run()
    assert reqs[0].finish_reason == "error"
    assert [r.output_tokens for r in reqs[1:]] == clean[1:]
    assert sched.metrics.snapshot()["faults"] == {"nonfinite": 1}


# ---------------------------------------------------------------------------
# the sampling tail
# ---------------------------------------------------------------------------

_LOGITS = np.random.default_rng(9).standard_normal((5, 64)).astype(
    np.float32) * 3
_TOP_K = np.array([0, 1, 5, 0, 12], np.int32)
_TOP_P = np.array([1.0, 1.0, 1.0, 0.7, 0.9], np.float32)


def test_filter_top_k_top_p_matches_jax_mask_for_mask():
    want = np.asarray(jengine._filter_top_k_top_p(
        jnp.asarray(_LOGITS), jnp.asarray(_TOP_K), jnp.asarray(_TOP_P)))
    got = tengine._filter_top_k_top_p(torch.from_numpy(_LOGITS),
                                      torch.from_numpy(_TOP_K),
                                      torch.from_numpy(_TOP_P)).numpy()
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    np.testing.assert_array_equal(got, want)


def test_sampled_selection_matches_jax_with_the_same_gumbel():
    """jax.random.categorical is argmax(logits + gumbel(key)): handed the
    same Gumbel draw, the port's wave and first-token tails pick JAX's
    tokens, greedy lanes and inactive lanes included."""
    s, v = _LOGITS.shape
    key = jax.random.PRNGKey(4)
    gumbel = np.asarray(jax.random.gumbel(key, (s, v), jnp.float32))
    tok = np.arange(s, dtype=np.int32)
    pos = np.full((s,), 7, np.int32)
    active = np.array([True, True, True, False, True])
    sample = np.array([True, False, True, True, True])
    temps = np.array([0.7, 1.0, 1.3, 1.0, 0.5], np.float32)
    bias = np.zeros((s, v), np.float32)
    bias[2, 3] = 5.0
    j_nxt, j_pos, j_fin = jengine._select_wave_tokens(
        jnp.asarray(_LOGITS), jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(sample), jnp.asarray(temps),
        jnp.asarray(_TOP_K), jnp.asarray(_TOP_P), jnp.asarray(bias),
        jnp.zeros((s,), bool), key)
    t_nxt, t_pos, t_fin = tengine._select_wave_tokens(
        torch.from_numpy(_LOGITS), torch.from_numpy(tok).long(),
        torch.from_numpy(pos).long(), torch.from_numpy(active),
        torch.from_numpy(sample), torch.from_numpy(temps),
        torch.from_numpy(_TOP_K), torch.from_numpy(_TOP_P),
        torch.from_numpy(bias), torch.tensor(gumbel))
    np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(j_nxt))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(t_fin.numpy(), np.asarray(j_fin))

    k1 = jax.random.PRNGKey(8)
    g1 = np.asarray(jax.random.gumbel(k1, (v,), jnp.float32))
    for row in range(s):
        want = jengine._select_first_token(
            jnp.asarray(_LOGITS[row]), jnp.asarray(True),
            jnp.float32(temps[row]), jnp.int32(_TOP_K[row]),
            jnp.float32(_TOP_P[row]), jnp.asarray(bias[row]), k1)
        got = tengine._select_first_token(
            torch.from_numpy(_LOGITS[row]), True, temps[row], _TOP_K[row],
            _TOP_P[row], torch.from_numpy(bias[row]), torch.tensor(g1))
        assert int(got) == int(want), row


def test_sampled_streams_replay_from_the_seed(models):
    """Sampling draws from the engine's own seeded generator: a fresh
    engine with the same seed replays the sampled streams."""
    _, tm = models
    jobs = _jobs(6, n=4)

    def run():
        sched = Scheduler(_port_engine(tm, seed=7))
        reqs = [sched.submit(prompt=p, max_tokens=m, do_sample=True,
                             temperature=0.8, top_k=20)
                for p, m in jobs]
        sched.run()
        return [r.output_tokens for r in reqs]
    assert run() == run()
