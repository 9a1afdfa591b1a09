"""Speculative decoding in the port (paddle_tpu_torch) against the JAX
package: the batched verify scatter, GPT `decode_chunk`, the acceptance
tail `_spec_verify_tail`, and `SpeculativePagedEngine` under the
Scheduler and through the inference front door.

Target: vocab 128, 2 layers, hidden 128, 2 heads (head_dim 64), with
initializer_range 0.2 — at the default 0.02 a random GPT this small
repeats one token (JAX's own speculative engine gives [67] * 8) and
would hide a wrong acceptance; every stream test asserts a stream of at
least three distinct tokens. Both packages are built from the same numpy
weights through `load_jax_state`. Three drafts of 1 layer:
  * `draft` — the target's embeddings, first block and final norm
    (partial acceptance: accepted and rejected spans in one stream);
  * `bad_draft` — a separately seeded draft with one embedding row
    inflated, so its argmax pins to a token the target rejects
    (acceptance ~0: every wave emits the target's correction);
  * the target as its own draft (acceptance 1: the bonus token).

Tolerances: logits and pools within atol 1e-5 (f32, different
summation orders); tokens, counts and block lists exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nn import paged_attention as jpa
from paddle_tpu.nn import transformer as jtr
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import SpeculativePagedEngine as JSpec
from paddle_tpu.serving.paged.engine import \
    _spec_verify_tail as jax_tail
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.nn import paged_attention as tpa
from paddle_tpu_torch.nn import transformer as ttr
from paddle_tpu_torch.serving import (PagedServingEngine, Scheduler,
                                      SpeculativePagedEngine)
from paddle_tpu_torch.serving.paged.engine import \
    _spec_verify_tail as port_tail

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ATOL = 1e-5
VOCAB = 128
TARGET = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=64, dropout=0.0, attn_dropout=0.0,
              initializer_range=0.2)
DRAFT = dict(TARGET, num_layers=1)
MAX_LEN, BLOCK, CHUNK, SPEC_K = 64, 8, 16, 3
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


def _state(cfg, seed):
    pt.seed(seed)
    return {k: v.numpy() for k, v in JGPT(JConfig(**cfg)).state_dict()
            .items()}


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET, _state(TARGET, 5))


@pytest.fixture(scope="module")
def draft(target):
    full = {k: v.numpy() for k, v in target[0].state_dict().items()}
    return _pair(DRAFT, {k: v for k, v in full.items()
                         if ".blocks.1." not in k})


@pytest.fixture(scope="module")
def bad_draft():
    state = _state(DRAFT, 24)
    w = state["gpt.embeddings.word_embeddings.weight"].copy()
    w[VOCAB - 1] += 5.0             # tied head: logits[V - 1] balloon
    state["gpt.embeddings.word_embeddings.weight"] = w
    return _pair(DRAFT, state)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _prompt(seed, n=5):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).tolist()


def _run(sched, jobs, **kw):
    reqs = [sched.submit(prompt=p, max_tokens=m, **kw) for p, m in jobs]
    sched.run()
    return reqs


def _port_spec(tm, dm, **kw):
    return SpeculativePagedEngine(tm, dm, spec_k=SPEC_K, device="cpu",
                                  **dict(ENGINE, **kw))


def _port_paged(tm, **kw):
    return PagedServingEngine(tm, device="cpu", **dict(ENGINE, **kw))


def _jax_spec(jm, jd, **kw):
    return JSpec(jm, jd, spec_k=SPEC_K, paged_kernel="lax",
                 **dict(ENGINE, **kw))


# ---------------------------------------------------------------------------
# the verify scatter and GPT decode_chunk
# ---------------------------------------------------------------------------

def test_scatter_block_kv_chunk_batched_matches_jax():
    """Four lanes of a C = 5 chunk: a full span, a span clamped by
    valid_len, a lane at valid_len 0 (all to scratch) and a span that
    runs past the table (its clamped tail goes to scratch)."""
    rng = np.random.default_rng(0)
    nb, hkv, bs, d, c = 12, 2, 4, 8, 5
    pool = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    kv = rng.standard_normal((4, hkv, c, d)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 0], [8, 9, 10]],
                      np.int32)
    start = np.array([2, 5, 1, 9], np.int32)
    valid = np.array([5, 2, 0, 3], np.int32)
    want = jtr.scatter_block_kv_chunk_batched(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(start), jnp.asarray(valid))
    got = torch.from_numpy(pool.copy())
    out = ttr.scatter_block_kv_chunk_batched(
        got, torch.from_numpy(kv), torch.from_numpy(tables),
        torch.from_numpy(start).long(), torch.from_numpy(valid).long())
    assert out is got                      # in place
    # block 0 takes the colliding scratch writes: garbage by design
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    # the last lane's positions 12, 13 (past its 3-block table) wrote
    # nothing live, and lane 2 wrote nothing at all
    np.testing.assert_array_equal(got.numpy()[[6, 7]], pool[[6, 7]])
    assert not np.array_equal(got.numpy()[10], pool[10])


@pytest.mark.parametrize("kernel", ["plain", "reference"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_chunk_logits_match_jax(target, kernel, window):
    """Three lanes prefilled by chunks, then one decode_chunk at C = 4
    with per-lane starts and valid lengths 4, 2 and 0 (a lane outside
    the wave on an all-scratch table): the [S, C, V] logits and the
    written pools equal JAX's within 1e-5."""
    state = {k: v.numpy() for k, v in target[0].state_dict().items()}
    cfg = dict(TARGET, attn_window=window)
    jm, tm = _pair(cfg, state) if window else target
    rng = np.random.default_rng(3)
    nb = 13
    jc = jm.init_paged_cache(nb, BLOCK, MAX_LEN)
    tc = tm.init_paged_cache(nb, BLOCK, MAX_LEN)
    tables = np.array([[1, 2, 3, 0, 0, 0, 0, 0],
                       [4, 5, 6, 0, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    for lane, n in ((0, 14), (1, 9)):
        toks = rng.integers(0, VOCAB, (1, 16)).astype(np.int32)
        table = tables[lane:lane + 1]
        with jpa.kernel_scope("lax"):
            _, jc = jm.prefill_chunk(Tensor(jnp.asarray(toks)), jc,
                                     jnp.asarray(table), jnp.int32(0),
                                     jnp.int32(n))
        tm.prefill_chunk(torch.from_numpy(toks).long(), tc,
                         torch.from_numpy(table), 0, n)
    chunk = rng.integers(0, VOCAB, (3, 4)).astype(np.int32)
    start = np.array([14, 9, MAX_LEN], np.int32)
    valid = np.array([4, 2, 0], np.int32)
    with jpa.kernel_scope("lax"):
        jl, jc = jm.decode_chunk(Tensor(jnp.asarray(chunk)), jc,
                                 jnp.asarray(tables), jnp.asarray(start),
                                 jnp.asarray(valid))
    with tpa.kernel_scope(kernel):
        tl, tc = tm.decode_chunk(torch.from_numpy(chunk).long(), tc,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(start).long(),
                                 torch.from_numpy(valid).long())
    assert tl.shape == (3, 4, VOCAB)
    # the parked lane attends scratch garbage; the two live lanes agree
    np.testing.assert_allclose(tl.float().numpy()[:2], _np(jl)[:2],
                               atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:],
                                   atol=ATOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:],
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the acceptance tail
# ---------------------------------------------------------------------------

def _tail_inputs(seed, sample):
    """Six lanes, k = 3, V = 32: draft tokens drawn from draft
    distributions near the target's (so spans are accepted and
    rejected), spec_len 3, 2, 0, 3, 1, 3, lane 4 inactive and lane 5's
    logits NaN."""
    rng = np.random.default_rng(seed)
    s, k, v = 6, 3, 32
    lo = (rng.standard_normal((s, k + 1, v)) * 2).astype(np.float32)
    near = lo[:, :k] + rng.standard_normal((s, k, v)).astype(np.float32)
    probs = np.exp(near - near.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    toks = np.stack([[rng.choice(v, p=probs[i, j] / probs[i, j].sum())
                      for j in range(k)] for i in range(s)]).astype(np.int32)
    # greedy lanes: the target's own argmax up to a mismatch
    toks[0] = lo[0, :k].argmax(-1)
    toks[1, 0] = lo[1, 0].argmax()
    lo[5, 2, 7] = np.nan
    bias = np.zeros((s, v), np.float32)
    bias[3, 5] = -1e9
    return dict(
        lo=lo, tok=rng.integers(0, v, s).astype(np.int32),
        pos=rng.integers(4, 20, s).astype(np.int32),
        active=np.array([1, 1, 1, 1, 0, 1], bool),
        sample=np.full(s, sample, bool) if sample in (True, False)
        else np.array(sample, bool),
        temps=np.array([1.0, 0.7, 1.3, 1.0, 1.0, 1.0], np.float32),
        top_k=np.array([0, 5, 0, 8, 0, 0], np.int32),
        top_p=np.array([1.0, 1.0, 0.8, 0.9, 1.0, 1.0], np.float32),
        bias=bias, spec_len=np.array([3, 2, 0, 3, 1, 3], np.int32),
        draft_toks=toks, draft_probs=probs)


def _both_tails(inp, key, noise):
    want = jax_tail(*(jnp.asarray(inp[n]) for n in (
        "lo", "tok", "pos", "active", "sample", "temps", "top_k", "top_p",
        "bias", "spec_len", "draft_toks", "draft_probs")),
        jnp.zeros(inp["tok"].shape, bool), key)
    t = {n: torch.from_numpy(np.asarray(a)) for n, a in inp.items()}
    for n in ("tok", "pos", "top_k", "spec_len", "draft_toks"):
        t[n] = t[n].long()
    got = port_tail(t["lo"], t["tok"], t["pos"], t["active"], t["sample"],
                    t["temps"], t["top_k"], t["top_p"], t["bias"],
                    t["spec_len"], t["draft_toks"], t["draft_probs"], noise)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_verify_tail_greedy_matches_jax():
    inp = _tail_inputs(1, False)
    want, got = _both_tails(inp, jax.random.PRNGKey(0), None)
    for name, w, g in zip(("out", "n_emit", "nxt", "new_pos", "finite"),
                          want, got):
        if name == "out":          # only the emitted prefix is defined
            for s, n in enumerate(want[1]):
                np.testing.assert_array_equal(g[s, :n], w[s, :n])
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # lane 0 accepted its whole span plus the bonus; lane 2 (spec_len 0)
    # is a plain decode; lanes 4 (inactive) and 5 (NaN) froze
    assert list(want[1]) == [4, *want[1][1:2], 1, *want[1][3:4], 0, 0]
    assert not want[4][5] and want[3][5] == inp["pos"][5]


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_verify_tail_sampled_matches_jax_with_its_draws(seed):
    """Sampled lanes (and a greedy one among them): fed the uniforms and
    the Gumbel rows that JAX's key splits give (`jax.random.categorical`
    is argmax(logits + gumbel)), the port picks JAX's tokens."""
    inp = _tail_inputs(seed, [1, 1, 1, 0, 1, 1])
    key = jax.random.PRNGKey(seed)
    key_u, key_r, key_f = jax.random.split(key, 3)
    s, k, v = inp["draft_probs"].shape
    noise = tuple(torch.from_numpy(np.array(x)) for x in (
        jax.random.uniform(key_u, (s, k)), jax.random.gumbel(key_r, (s, v)),
        jax.random.gumbel(key_f, (s, v))))
    want, got = _both_tails(inp, key, noise)
    np.testing.assert_array_equal(got[1], want[1])
    for s_, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][s_, :n], want[0][s_, :n])
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(g, w)


def test_truncated_lane_resamples_from_target_distribution():
    """A sampled lane at spec_len 0 must draw from p_t itself, not from
    the residual against a draft distribution it never offered: with p_d
    all on token 0 and p_t(0) ~ 0.6, the faulty residual could never
    emit 0. Over 4000 lanes the share of 0 lies within 4 sigma of its
    probability (a binomial bound; noise from a seeded generator)."""
    s, k, v = 4000, 2, 8
    lo = torch.full((s, k + 1, v), -30.0)
    lo[:, :, 0] = 0.0
    lo[:, :, 1] = -0.405
    p0 = float(torch.softmax(lo[0, 0], dim=-1)[0])
    probs = torch.zeros((s, k, v))
    probs[:, :, 0] = 1.0
    gen = torch.Generator().manual_seed(0)
    noise = (torch.rand((s, k), generator=gen),
             *(-torch.log(-torch.log(torch.rand((s, v), generator=gen))))
             .unsqueeze(0).expand(2, s, v))
    _, n_emit, nxt, _, _ = port_tail(
        lo, torch.zeros(s, dtype=torch.long), torch.zeros(s, dtype=torch.long),
        torch.ones(s, dtype=torch.bool), torch.ones(s, dtype=torch.bool),
        torch.ones(s), torch.zeros(s, dtype=torch.long), torch.ones(s),
        torch.zeros((s, v)), torch.zeros(s, dtype=torch.long),
        torch.zeros((s, k), dtype=torch.long), probs, noise)
    assert bool((n_emit == 1).all())
    frac0 = float((nxt == 0).float().mean())
    sigma = (p0 * (1 - p0) / s) ** 0.5
    assert abs(frac0 - p0) < 4 * sigma, (frac0, p0)


# ---------------------------------------------------------------------------
# the engine: greedy streams against JAX's spec engine and the paged one
# ---------------------------------------------------------------------------

def _mixed_jobs():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, VOCAB, (int(rng.randint(2, 14)),)).tolist(),
             int(rng.randint(2, 10))) for _ in range(12)]


def _preempt_jobs():
    rng = np.random.RandomState(6)
    return [(rng.randint(0, VOCAB, (14,)).tolist(), 12) for _ in range(4)]


# scenario -> (draft fixture, engine overrides, jobs, submit knobs)
SCENARIOS = {
    "single": ("draft", {}, lambda: [(_prompt(0), 8)], {}),
    "single_self_draft": ("self", {}, lambda: [(_prompt(3), 8)], {}),
    "mixed_multiwave_eos": ("draft", {}, _mixed_jobs, {"eos": True}),
    "chunked_prefill_interleave": (
        "draft", {}, lambda: [(_prompt(30 + i), 10) for i in range(3)]
        + [(np.random.RandomState(4).randint(0, VOCAB, (2 * CHUNK + 5,))
            .tolist(), 5)], {}),
    "rejection_heavy": ("bad", {}, lambda: [(_prompt(40 + i, n=4 + i), 6)
                                            for i in range(4)], {}),
    "horizon": ("draft", {"max_len": 32},
                lambda: [(_prompt(110, n=5), 1000),
                         (_prompt(111, n=5), 1000)], {}),
    "preemption": ("draft", {"num_blocks": 9}, _preempt_jobs, {}),
}
_STREAMS = {}


def _models(name, target, draft, bad_draft):
    kind = SCENARIOS[name][0]
    return {"draft": draft, "bad": bad_draft, "self": target}[kind]


def _eos(target, jobs):
    """The second token of the first job's plain stream: an eos that
    lands inside a speculative batch."""
    probe = Scheduler(_port_paged(target[1])).generate(jobs[0][0],
                                                       max_tokens=4)
    return probe[1]


def _streams(name, target, draft, bad_draft):
    """(JAX spec, port spec, port paged) requests and schedulers for a
    scenario, computed once."""
    if name not in _STREAMS:
        _, over, make_jobs, knobs = SCENARIOS[name]
        jobs = make_jobs()
        kw = {}
        if knobs.get("eos"):
            kw["eos_token_id"] = _eos(target, jobs)
        jd, td = _models(name, target, draft, bad_draft)
        out = []
        for sched in (JScheduler(_jax_spec(target[0], jd, **over)),
                      Scheduler(_port_spec(target[1], td, **over)),
                      Scheduler(_port_paged(target[1], **over))):
            out.append((sched, _run(sched, jobs, **kw)))
        _STREAMS[name] = out
    return _STREAMS[name]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_greedy_streams_equal_jax_spec_and_paged(name, target, draft,
                                                 bad_draft):
    (js, jr), (ts, tr), (ps, pr) = _streams(name, target, draft, bad_draft)
    want = [(r.output_tokens, r.finish_reason) for r in jr]
    assert [(r.output_tokens, r.finish_reason) for r in tr] == want
    assert [(r.output_tokens, r.finish_reason) for r in pr] == want
    assert max(len(set(r.output_tokens)) for r in tr) >= 3, \
        "every stream repeats one or two tokens: the weights compare nothing"
    eng = ts.engine
    assert eng.block_pool.used == 0
    assert (eng.decode_compiles, eng.prefill_compiles,
            eng.draft_compiles) == (0, 0, 0)      # the CPU runs eagerly
    snap = ts.metrics.snapshot()
    if name == "rejection_heavy":
        assert snap["spec_tokens_proposed"] > 0
        assert snap["spec_tokens_accepted"] < snap["spec_tokens_proposed"]
        assert snap["spec_acceptance_rate"] < 0.2
    if name == "single_self_draft":
        assert snap["spec_acceptance_rate"] == 1.0
        # a batch's tokens arrive together: gaps of 0, never below
        assert snap["tpot_p50_s"] == 0.0
    if name == "horizon":
        assert all(r.finish_reason == "length" for r in tr)
    if name == "preemption":
        assert sum(r.preemptions for r in tr) >= 1
        assert all(r.finish_reason == "max_tokens" for r in tr)
    if name == "mixed_multiwave_eos":
        assert "eos" in {r.finish_reason for r in tr}
        assert 0 < snap["spec_acceptance_rate"] < 1


@pytest.mark.parametrize("name", ["mixed_multiwave_eos", "rejection_heavy",
                                  "preemption", "single_self_draft"])
def test_spec_counts_equal_jax(name, target, draft, bad_draft):
    """on_spec: proposed, accepted, rate and accepted per wave equal the
    JAX scheduler's under greedy."""
    (js, _), (ts, _), _ = _streams(name, target, draft, bad_draft)
    keys = ("spec_tokens_proposed", "spec_tokens_accepted",
            "spec_acceptance_rate", "spec_accepted_per_wave",
            "tokens_generated", "slot_occupancy")
    want, got = js.metrics.snapshot(), ts.metrics.snapshot()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("drafter", ["draft", "bad"])
def test_pool_holds_only_committed_blocks_after_every_wave(
        target, draft, bad_draft, drafter):
    """After every scheduling round each active lane holds exactly the
    blocks of its committed positions [0, pos), and the pool counts no
    other block than the slots'."""
    dm = {"draft": draft, "bad": bad_draft}[drafter][1]
    eng = _port_spec(target[1], dm)
    sched = Scheduler(eng)
    for i in range(6):
        sched.submit(prompt=_prompt(80 + i, n=3 + 5 * i), max_tokens=12)
    rounds = 0
    while sched.step():
        rounds += 1
        held = set()
        for s in range(eng.num_slots):
            blocks = eng._slot_blocks[s]
            held.update(blocks)
            if eng.slot_active[s]:
                assert len(blocks) == -(-eng.slot_pos[s] // BLOCK), \
                    (s, eng.slot_pos[s], blocks)
                assert list(eng._tables[s, :len(blocks)]) == blocks
                assert not eng._tables[s, len(blocks):].any()
        assert eng.block_pool.used == len(held)
    assert rounds > 3 and eng.block_pool.used == 0


def test_writes_past_the_span_go_to_scratch(target, draft):
    """A lane two positions short of the horizon drafts spec_len = 1: the
    draft's later steps (positions 31, 32 at max_len 32) and the verify's
    clamped tail must write the scratch block, never the lane's blocks —
    position 32 clamps to the table's last column, whose first row holds
    the committed position 24."""
    eng = _port_spec(target[1], draft[1], max_len=32)
    eng.begin_prefill(0, _prompt(12, n=29))
    while eng.prefill_step(0) is None:
        pass
    assert eng.slot_pos[0] == 29
    blk = int(eng._tables[0, 3])           # positions 24..31
    before = [(k[blk].clone(), v[blk].clone()) for k, v in eng._pools()]
    out = eng.decode_wave()
    assert eng.last_spec_proposed == 2     # min(k, max_len - 1 - pos)
    assert 1 <= len(out[0]) <= 3
    for (k, v), (k0, v0) in zip(eng._pools(), before):
        # rows 0..4 (positions 24..28) were written by the prefill and
        # must be untouched; rows 5..7 are the wave's own span
        assert torch.equal(k[blk, :, :5], k0[:, :5])
        assert torch.equal(v[blk, :, :5], v0[:, :5])


def test_three_programs_each_run_once_per_wave(target, draft):
    """Three programs with their own names: a wave runs the draft wave
    and the verify once each, a prefill chunk the spec chunk once."""
    eng = _port_spec(target[1], draft[1])
    progs = {"draft": eng.draft_program, "verify": eng.wave_program,
             "prefill": eng.prefill_program}
    assert len({p.name for p in progs.values()}) == 3
    calls = dict.fromkeys(progs, 0)
    for key, prog in progs.items():
        def counted(sampled, fn=prog._fn, key=key):
            calls[key] += 1
            return fn(sampled)
        prog._fn = counted
    sched = Scheduler(eng)
    req = sched.submit(prompt=_prompt(9, n=2 * CHUNK + 3), max_tokens=7)
    sched.run()
    assert req.finish_reason == "max_tokens"
    assert calls["draft"] == calls["verify"] == eng.decode_waves_run > 0
    assert calls["prefill"] == eng.prefill_chunks_run == 3
    assert eng.describe()["engine"] == "spec_paged"
    assert eng.describe()["spec_k"] == SPEC_K
    assert eng.last_wave_logits.shape == (4, SPEC_K + 1, VOCAB)


def test_sampling_top_k_1_equals_greedy_and_seed_replays(target, draft):
    """top_k = 1 collapses sampling to the argmax, through the draft's
    and the tail's sampled paths; sampled streams replay from the seed
    and stay in the vocabulary; a logit bias forbidding the greedy token
    changes the stream identically on the paged engine."""
    tm, dm = target[1], draft[1]
    prompt = _prompt(100)
    want = Scheduler(_port_paged(tm)).generate(prompt, max_tokens=8)
    got = Scheduler(_port_spec(tm, dm)).generate(
        prompt, max_tokens=8, do_sample=True, temperature=1.7, top_k=1)
    assert got == want
    runs = [Scheduler(_port_spec(tm, dm, seed=4)).generate(
        prompt, max_tokens=8, do_sample=True, top_p=0.9) for _ in range(2)]
    assert runs[0] == runs[1] and all(0 <= t < VOCAB for t in runs[0])
    bias = {want[0]: -1e9}
    biased = Scheduler(_port_spec(tm, dm)).generate(prompt, max_tokens=6,
                                                    logit_bias=bias)
    assert biased == Scheduler(_port_paged(tm)).generate(
        prompt, max_tokens=6, logit_bias=bias)
    assert want[0] not in biased


def test_front_door_speculative(target, draft):
    """Config(speculative=True, k=3) with draft_model=, and with
    draft_config= (a draft built on the target's device and dtype):
    both serve the paged engine's greedy stream."""
    tm, dm = target[1], draft[1]
    prompt = _prompt(107)
    want = Scheduler(_port_paged(tm, num_slots=2)).generate(prompt,
                                                            max_tokens=6)
    cfg = inference.Config().enable_llm_engine(
        speculative=True, k=3, num_slots=2, max_len=MAX_LEN,
        prefill_len=CHUNK, block_size=BLOCK, device="cpu")
    pred = inference.create_llm_predictor(cfg, model=tm, draft_model=dm)
    assert isinstance(pred.engine, SpeculativePagedEngine)
    assert pred.engine.spec_k == 3 and pred.engine.draft_model is dm
    assert pred.generate(prompt, max_tokens=6) == want
    cfg = inference.Config().enable_llm_engine(
        speculative=True, k=2, draft_config=tgpt.GPTConfig(**DRAFT),
        num_slots=2, max_len=MAX_LEN, prefill_len=CHUNK, block_size=BLOCK,
        device="cpu")
    pred = inference.create_llm_predictor(cfg, model=tm)
    built = pred.engine.draft_model
    assert built.cfg.num_layers == 1 and built.device == tm.device
    assert built.parameters()[0].dtype == torch.float32
    assert pred.generate(prompt, max_tokens=6) == want
    with pytest.raises(ValueError, match="draft"):
        inference.create_llm_predictor(
            inference.Config().enable_llm_engine(speculative=True,
                                                 device="cpu"), model=tm)
