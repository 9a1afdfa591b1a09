"""The Scheduler's fault, drain, token-mask, priority and QoS policy in
the port (paddle_tpu_torch) against the JAX package's: the same requests
through both packages' schedulers give the same finish reasons, streams
and counters.

Model: the speculative tests' target (vocab 128, 2 layers, hidden 128,
2 heads, initializer_range 0.2; both packages hold the same numpy
weights) and its 1-layer draft. Paged engines: 4 slots, horizon 64,
blocks of 8, chunks of 16; dense: a 32-token bucket. One engine of
each kind and package serves the whole module (JAX compiles its
programs once per engine), and every test drives the JAX engine and the
port's through the same steps, so the two keep the same history
(prefix cache included); a test that drives one package alone builds
its own engine. A decode-wave fault is injected in the port by wrapping
the engine's wave program (it raises before the program runs) and in
JAX by its chaos hook, which fires at the same point of `decode_wave`.

Tolerances: tokens, finish reasons and counters exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.serving import PagedServingEngine as JPaged
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JDense
from paddle_tpu.serving import SpeculativePagedEngine as JSpec
from paddle_tpu.utils import chaos
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.serving import (HEALTH_STATES, PagedServingEngine,
                                      Request, RequestState, Scheduler,
                                      ServingEngine, SpeculativePagedEngine)
from paddle_tpu_torch.serving.metrics import PHASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB = 128
TARGET = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=64, dropout=0.0, attn_dropout=0.0,
              initializer_range=0.2)
DRAFT = dict(TARGET, num_layers=1)
MAX_LEN, BLOCK, CHUNK, SPEC_K = 64, 8, 16, 2
PAGED = dict(num_slots=4, max_len=MAX_LEN, block_size=BLOCK, num_blocks=33,
             prefill_chunk_len=CHUNK)
DENSE = dict(num_slots=4, max_len=MAX_LEN, prefill_len=32)


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


def _engines(kind, models):
    """A new (JAX engine, port engine) pair of a kind: dense, paged or
    spec."""
    (jm, tm), (jd, td) = models
    if kind == "dense":
        return JDense(jm, **DENSE), ServingEngine(tm, device="cpu", **DENSE)
    if kind == "paged":
        return (JPaged(jm, paged_kernel="lax", **PAGED),
                PagedServingEngine(tm, device="cpu", **PAGED))
    return (JSpec(jm, jd, spec_k=SPEC_K, paged_kernel="lax", **PAGED),
            SpeculativePagedEngine(tm, td, spec_k=SPEC_K, device="cpu",
                                   **PAGED))


@pytest.fixture(scope="module")
def shared(models):
    """The module's engine pairs, built once per kind when first asked
    for."""
    def get(kind):
        if kind not in get.pairs:
            get.pairs[kind] = _engines(kind, models)
        return get.pairs[kind]
    get.pairs = {}
    return get


@pytest.fixture(autouse=True)
def _reset_shared(shared):
    """After each test: every shared engine's slots free and its health
    "ok" again (a degraded or evacuated scheduler leaves them)."""
    yield
    for pair in shared.pairs.values():
        for eng in pair:
            for slot in range(eng.num_slots):
                eng.retire_slot(slot)
            eng.set_health_state("ok")


def _port_paged(models):
    """A new port paged engine, for a test that drives the port alone."""
    return PagedServingEngine(models[0][1], device="cpu", **PAGED)


def _prompt(seed, n=5):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).tolist()


def _outcome(reqs):
    return [(r.output_tokens, r.finish_reason) for r in reqs]


class _FaultyWave:
    """An engine's wave program that raises on its `fail_at` calls
    (1-based), before the program runs: nothing on the device moves and
    the generator is untouched, as with the JAX chaos hook."""

    def __init__(self, program, fail_at):
        self._program, self._fail_at, self.calls = program, fail_at, 0

    def __call__(self, key):
        self.calls += 1
        if self._fail_at(self.calls):
            raise RuntimeError("injected wave fault")
        return self._program(key)

    def __getattr__(self, name):
        return getattr(self._program, name)


# ---------------------------------------------------------------------------
# drain, shutdown, the front door's close() and health()
# ---------------------------------------------------------------------------

def test_drain_then_run_matches_jax(shared):
    """drain() mid-stream: in-flight AND queued requests complete, a new
    submit is shed "rejected" (ValueError), health reads "draining"."""
    got = []
    for eng, sched_cls, req_cls in zip(shared("paged"),
                                       (JScheduler, Scheduler),
                                       (JRequest, Request)):
        sched = sched_cls(eng)
        reqs = [sched.submit(prompt=_prompt(40 + i), max_tokens=4)
                for i in range(6)]              # 4 slots + 2 queued
        sched.step()
        assert (sched.in_flight(), sched.queue_depth()) == (4, 2)
        sched.drain()
        assert sched.draining and eng.health_state == "draining"
        assert eng._health()["status"] == "draining"
        late = req_cls(prompt=_prompt(50), max_tokens=2)
        with pytest.raises(ValueError, match="draining"):
            sched.submit(request=late)
        assert late.finish_reason == "rejected"
        sched.run()
        assert all(r.state == RequestState.DONE for r in reqs)
        got.append((_outcome(reqs), sched.metrics.snapshot()["rejected"]))
    assert got[0] == got[1]
    assert got[1][0][0][1] == "max_tokens" and got[1][1] == 1


def test_shutdown_and_predictor_close_match_jax(models, shared):
    """shutdown() drains and runs the loop dry; the port predictor's
    close() does the same (its streams the JAX scheduler's), after which
    a submit is shed and health() reads "draining"."""
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        sched = sched_cls(eng)
        reqs = [sched.submit(prompt=_prompt(60 + i), max_tokens=3)
                for i in range(5)]
        assert sched.shutdown() > 0 and sched.draining
        got.append(_outcome(reqs))
    cfg = inference.Config()
    cfg.enable_llm_engine(paged=True, num_slots=4, max_len=MAX_LEN,
                          block_size=BLOCK, prefill_len=CHUNK, device="cpu")
    pred = inference.create_llm_predictor(cfg, model=models[0][1])
    reqs = [pred.submit(prompt=_prompt(60 + i), max_tokens=3)
            for i in range(5)]
    pred.close()
    with pytest.raises(ValueError, match="draining"):
        pred.submit(prompt=_prompt(80), max_tokens=2)
    got.append(_outcome(reqs))
    assert got[0] == got[1] == got[2]
    assert all(r == "max_tokens" for _, r in got[2])
    health = pred.health()
    assert health["status"] == "draining" and health["queue_depth"] == 0
    assert health["cache_blocks_used"] == 0


def test_health_payload_keys_match_jax(shared):
    assert HEALTH_STATES == ("ok", "degraded", "draining")
    for kind in ("dense", "paged", "spec"):
        j, t = shared(kind)
        assert set(t.health()) == set(j._health()), kind
        assert t.health()["status"] == "ok"
        with pytest.raises(ValueError):
            t.set_health_state("wedged")


# ---------------------------------------------------------------------------
# faults: the prefill streak, wave retries, degradation, evacuation
# ---------------------------------------------------------------------------

def test_prefill_fault_streak_escalates_to_degraded_like_jax(shared,
                                                             monkeypatch):
    """A prefill failing for every request is the engine's fault: after
    `prefill_fail_limit` consecutive failures the scheduler degrades
    (the staged request fails, the queued one is shed)."""
    def boom(*a, **k):
        raise RuntimeError("device wedged")
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("dense")):
        monkeypatch.setattr(eng, "prefill_slot", boom)
        sched = sched_cls(eng, prefill_fail_limit=3)
        reqs = [sched.submit(prompt=_prompt(60 + i), max_tokens=2)
                for i in range(5)]
        sched.run()
        assert sched.degraded and eng.health_state == "degraded"
        with pytest.raises(ValueError, match="degraded"):
            sched.submit(prompt=_prompt(70), max_tokens=2)
        assert eng.free_slots() == list(range(eng.num_slots))
        snap = sched.metrics.snapshot()
        got.append(([r.finish_reason for r in reqs], snap["faults"],
                     snap["rejected"]))
    assert got[0] == got[1]
    assert got[1][0] == ["error"] * 4 + ["rejected"]
    assert got[1][1] == {"prefill_error": 3, "degraded": 1}


def _wave_fault_run(sched_cls, eng, fail_at=None, wave_retries=3,
                    **knobs):
    """Six requests through a scheduler over `eng`, with its decode wave
    raising on the `fail_at` calls (the port: a wrapped wave program;
    JAX: the chaos hook), or with no fault."""
    sched = sched_cls(eng, wave_retries=wave_retries, retry_backoff_s=0.0)
    reqs = [sched.submit(prompt=_prompt(90 + i, n=3 + 3 * i), max_tokens=5,
                         **knobs) for i in range(6)]
    if fail_at is None:
        sched.run()
    elif sched_cls is JScheduler:
        fault = chaos.Fault(chaos.DECODE_WAVE, action="raise",
                            **fail_at["chaos"])
        with chaos.active(chaos.ChaosMonkey([fault])):
            sched.run()
    else:
        program = eng.wave_program
        eng.wave_program = _FaultyWave(program, fail_at["port"])
        try:
            sched.run()
        finally:
            eng.wave_program = program
    return reqs, sched


ONCE = {"chaos": {"times": (3,)}, "port": lambda n: n == 3}


def test_one_wave_fault_is_retried_and_replays_exactly(models, shared):
    """One raising wave: retried once, and the streams equal the
    unfaulted ones in both packages; the port's sampled stream with one
    seed too (the generator moves only inside the program)."""
    pair = list(zip((JScheduler, Scheduler), shared("paged")))
    want = [_outcome(_wave_fault_run(*p)[0]) for p in pair]
    assert want[0] == want[1]
    for p in pair:
        reqs, sched = _wave_fault_run(*p, fail_at=ONCE)
        assert _outcome(reqs) == want[0]
        snap = sched.metrics.snapshot()
        assert snap["wave_retries"] == 1
        assert snap["faults"] == {"wave_error": 1}
        assert not sched.degraded
    knobs = dict(do_sample=True, top_k=20, temperature=0.9)
    sampled = [_outcome(_wave_fault_run(
        Scheduler, _port_paged(models), fail_at=fail, **knobs)[0])
        for fail in (None, ONCE)]
    assert sampled[0] == sampled[1] != want[0]


def test_wave_faults_past_the_budget_degrade_like_jax(shared):
    """Every wave raises: after `wave_retries` retries the scheduler
    degrades: in-flight requests fail, queued ones are shed, new ones
    are rejected, health reads "degraded"."""
    always = {"chaos": {"every": 1}, "port": lambda n: True}
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        reqs, sched = _wave_fault_run(sched_cls, eng, fail_at=always,
                                      wave_retries=2)
        assert sched.degraded
        assert sched.engine.health_state == "degraded"
        assert sched.step() == 0
        with pytest.raises(ValueError, match="degraded"):
            sched.submit(prompt=_prompt(99), max_tokens=2)
        snap = sched.metrics.snapshot()
        got.append((_outcome(reqs), snap["faults"], snap["wave_retries"],
                    snap["rejected"]))
    assert got[0] == got[1]
    assert [r for _, r in got[1][0]] == ["error"] * 4 + ["rejected"] * 2
    assert got[1][1] == {"wave_error": 3, "degraded": 1}
    assert got[1][2] == 2


def test_evacuate_matches_jax(shared):
    """evacuate(): every accepted request leaves unresolved (in-slot
    first, then queued) and the scheduler stops taking work (the engine
    is presumed dead: nothing retires its slots)."""
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        sched = sched_cls(eng)
        reqs = [sched.submit(prompt=_prompt(20 + i), max_tokens=4)
                for i in range(6)]
        sched.step()
        out = sched.evacuate()
        assert all(r.finish_reason is None for r in out)
        assert sched.degraded and sched.in_flight() == 0
        assert sched.queue_depth() == 0 and sched.step() == 0
        with pytest.raises(ValueError, match="degraded"):
            sched.submit(prompt=_prompt(30), max_tokens=2)
        got.append([reqs.index(r) for r in out])
    assert got[0] == got[1] == [0, 1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# token masks
# ---------------------------------------------------------------------------

ALLOWED = [3, 5, 9]


def _mask(req):
    """The JAX test's mask: the legal set alternates with the emitted
    stream's length, so it depends on tokens not yet emitted."""
    m = np.zeros((VOCAB,), bool)
    m[ALLOWED[len(req.output_tokens) % len(ALLOWED)]] = True
    return m


def _masked_run(sched, masked_only):
    reqs = [sched.submit(prompt=_prompt(104), max_tokens=6,
                         token_mask=_mask)]
    if not masked_only:
        reqs.append(sched.submit(prompt=_prompt(105), max_tokens=6))
    sched.run()
    return reqs


@pytest.mark.parametrize("masked_only", [True, False])
def test_token_mask_on_dense_paged_and_spec_matches_jax(shared,
                                                        masked_only):
    """Every token of the masked request is allowed; the speculative
    streams equal the paged ones, and a masked lane proposes no draft
    token (spec_len 0), so the draft counts equal JAX's and are 0 with
    only masked lanes."""
    out = {}
    for kind in ("dense", "paged", "spec"):
        for pkg, eng in zip(("jax", "port"), shared(kind)):
            sched = (JScheduler if pkg == "jax" else Scheduler)(eng)
            reqs = _masked_run(sched, masked_only)
            out[kind, pkg] = (_outcome(reqs), sched.metrics.snapshot())
    want = out["paged", "jax"][0]
    toks, reason = want[0]
    assert reason == "max_tokens"
    assert toks == [ALLOWED[i % 3] for i in range(6)]
    for key, (outcome, _) in out.items():
        assert outcome == want, key
    proposed = {pkg: out["spec", pkg][1]["spec_tokens_proposed"]
                for pkg in ("jax", "port")}
    assert proposed["port"] == proposed["jax"]
    assert (proposed["port"] == 0) == masked_only


def test_mask_row_lands_in_the_static_bias_buffer(models):
    """The per-wave refresh writes the fresh row into the wave's bias
    buffer in place (the address a CUDA graph captured), and a retired
    lane's row is zero again."""
    eng = _port_paged(models)
    bias = eng.wave_inputs.tensors["bias"]
    ptr = bias.data_ptr()
    sched = Scheduler(eng)
    req = sched.submit(prompt=_prompt(104), max_tokens=4, token_mask=_mask)
    while sched.step():
        assert bias.data_ptr() == ptr
        assert eng.wave_inputs.tensors["bias"] is bias
        if req.slot is not None:
            row = bias[req.slot]
            want = ALLOWED[(len(req.output_tokens) - 1) % 3]
            assert float(row[want]) == 0.0
            assert int((row == 0).sum()) == 1
    assert not eng._slot_bias.any()


def test_raising_token_mask_fails_only_its_request_like_jax(shared):
    def boom(req):
        if len(req.output_tokens) >= 2:
            raise RuntimeError("client mask bug")
        return np.ones((VOCAB,), bool)
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        sched = sched_cls(eng)
        bad = sched.submit(prompt=_prompt(106), max_tokens=8,
                           token_mask=boom)
        good = sched.submit(prompt=_prompt(105), max_tokens=6)
        sched.run()
        got.append((_outcome([bad, good]),
                    sched.metrics.snapshot()["faults"]))
    assert got[0] == got[1]
    assert got[1][0][0][1] == "error" and got[1][0][1][1] == "max_tokens"
    assert got[1][1] == {"token_mask_error": 1}


# ---------------------------------------------------------------------------
# priority, QoS, stop_context
# ---------------------------------------------------------------------------

def test_priority_preemption_victim_matches_jax(shared):
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        sched = sched_cls(eng)
        low = sched.submit(prompt=[1, 2, 3], max_tokens=6, priority=0)
        mid = sched.submit(prompt=[4, 5, 6], max_tokens=6, priority=3)
        high = sched.submit(prompt=[7, 8, 9], max_tokens=6, priority=9)
        peer = sched.submit(prompt=[2, 4, 6], max_tokens=6, priority=0)
        for _ in range(3):
            sched.step()
        slot = {id(r): s for s, r in enumerate(sched._slot_req)
                if r is not None}
        got.append([sched._preemption_victim(slot[id(r)])
                    for r in (high, mid, low, peer)])
        sched.shutdown()
    # high and mid evict the latest-submitted of the priority-0 pair;
    # nothing ranks strictly below the priority-0 lanes
    assert got[0] == got[1] == [3, 3, None, None]


class _QoSStub:
    """A duck-typed QoS manager: always under pressure, picking the
    first queued request of the tenant with the fewest in flight."""

    def __init__(self):
        self.counts = []

    def under_pressure(self, pool):
        return pool is not None

    def pick_admission(self, queue, counts):
        self.counts.append(dict(counts))
        return min(range(len(queue)),
                   key=lambda i: (counts.get(queue[i].tenant, 0), i))


def test_qos_stub_pick_matches_jax(shared):
    tenants = ["a", "a", "a", "b", "b", "c", "a"]
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        qos = _QoSStub()
        sched = sched_cls(eng, qos=qos)
        reqs = [sched.submit(prompt=_prompt(120 + i), max_tokens=3,
                             tenant=t) for i, t in enumerate(tenants)]
        sched.step()
        first = [reqs.index(r) for r in sched._slot_req]
        sched.run()
        got.append((first, qos.counts, _outcome(reqs)))
    assert got[0] == got[1]
    assert got[1][0] == [0, 3, 5, 1]


def test_stop_context_matches_jax(shared):
    """A stop sequence straddling a continuation's seam fires on the
    continuation: the earlier stream's tail rides as stop_context."""
    got = []
    for sched_cls, req_cls, eng in zip((JScheduler, Scheduler),
                                       (JRequest, Request), shared("paged")):
        prompt = _prompt(108)
        free = sched_cls(eng).generate(prompt, max_tokens=8)
        stop = free[2:4]
        cut = 3                                # the stop straddles it
        req = req_cls(prompt=prompt + free[:cut], max_tokens=8,
                      stop_sequences=[stop], stop_context=free[:cut])
        sched = sched_cls(eng)
        sched.submit(request=req)
        sched.run()
        plain = req_cls(prompt=prompt + free[:cut], max_tokens=8,
                        stop_sequences=[stop])
        sched.submit(request=plain)
        sched.run()
        got.append((free, _outcome([req, plain])))
    assert got[0] == got[1]
    free, ((toks, reason), _) = got[1]
    assert reason == "stop" and free[:3] + toks == free[:4]


# ---------------------------------------------------------------------------
# metrics and observability hooks
# ---------------------------------------------------------------------------

def test_metrics_snapshot_matches_jax(shared):
    """The phase split, wave retries, queue peak, block occupancy and the
    prefix deltas: the JAX snapshot's keys, and equal values where they
    do not depend on the clock."""
    keys = ("wave_retries", "queue_depth_peak", "block_utilization",
            "prefix_hits", "prefix_misses", "prefix_hit_rate", "rejected",
            "tokens_generated", "faults", "spec_tokens_proposed")
    prefix = _prompt(130, n=20)
    # the second shared-prefix job is admitted after the first prefilled
    jobs = [(prefix + [1, 2], 5)]
    jobs += [(_prompt(131 + i, n=4 + 3 * i), 4) for i in range(5)]
    jobs += [(prefix + [3], 4)]
    got = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        sched = sched_cls(eng)
        for p, m in jobs:
            sched.submit(prompt=p, max_tokens=m)
        sched.run()
        snap = sched.metrics.snapshot()
        assert set(snap["phase_seconds"]) == set(PHASES)
        assert all(v >= 0 for v in snap["phase_seconds"].values())
        assert snap["first_token_time"] <= snap["last_token_time"]
        got.append({k: snap[k] for k in keys})
    assert got[0] == got[1]
    assert got[1]["queue_depth_peak"] == 7 and got[1]["prefix_hits"] == 2
    assert 0 < got[1]["block_utilization"] < 1


class _Probe:
    """A duck-typed SLO engine, sampler and alert manager in one."""

    def __init__(self, key):
        self.key, self.calls = key, {}

    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def observe_request(self, req):
        self._count("observe_request")

    def evaluate(self):
        self._count("evaluate")

    def maybe_sample(self):
        self._count("maybe_sample")

    def health(self):
        return {self.key: "ok"}


def test_timeseries_and_slo_hooks_run_per_working_round(models, shared):
    """attach_timeseries: the sampler and the alert manager run once per
    working round, as often as JAX's; their health and a duck-typed SLO
    engine's merge into the engine's health; the SLO engine sees every
    completion."""
    rounds = []
    for sched_cls, eng in zip((JScheduler, Scheduler), shared("paged")):
        probe = _Probe("alerts")
        sched = sched_cls(eng).attach_timeseries(sampler=probe,
                                                 alerts=probe)
        for i in range(5):
            sched.submit(prompt=_prompt(140 + i, n=3 + 4 * i), max_tokens=4)
        sched.run()
        assert eng._health()["alerts"] == "ok"
        rounds.append(probe.calls)
    assert rounds[0] == rounds[1]
    assert rounds[1]["maybe_sample"] == rounds[1]["evaluate"] > 0
    slo = _Probe("slo")
    eng = _port_paged(models)
    sched = Scheduler(eng, slo=slo)
    for i in range(3):
        sched.submit(prompt=_prompt(150 + i), max_tokens=3)
    sched.run()
    assert slo.calls["observe_request"] == 3 and slo.calls["evaluate"] > 0
    assert eng.health()["slo"] == "ok"
    assert len(sched.completed) == 3
