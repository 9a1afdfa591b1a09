"""Scheduler: admission queue + continuous-batching loop over a serving
engine (the port of `paddle_tpu/serving/scheduler.py`).

FCFS admission: whenever a slot is free and the queue is non-empty, the
head request is assigned to it mid-stream (engine.begin_prefill) and its
prefill advances one engine step per scheduling round
(engine.prefill_step — the whole bucket on the dense engine, one CHUNK
on the paged engine), so a long prompt's admission folds between decode
waves. Retirement (EOS / stop
sequence / max_tokens / cache horizon / timeout) frees slots between
waves and the freed slot is refilled in the next round. A speculative
engine's wave gives each lane a list of tokens, streamed in order up to
the first retirement.

A dense engine never starves: its slots own their cache rows. Paged
capacity: an exhausted block pool at admission queues the head request
behind the blocks it waits for (or rejects it when nothing in flight
could free them); a lane starved mid-decode is PREEMPTED BY
RECOMPUTE — blocks freed, request requeued with prompt + generated
tokens (prefix-cache hits make the re-prefill cheap), bounded by
`max_preemptions`. Which lane goes is a priority decision: the
lowest-priority lane strictly below the starved one, else the starved
lane itself.

Faults stay with their request:
  * a failed prefill, a refused handoff payload, a raising token_mask or
    a lane whose logits go non-finite resolves only its own request
    ("error"); `prefill_fail_limit` consecutive prefill failures degrade
    the engine (a persistently broken engine cannot hide behind
    per-request isolation);
  * a decode wave that raises is retried `wave_retries` times with a
    doubling backoff from `retry_backoff_s`; the engine raises before
    its programs run, so a retry replays exactly (the generator's offset
    moves only inside a program). An exhausted budget degrades: in-flight
    requests resolve "error", queued and new ones are shed "rejected",
    health() reports "degraded";
  * `drain()` stops admissions while accepted work completes (health:
    "draining"); `shutdown()` drains and runs the loop dry.

Roles (disaggregated serving): a "prefill" scheduler exports each
completed prefill's KV blocks (engine.export_slot_kv) and parks
(request, payload) for `take_handoffs` instead of decoding; a "decode"
scheduler admits only handoff continuations, importing the blocks with
no prefill chunk; "unified" does both. The fleet router that moves the
payloads, the SLO engine, the QoS manager and the timeseries sampler are
not ported: `slo=`, `qos=` and `attach_timeseries` take duck-typed
objects and call them as the JAX scheduler does.

Each round's phases run under `torch.profiler.record_function` spans
(`serving/admission`, `serving/prefill`, `serving/decode_wave`,
`serving/host_dispatch`) and their wall time feeds the metrics' phase
split.

Thread-model: submit() is safe from any producer thread; the wave loop
runs wherever run()/step() is called, one round at a time.
"""
import collections
import contextlib
import threading
import time

import torch

from .metrics import ServingMetrics
from .paged.block_pool import BlockPoolExhausted
from .request import Request

#: replica roles: "prefill" runs only prefill chunks and exports each
#: completed prefill's blocks; "decode" admits only handoff
#: continuations; "unified" does both
ROLES = ("prefill", "decode", "unified")


class _Span:
    """Wall time of one `serving/...` profiler span (None until it
    closed)."""
    elapsed = None


@contextlib.contextmanager
def _span(name):
    span = _Span()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield span
    finally:
        span.elapsed = time.perf_counter() - t0


class Scheduler:
    def __init__(self, engine, max_queue=None, completed_log=1024,
                 wave_retries=3, retry_backoff_s=0.05,
                 prefill_fail_limit=None, max_preemptions=3, slo=None,
                 role="unified", qos=None):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if role != "unified" and not hasattr(engine, "export_slot_kv"):
            raise ValueError(
                f"role {role!r} needs an engine with the block-level "
                "handoff (export_slot_kv / import_handoff: the paged "
                "engines)")
        self.role = role
        # duck-typed QoS manager: under_pressure(pool) gates a
        # weighted-fair pick_admission(queue, in_flight_by_tenant);
        # None keeps strict FCFS
        self.qos = qos
        # prefill role: (request, payload) pairs waiting for the router
        # (payload None = the export failed)
        self._handoff_ready = []
        self.engine = engine
        self.max_queue = max_queue
        # chrome-trace process row of this scheduler's requests (a fleet
        # replica sets replica_id + 1)
        self.trace_pid = 0
        # duck-typed SLO engine: observe_request(req) per completion,
        # evaluate() per working round, health() merged into the engine's
        self.slo_engine = slo
        self._sampler = None
        self._alerts = None
        if slo is not None:
            engine.attach_health_probe(self._health_extras)
        self.last_wave_s = None
        self.wave_retries = max(0, int(wave_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_preemptions = max(0, int(max_preemptions))
        # consecutive distinct-request prefill failures taken as the
        # engine's fault, not the requests'
        self.prefill_fail_limit = (engine.num_slots + self.wave_retries
                                   if prefill_fail_limit is None
                                   else max(1, int(prefill_fail_limit)))
        self._prefill_fail_streak = 0
        self._queue = collections.deque()
        self._lock = threading.Lock()        # queue + lifecycle flags
        self._wave_lock = threading.Lock()   # one step() at a time
        self._slot_req = [None] * engine.num_slots
        self._draining = False
        self._degraded = False
        self.last_error = None
        self.metrics = ServingMetrics(engine.num_slots)
        engine.attach_queue_probe(self.queue_depth)
        pool = getattr(engine, "block_pool", None)
        if pool is not None:
            # the prefix-delta baseline, before any round of ours
            self.metrics.on_prefix_totals(pool.prefix_hits,
                                          pool.prefix_misses)
        # a bounded inspection tail of resolved requests (None keeps all)
        self.completed = collections.deque(maxlen=completed_log)

    # ------------------------------------------------------ observability
    def attach_timeseries(self, sampler=None, alerts=None):
        """Attach a duck-typed metrics sampler (`maybe_sample()`) and/or
        alert manager (`evaluate()`, `health()`): both run once per
        working round, and the alert state joins the SLO verdict in the
        engine's health (one merged probe: the engine keeps the newest).
        Returns self."""
        if sampler is not None:
            self._sampler = sampler
        if alerts is not None:
            self._alerts = alerts
        self.engine.attach_health_probe(self._health_extras)
        return self

    def _health_extras(self):
        out = {}
        if self.slo_engine is not None:
            out.update(self.slo_engine.health() or {})
        if self._alerts is not None:
            out.update(self._alerts.health() or {})
        return out

    # ---------------------------------------------------------- admission
    def submit(self, request=None, **kw):
        """Enqueue a Request (or build one from kwargs). A prompt the
        engine can never hold, a full queue, a draining or degraded
        scheduler rejects the request: it is marked REJECTED and a
        ValueError raises to the caller. A request the role cannot take
        raises without being resolved (the caller may route it
        elsewhere)."""
        if request is None:
            request = Request(**kw)
        if self.role == "decode" and request.handoff is None:
            raise ValueError(
                "decode-role replica accepts only block-level handoff "
                "continuations (this request still needs prefill)")
        if self.role == "prefill" and request.handoff is not None:
            raise ValueError(
                "prefill-role replica cannot import a handoff payload")
        if request.seed is None:
            request.seed = getattr(self.engine, "seed", None)
        why = self.engine.validate_prompt(request.prompt)
        if why is not None:
            self.metrics.on_reject()
            request._reject(why)            # raises ValueError
        with self._lock:
            if self._degraded:
                shed = f"engine degraded ({self.last_error})"
            elif self._draining:
                shed = "engine draining (graceful shutdown)"
            elif self.max_queue is not None and \
                    len(self._queue) >= self.max_queue:
                shed = f"queue full (max_queue={self.max_queue})"
            else:
                shed = None
                request.trace_pid = self.trace_pid
                request._mark_submitted()
                self._queue.append(request)
                depth = len(self._queue)
        if shed is not None:
            self.metrics.on_reject()
            request._reject(shed)           # raises ValueError
        self.metrics.on_submit()
        self.metrics.on_queue_depth(depth)
        return request

    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def _pop_next(self):
        """Next request to admit: strict FCFS, except under block-pool
        pressure with a QoS manager, whose pick is weighted-fair across
        tenants (by their requests in flight)."""
        with self._lock:
            req, i = None, 0
            if self._queue:
                if self.qos is not None and len(self._queue) > 1 and \
                        self.qos.under_pressure(
                            getattr(self.engine, "block_pool", None)):
                    counts = {}
                    for r in self._slot_req:
                        if r is not None:
                            counts[r.tenant] = counts.get(r.tenant, 0) + 1
                    i = self.qos.pick_admission(self._queue, counts)
                req = self._queue[i]
                del self._queue[i]
            depth = len(self._queue)
        self.metrics.on_queue_depth(depth)
        return req

    def _requeue_front(self, req):
        """Back to the queue HEAD (capacity pressure): FCFS standing kept."""
        with self._lock:
            self._queue.appendleft(req)
            depth = len(self._queue)
        self.metrics.on_queue_depth(depth)

    @staticmethod
    def _continuation(req):
        """The tokens a (re-)admission must prefill: prompt + anything
        already generated, so a preempted request resumes by recompute."""
        return req.prompt + req.output_tokens

    def _combined_bias(self, req):
        """The slot's [V] bias row: the static logit_bias plus the
        token_mask evaluated on what the request has emitted."""
        bias = self.engine._normalize_bias(req.logit_bias)
        if req.token_mask is not None:
            bias = bias + self.engine._normalize_bias(req.token_mask(req))
        return bias

    def _admission_bias(self, req):
        """The bias row an admission arms: the first token obeys the mask
        too. A raising mask lands in the admission's fault barrier."""
        return (req.logit_bias if req.token_mask is None
                else self._combined_bias(req))

    def _refresh_token_masks(self):
        """Re-evaluate every active lane's token_mask before the wave and
        stage the fresh row. A raising mask fails only its request."""
        for slot, req in enumerate(self._slot_req):
            if req is None or req.token_mask is None or \
                    not self.engine.slot_active[slot]:
                continue
            try:
                self.engine.set_slot_bias(slot, self._combined_bias(req))
            except Exception as e:   # noqa: BLE001 — client code
                self.last_error = e
                self.engine.retire_slot(slot)
                self._slot_req[slot] = None
                self._fault("token_mask_error", action="request_failed",
                            request=req, slot=slot, error=e)
                req._fail(e)
                self._complete(req)

    def _admit(self):
        """Assign queued requests to free slots and stage their prefill
        (or import their handoff). A request whose timeout expired in
        the queue retires without a prefill; an exhausted pool waits at
        the head for in-flight work to free blocks, or rejects when
        nothing could; any other admission error fails its request
        alone."""
        while True:
            free = self.engine.free_slots()
            if not free:
                return
            req = self._pop_next()
            if req is None:
                return
            if req._timed_out():
                req._finish("timeout")
                self._complete(req)
                continue
            slot = free[0]
            handoff = req.handoff
            try:
                knobs = dict(do_sample=req.do_sample,
                             temperature=req.temperature, top_k=req.top_k,
                             top_p=req.top_p,
                             logit_bias=self._admission_bias(req),
                             dynamic_mask=req.token_mask is not None)
                if handoff is not None:
                    # the exporter's blocks land here: no prefill chunk
                    self.engine.import_handoff(
                        slot, self._continuation(req), handoff, **knobs)
                else:
                    self.engine.begin_prefill(
                        slot, self._continuation(req), **knobs)
            except BlockPoolExhausted as e:
                if self.engine.active_slots() or \
                        self.engine.prefilling_slots():
                    if not req._cache_waiting:   # one fault per episode
                        req._cache_waiting = True
                        self._fault("cache_exhausted", action="requeued",
                                    request=req, error=e)
                    self._requeue_front(req)
                    return
                self.metrics.on_reject()
                self._fault("cache_exhausted", action="rejected",
                            request=req, error=e)
                req._reject(f"KV cache exhausted ({e})", raise_error=False)
                self.completed.append(req)
                continue
            except Exception as e:   # noqa: BLE001 — fault barrier
                self.last_error = e
                if handoff is not None:
                    # an unusable payload is the request's fault, never
                    # the engine's: it does not feed the fail streak
                    self._fault("handoff_refused", action="request_failed",
                                request=req, slot=slot, error=e)
                    req.handoff = None
                    req._fail(e)
                    self._complete(req)
                    continue
                if self._prefill_fault(req, slot):
                    return
                continue
            # consumed: a later re-admission (preemption) recomputes
            req.handoff = None
            req._cache_waiting = False
            req._start_prefill(slot)
            self.engine.set_slot_trace(slot, req.trace_id, self.trace_pid)
            self._slot_req[slot] = req

    def _prefill_fault(self, req, slot):
        """Fail only this request, free the slot, and degrade after
        `prefill_fail_limit` consecutive failures. Returns True when the
        engine degraded (the round stops)."""
        self.engine.retire_slot(slot)
        self._slot_req[slot] = None
        self._prefill_fail_streak += 1
        escalate = self._prefill_fail_streak >= self.prefill_fail_limit
        self._fault("prefill_error",
                    action="degrade" if escalate else "request_failed",
                    request=req, slot=slot, error=self.last_error)
        req._fail(self.last_error)
        self._complete(req)
        if escalate:
            self._degrade()
            return True
        return False

    def _advance_prefills(self):
        """One prefill step (one chunk) per mid-admission slot; a slot
        whose prefill completed emits its first token and joins this
        round's decode wave (or, on the prefill role, is exported).
        Returns True when a fault degraded the engine."""
        for slot in self.engine.prefilling_slots():
            req = self._slot_req[slot]
            if req._timed_out():
                self.engine.retire_slot(slot)
                self._slot_req[slot] = None
                req._finish("timeout")
                self._complete(req)
                continue
            try:
                with _span("serving/prefill") as span:
                    first = self.engine.prefill_step(slot)
            except Exception as e:   # noqa: BLE001 — fault barrier
                self.last_error = e
                if self._prefill_fault(req, slot):
                    return True
                continue
            finally:
                self.metrics.on_phase("prefill_chunk", span.elapsed)
            self._prefill_fail_streak = 0
            self.metrics.on_prefill_chunk()
            if first is None:
                continue
            self.metrics.on_prefill()
            # non-None only for a preempted-then-resumed request: its
            # re-prefill token is a real inter-token gap
            prev_t = req.last_token_time
            req._emit(first)
            self.metrics.on_token(time.monotonic(), prev_t=prev_t)
            self._maybe_retire(slot, first)
            if self.role == "prefill" and self._slot_req[slot] is not None:
                self._export_handoff(slot)
        return False

    def _export_handoff(self, slot):
        """Export the slot's blocks (its prefill just emitted the first
        token) and park (request, payload) for take_handoffs; the slot
        retires either way (a failed export parks None: the caller falls
        back to recompute)."""
        req = self._slot_req[slot]
        payload = None
        try:
            payload = self.engine.export_slot_kv(slot)
        except Exception as e:   # noqa: BLE001 — fault barrier
            self.last_error = e
            self._fault("handoff_error", action="export_failed",
                        request=req, slot=slot, error=e)
        self.engine.retire_slot(slot)
        self._slot_req[slot] = None
        with self._lock:
            self._handoff_ready.append((req, payload))

    def take_handoffs(self):
        """Drain the prefill role's staging area: [(request, payload)]
        pairs whose prefill completed (payload None = export failed)."""
        with self._lock:
            out = self._handoff_ready
            self._handoff_ready = []
        return out

    # ---------------------------------------------------------- wave loop
    def _maybe_retire(self, slot, last_token, check_length=True):
        """Retire the slot if its request just finished. check_length=False
        skips the horizon check for the NON-final tokens of a speculative
        batch: slot_pos already counts the whole batch, and only its last
        token is the one written at the horizon — retiring on an earlier
        one would drop tokens the plain engine delivers."""
        req = self._slot_req[slot]
        reason = None
        if req.eos_token_id is not None and last_token == req.eos_token_id:
            reason = "eos"
        elif req.stop_sequences and req._hit_stop():
            reason = "stop"
        elif len(req.output_tokens) >= req.max_tokens:
            reason = "max_tokens"
        elif check_length and self.engine.slot_full(slot):
            reason = "length"
        elif req._timed_out():
            reason = "timeout"
        if reason is not None:
            self.engine.retire_slot(slot)
            self._slot_req[slot] = None
            req._finish(reason)
            self._complete(req)

    def _complete(self, req):
        self.completed.append(req)
        self.metrics.on_complete(req)
        if self.slo_engine is not None:
            self.slo_engine.observe_request(req)

    def _fault(self, kind, action=None, request=None, slot=None,
               error=None):
        """One handled fault, counted by kind (the JAX scheduler also
        journals it to its flight recorder, which is not ported)."""
        self.metrics.on_fault(kind)

    def _run_wave_with_retry(self):
        """The decode wave behind a bounded, doubling-backoff retry.
        Returns the wave's {slot: token(s)}, or None after degrading."""
        delay = self.retry_backoff_s
        for attempt in range(self.wave_retries + 1):
            try:
                with _span("serving/decode_wave") as span:
                    toks = self.engine.decode_wave()
                self.last_wave_s = span.elapsed
                self.metrics.on_phase("decode_wave", span.elapsed)
                return toks
            except Exception as e:   # noqa: BLE001 — fault barrier
                self.last_error = e
                self._fault("wave_error",
                            action=("retry" if attempt < self.wave_retries
                                    else "degrade"), error=e)
                if attempt >= self.wave_retries:
                    break
                self.metrics.on_wave_retry()
                time.sleep(delay)
                delay *= 2
        self._degrade()
        return None

    def _degrade(self):
        """The loop cannot make progress: in-flight and parked requests
        resolve "error", queued ones are shed "rejected", new submits
        are rejected, health() reports "degraded"."""
        with self._lock:
            # one lock with the health flip: a concurrent drain() cannot
            # overwrite "degraded" with "draining"
            self._degraded = True
            self.engine.set_health_state("degraded")
        self._fault("degraded", action="drain_and_reject",
                    error=self.last_error)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self.engine.retire_slot(slot)
            self._slot_req[slot] = None
            req._fail(f"engine degraded: {self.last_error!r}")
            self._complete(req)
        with self._lock:
            parked = [req for req, _ in self._handoff_ready]
            self._handoff_ready = []
        for req in parked:
            req._fail(f"engine degraded: {self.last_error!r}")
            self._complete(req)
        while True:
            req = self._pop_next()
            if req is None:
                break
            self.metrics.on_reject()
            req._reject(f"engine degraded ({self.last_error!r})",
                        raise_error=False)
            # shed, not completed: no latency sample
            self.completed.append(req)

    def evacuate(self):
        """Pull every accepted, unresolved request out WITHOUT resolving
        it and stop accepting work (a fleet's failover of a replica
        presumed dead: no engine call is made). Returns the requests,
        in-slot first, then parked handoffs, then queued."""
        with self._wave_lock:
            with self._lock:
                self._degraded = True
                if self.last_error is None:
                    self.last_error = "replica evacuated"
                queued = list(self._queue)
                self._queue.clear()
                parked = [req for req, _ in self._handoff_ready]
                self._handoff_ready = []
            out = [req for req in self._slot_req if req is not None]
            self._slot_req = [None] * self.engine.num_slots
            out.extend(parked)
            out.extend(queued)
        self.metrics.on_queue_depth(0)
        return out

    def _preemption_victim(self, starved_slot):
        """The lane that recompute evicts to unblock a starved one: the
        lowest-priority other active lane strictly below the starved
        request's priority (ties: the latest submitted). None when no
        lane ranks below: the starved lane evicts itself."""
        starved_pri = self._slot_req[starved_slot].priority
        victim = None
        for slot, req in enumerate(self._slot_req):
            if req is None or slot == starved_slot or \
                    not self.engine.slot_active[slot]:
                continue
            if req.priority >= starved_pri:
                continue
            if victim is None:
                victim = slot
                continue
            vreq = self._slot_req[victim]
            if req.priority < vreq.priority or (
                    req.priority == vreq.priority
                    and (req.submit_time or 0) > (vreq.submit_time or 0)):
                victim = slot
        return victim

    def _evict_for_recompute(self, slot):
        """Preemption by recompute: free the slot's blocks and requeue the
        request with prompt + generated tokens. Past its preemption budget,
        or when its continuation can never fit, it resolves "error"."""
        req = self._slot_req[slot]
        self.engine.retire_slot(slot)
        self._slot_req[slot] = None
        req.preemptions += 1
        why = self.engine.validate_prompt(self._continuation(req))
        if req.preemptions > self.max_preemptions or why is not None:
            self._fault("cache_exhausted", action="request_failed",
                        request=req, slot=slot)
            req._fail(why or "KV cache exhausted: preemption budget "
                             f"spent ({req.preemptions}x)")
            self._complete(req)
            return
        # counted as its own kind (the JAX scheduler counts a preemption
        # as "cache_exhausted" and journals action "preempted")
        self._fault("preempted", action="requeued", request=req, slot=slot)
        self._requeue_front(req)

    def _preempt_starved(self):
        """Pool-exhausted lanes (the wave left them out): evict a
        lower-priority lane for each, or the lane itself."""
        for slot in self.engine.last_starved_slots:
            if self._slot_req[slot] is None:
                continue     # already evicted as another lane's victim
            victim = self._preemption_victim(slot)
            self._evict_for_recompute(slot if victim is None else victim)

    def step(self):
        """One scheduling round: admit, advance prefills one chunk, run
        one decode wave, stream its tokens, retire finished slots.
        Returns the number of requests still in flight or queued. Rounds
        serialise on `_wave_lock`."""
        with self._wave_lock:
            return self._step_locked()

    def _step_locked(self):
        if self._degraded:
            return 0
        with _span("serving/admission") as span:
            self._admit()
        self.metrics.on_phase("admission", span.elapsed)
        # before the advance: a prefill that admits, emits and retires
        # within this round still makes it a working round
        prefilled = bool(self.engine.prefilling_slots())
        if self._advance_prefills():
            return 0
        self._refresh_token_masks()
        active = self.engine.active_slots()
        if active:
            toks = self._run_wave_with_retry()
            if toks is None:
                return 0
            waved = len(active) - len(self.engine.last_starved_slots)
            if waved > 0:
                self.metrics.on_wave(waved, wave_s=self.last_wave_s)
                self._record_spec_wave()
            for slot in self.engine.last_nonfinite_slots:
                req = self._slot_req[slot]
                self.engine.retire_slot(slot)
                self._slot_req[slot] = None
                self._fault("nonfinite", action="slot_retired",
                            request=req, slot=slot)
                req._fail("non-finite logits in decode wave")
                self._complete(req)
            now = time.monotonic()
            with _span("serving/host_dispatch") as span:
                for slot, emitted in toks.items():
                    req = self._slot_req[slot]
                    # a speculative wave emits a BATCH per lane: stream
                    # it in order and stop at the first retirement (eos,
                    # stop, budget, horizon); the rest of the batch is
                    # what the plain wave would never have generated
                    if not isinstance(emitted, list):
                        emitted = [emitted]
                    for j, tok in enumerate(emitted):
                        # the batch's tokens arrive together: their gaps
                        # are 0 (the previous token's own stamp, taken
                        # after `now`, would give a negative sample)
                        prev_t = req.last_token_time if j == 0 else now
                        req._emit(tok)
                        self.metrics.on_token(now, prev_t=prev_t)
                        self._maybe_retire(
                            slot, tok, check_length=j == len(emitted) - 1)
                        if self._slot_req[slot] is None:
                            break
            self.metrics.on_phase("host_dispatch", span.elapsed)
            # after the dispatch: a priority victim was in this wave, and
            # evicting it first would drop the token it just produced
            self._preempt_starved()
        if active or prefilled:
            pool = getattr(self.engine, "block_pool", None)
            if pool is not None:
                self.metrics.on_blocks(pool.used, pool.usable)
                self.metrics.on_prefix_totals(pool.prefix_hits,
                                              pool.prefix_misses)
            if self.slo_engine is not None:
                self.slo_engine.evaluate()
            if self._sampler is not None:
                self._sampler.maybe_sample()
            if self._alerts is not None:
                self._alerts.evaluate()
        return self.in_flight() + self.queue_depth()

    def _record_spec_wave(self):
        """A speculative engine's draft economics for the wave: tokens
        proposed (the lanes' spec_len) and accepted."""
        proposed = self.engine.last_spec_proposed
        if proposed is not None:
            self.metrics.on_spec(proposed, self.engine.last_spec_accepted)

    def in_flight(self):
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def draining(self):
        return self._draining

    @property
    def degraded(self):
        return self._degraded

    # ------------------------------------------------------- graceful stop
    def drain(self):
        """Stop admitting: accepted requests (queued or in a slot) run to
        completion, new submits are shed "rejected", health() reports
        "draining". Keep driving step()/run() to finish the work."""
        with self._lock:
            self._draining = True
            if not self._degraded:       # degraded is sticky
                self.engine.set_health_state("draining")

    def shutdown(self, max_waves=None):
        """Graceful shutdown: drain(), then drive the loop until every
        accepted request resolves. Returns the rounds run."""
        self.drain()
        return self.run(max_waves=max_waves)

    def run(self, drain=True, max_waves=None):
        """Drive step() until the queue and all slots drain (or max_waves
        rounds ran). Returns the number of rounds. `drain` is the JAX
        signature's, which runs to empty either way."""
        rounds = 0
        while self.step():
            rounds += 1
            if max_waves is not None and rounds >= max_waves:
                break
        return rounds

    def generate(self, prompt, **kw):
        """Blocking single-request convenience: submit, drain, return the
        generated token list."""
        req = self.submit(prompt=prompt, **kw)
        while not req.done:
            self.step()
        return req.output_tokens
