"""Scheduler: admission queue + continuous-batching loop over a serving
engine (the core of `paddle_tpu/serving/scheduler.py`).

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
`max_preemptions`. A lane whose logits go non-finite resolves only its
own request ("error"); the rest of the batch decodes on.

Thread-model: submit() is safe from any producer thread; the wave loop
runs wherever run()/step() is called, one round at a time.
"""
import collections
import threading
import time

from .metrics import ServingMetrics
from .paged.block_pool import BlockPoolExhausted
from .request import Request


class Scheduler:
    def __init__(self, engine, max_queue=None, max_preemptions=3):
        self.engine = engine
        self.max_queue = max_queue
        self.max_preemptions = max(0, int(max_preemptions))
        self._queue = collections.deque()
        self._lock = threading.Lock()        # the queue
        self._wave_lock = threading.Lock()   # one step() at a time
        self._slot_req = [None] * engine.num_slots
        self.metrics = ServingMetrics(engine.num_slots)

    # ---------------------------------------------------------- admission
    def submit(self, request=None, **kw):
        """Enqueue a Request (or build one from kwargs). A prompt the
        engine can never hold, or a full queue, rejects the request: it
        is marked REJECTED and a ValueError raises to the caller."""
        if request is None:
            request = Request(**kw)
        why = self.engine.validate_prompt(request.prompt)
        if why is None:
            with self._lock:
                if self.max_queue is not None and \
                        len(self._queue) >= self.max_queue:
                    why = f"queue full (max_queue={self.max_queue})"
                else:
                    request._mark_submitted()
                    self._queue.append(request)
        if why is not None:
            self.metrics.on_reject()
            request._reject(why)            # raises ValueError
        return request

    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def _pop_next(self):
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def _requeue_front(self, req):
        """Back to the queue HEAD (capacity pressure): FCFS standing kept."""
        with self._lock:
            self._queue.appendleft(req)

    @staticmethod
    def _continuation(req):
        """The tokens a (re-)admission must prefill: prompt + anything
        already generated, so a preempted request resumes by recompute."""
        return req.prompt + req.output_tokens

    def _admit(self):
        """Assign queued requests to free slots and stage their prefill.
        A request whose timeout expired in the queue retires without a
        prefill; an exhausted pool waits at the head for in-flight work
        to free blocks, or rejects when nothing could."""
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
            try:
                self.engine.begin_prefill(
                    slot, self._continuation(req), do_sample=req.do_sample,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, logit_bias=req.logit_bias)
            except BlockPoolExhausted as e:
                if self.engine.active_slots() or \
                        self.engine.prefilling_slots():
                    if not req._cache_waiting:   # one fault per episode
                        req._cache_waiting = True
                        self.metrics.on_fault("cache_exhausted")
                    self._requeue_front(req)
                    return
                self.metrics.on_reject()
                req._reject(f"KV cache exhausted ({e})", raise_error=False)
                continue
            req._cache_waiting = False
            req._start_prefill(slot)
            self._slot_req[slot] = req

    def _advance_prefills(self):
        """One prefill step (one chunk) per mid-admission slot; a slot
        whose prefill completed emits its first token and joins this
        round's decode wave."""
        for slot in self.engine.prefilling_slots():
            req = self._slot_req[slot]
            if req._timed_out():
                self.engine.retire_slot(slot)
                self._slot_req[slot] = None
                req._finish("timeout")
                self._complete(req)
                continue
            first = self.engine.prefill_step(slot)
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
        self.metrics.on_complete(req)

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
            self.metrics.on_fault("cache_exhausted")
            req._fail(why or "KV cache exhausted: preemption budget "
                             f"spent ({req.preemptions}x)")
            self._complete(req)
            return
        self.metrics.on_fault("preempted")
        self._requeue_front(req)

    def _preempt_starved(self):
        for slot in self.engine.last_starved_slots:
            if self._slot_req[slot] is not None:
                self._evict_for_recompute(slot)

    def step(self):
        """One scheduling round: admit, advance prefills one chunk, run
        one decode wave, stream its tokens, retire finished slots.
        Returns the number of requests still in flight or queued."""
        with self._wave_lock:
            self._admit()
            self._advance_prefills()
            active = self.engine.active_slots()
            if active:
                toks = self.engine.decode_wave()
                waved = len(active) - len(self.engine.last_starved_slots)
                if waved > 0:
                    self.metrics.on_wave(waved)
                    self._record_spec_wave()
                for slot in self.engine.last_nonfinite_slots:
                    req = self._slot_req[slot]
                    self.engine.retire_slot(slot)
                    self._slot_req[slot] = None
                    self.metrics.on_fault("nonfinite")
                    req._fail("non-finite logits in decode wave")
                    self._complete(req)
                now = time.monotonic()
                for slot, emitted in toks.items():
                    req = self._slot_req[slot]
                    # a speculative wave emits a BATCH per lane: stream it
                    # in order and stop at the first retirement (eos,
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
                self._preempt_starved()
            return self.in_flight() + self.queue_depth()

    def _record_spec_wave(self):
        """A speculative engine's draft economics for the wave: tokens
        proposed (the lanes' spec_len) and accepted."""
        proposed = self.engine.last_spec_proposed
        if proposed is not None:
            self.metrics.on_spec(proposed, self.engine.last_spec_accepted)

    def in_flight(self):
        return sum(1 for r in self._slot_req if r is not None)

    def run(self, max_waves=None):
        """Drive step() until the queue and all slots drain (or max_waves
        rounds ran). Returns the number of rounds."""
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
