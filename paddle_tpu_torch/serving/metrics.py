"""Per-scheduler serving metrics (a subset of
`paddle_tpu/serving/metrics.py` `ServingMetrics`): TTFT, TPOT, request
latency, tokens, decode waves and prefill chunks, the speculative
engine's draft tokens proposed and accepted, wave retries, the queue's
peak, the per-round phase split, the paged pool's block occupancy and
the prefix cache's hits and misses. The counters live in `snapshot()`
only: the port has no telemetry registry or Prometheus gauges yet.

Percentiles are exact over the most recent `window` samples of each
kind (a long-running server keeps a bounded tail, not every sample it
ever saw). Times are host wall-clock seconds: the engine synchronises
with the device once per wave when it reads the tokens back, so a token
timestamp is taken after the device produced it.
"""
import collections
import threading

import numpy as np

#: scheduler-round phases whose wall time `on_phase` accumulates (the
#: keys of snapshot()'s `phase_seconds`): admission, one prefill chunk
#: per mid-admission slot, the decode wave (its sampling tail is inside
#: the program) and the host's token dispatch
PHASES = ("admission", "prefill_chunk", "decode_wave", "host_dispatch")


def _percentile(samples, q):
    return float(np.percentile(np.asarray(samples), q)) if samples else None


class ServingMetrics:
    def __init__(self, num_slots, window=65536):
        self.num_slots = int(num_slots)
        self._lock = threading.Lock()
        self._ttft = collections.deque(maxlen=window)
        self._tpot = collections.deque(maxlen=window)
        self._latency = collections.deque(maxlen=window)
        self._tokens = 0
        self._waves = 0
        self._prefill_chunks = 0
        self._prefills = 0
        self._completed = 0
        self._rejected = 0
        self._active_slot_waves = 0
        self._first_token_time = None
        self._last_token_time = None
        self._faults = {}
        # speculative decoding tallies (0 on other engines)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_waves = 0
        self._submitted = 0
        self._wave_retries = 0
        self._queue_peak = 0
        self._phase_seconds = {}
        # paged pool: the block-round integral, and the pool's monotonic
        # prefix counters at this instance's first and latest sample
        self._block_used_rounds = 0
        self._block_total_rounds = 0
        self._prefix_base = None
        self._prefix_last = None

    # ---------------------------------------------------------- recording
    def on_submit(self):
        with self._lock:
            self._submitted += 1

    def on_reject(self):
        with self._lock:
            self._rejected += 1

    def on_fault(self, kind):
        with self._lock:
            self._faults[kind] = self._faults.get(kind, 0) + 1

    def on_wave_retry(self):
        with self._lock:
            self._wave_retries += 1

    def on_phase(self, phase, seconds):
        """Attribute one scheduler-round phase's wall time (`PHASES`)."""
        if seconds is None:
            return
        with self._lock:
            self._phase_seconds[phase] = (
                self._phase_seconds.get(phase, 0.0) + float(seconds))

    def on_queue_depth(self, depth):
        with self._lock:
            self._queue_peak = max(self._queue_peak, int(depth))

    def on_blocks(self, used, total):
        """One working round's paged-pool occupancy sample."""
        with self._lock:
            self._block_used_rounds += int(used)
            self._block_total_rounds += int(total)

    def on_prefix_totals(self, hits, misses):
        """The pool's monotonic prefix counters; snapshot() reports their
        change over this instance's lifetime."""
        with self._lock:
            if self._prefix_base is None:
                self._prefix_base = (int(hits), int(misses))
            self._prefix_last = (int(hits), int(misses))

    def on_prefill_chunk(self):
        """One prefill-chunk program ran (one per chunk, not per prompt)."""
        with self._lock:
            self._prefill_chunks += 1

    def on_prefill(self):
        """One admission's prefill completed (its first token exists)."""
        with self._lock:
            self._prefills += 1

    def on_wave(self, n_active, wave_s=None, flops=None,
                bytes_accessed=None):
        """One dispatched decode wave with `n_active` lanes in it.
        `wave_s` (its wall time, also in the phase split) and `flops` /
        `bytes_accessed` (the program's cost) feed the JAX package's
        roofline gauges, which are not ported: taken and unused."""
        with self._lock:
            self._waves += 1
            self._active_slot_waves += int(n_active)

    def on_token(self, t_now, prev_t=None):
        """One streamed token; `prev_t` is the same request's previous
        token time (None for its first), so the gap is a TPOT sample."""
        with self._lock:
            self._tokens += 1
            if prev_t is not None:
                self._tpot.append(t_now - prev_t)
            if self._first_token_time is None:
                self._first_token_time = t_now
            self._last_token_time = t_now

    def on_spec(self, proposed, accepted):
        """One speculative wave's draft economics: proposed = the sum of
        the lanes' spec_len, accepted = the draft tokens the acceptance
        kept (the correction or bonus token is never a draft's)."""
        with self._lock:
            self._spec_proposed += int(proposed)
            self._spec_accepted += int(accepted)
            self._spec_waves += 1

    def on_complete(self, request):
        with self._lock:
            self._completed += 1
            if request.ttft is not None:
                self._ttft.append(request.ttft)
            if request.latency is not None:
                self._latency.append(request.latency)

    # ---------------------------------------------------------- reporting
    def snapshot(self):
        """Point-in-time summary dict."""
        with self._lock:
            span = (None if self._first_token_time is None
                    else self._last_token_time - self._first_token_time)
            if self._prefix_base is None:
                p_hits = p_misses = 0
            else:
                p_hits = self._prefix_last[0] - self._prefix_base[0]
                p_misses = self._prefix_last[1] - self._prefix_base[1]
            blk_used, blk_total = (self._block_used_rounds,
                                   self._block_total_rounds)
            return {
                "requests_submitted": self._submitted,
                "requests_completed": self._completed,
                "rejected": self._rejected,
                "tokens_generated": self._tokens,
                "tokens_per_s": (self._tokens / span if span else None),
                "decode_waves": self._waves,
                "prefill_chunks": self._prefill_chunks,
                "prefills": self._prefills,
                "slot_occupancy": (self._active_slot_waves
                                   / (self._waves * self.num_slots)
                                   if self._waves else 0.0),
                "ttft_p50_s": _percentile(self._ttft, 50),
                "ttft_p99_s": _percentile(self._ttft, 99),
                "tpot_p50_s": _percentile(self._tpot, 50),
                "tpot_p99_s": _percentile(self._tpot, 99),
                "latency_p50_s": _percentile(self._latency, 50),
                "latency_p99_s": _percentile(self._latency, 99),
                "faults": dict(self._faults),
                "wave_retries": self._wave_retries,
                "queue_depth_peak": self._queue_peak,
                "phase_seconds": dict(self._phase_seconds),
                "first_token_time": self._first_token_time,
                "last_token_time": self._last_token_time,
                # paged pool (None / 0 on the dense engine)
                "block_utilization": (blk_used / blk_total if blk_total
                                      else None),
                "prefix_hits": p_hits,
                "prefix_misses": p_misses,
                "prefix_hit_rate": (p_hits / (p_hits + p_misses)
                                    if p_hits + p_misses else None),
                # 0 / None on engines without a draft model
                "spec_tokens_proposed": self._spec_proposed,
                "spec_tokens_accepted": self._spec_accepted,
                "spec_acceptance_rate": (
                    self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else None),
                "spec_accepted_per_wave": (
                    self._spec_accepted / self._spec_waves
                    if self._spec_waves else None),
            }
