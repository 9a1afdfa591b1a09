"""Request lifecycle for the serving engine (the port of
`paddle_tpu/serving/request.py`, without the chaos and tracing hooks:
`trace_id` and `trace_pid` are recorded, nothing is traced).

A request moves QUEUED -> PREFILL -> DECODE -> DONE (or REJECTED at
admission). Tokens stream to the caller through an optional per-request
callback; timestamps are taken at every transition so TTFT and TPOT
need no extra bookkeeping.
"""
import threading
import time


class RequestState:
    QUEUED = "QUEUED"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    DONE = "DONE"
    REJECTED = "REJECTED"


class Request:
    """One generation request.

    prompt: list/array of int token ids (length >= 1)
    max_tokens: generation budget (>= 1); the engine also stops at the
        cache horizon (finish_reason "length") and at eos_token_id
        ("eos"). timeout (seconds from submit) retires a stuck request
        with "timeout".
    on_token: optional fn(request, token_id) streaming callback; an
        exception it raises is kept in `callback_error` so one client
        cannot break the shared decode loop.
    do_sample / temperature / top_k / top_p: sampling knobs (0 / 1.0 =
        off), applied after temperature by the engine's sampling tail.
    stop_sequences: token-id sequences; the request retires with "stop"
        as soon as its output ends with one of them.
    logit_bias: {token_id: bias} dict, a [V] float array, or a [V] bool
        allowed-mask folded into the logits before selection.
    token_mask: callable(request) -> [V] bool allowed-mask or [V] float
        bias, re-evaluated before every wave (constrained decoding: the
        legal set follows the tokens already emitted). A lane with a
        dynamic mask decodes one token a wave even on a speculative
        engine.
    stop_context: tokens that precede this request's output for stop
        matching (a continuation carries the earlier stream's tail, so
        a stop sequence straddling the seam still fires).
    trace_id: correlation id (default: the request id).
    tenant / priority: QoS cohort and preemption rank; under block
        starvation the scheduler evicts the lowest-priority lane
        strictly below the starved one.
    handoff: a block-level KV payload (PagedServingEngine.export_slot_kv)
        that admission imports instead of running prefill chunks;
        consumed at the first admission.
    """
    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_tokens=16, eos_token_id=None,
                 timeout=None, on_token=None, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, stop_sequences=None,
                 logit_bias=None, token_mask=None, stop_context=None,
                 trace_id=None, tenant="default", priority=0,
                 handoff=None):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        with Request._ids_lock:
            self.request_id = next(Request._ids)
        self.trace_id = (self.request_id if trace_id is None
                         else int(trace_id))
        self.trace_pid = 0
        self.prompt = prompt
        self.max_tokens = int(max_tokens)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.timeout = None if timeout is None else float(timeout)
        self.on_token = on_token
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.stop_sequences = [[int(t) for t in seq]
                               for seq in (stop_sequences or []) if len(seq)]
        self._stop_context = [int(t) for t in (stop_context or [])]
        self.logit_bias = logit_bias
        self.token_mask = token_mask
        self.tenant = str(tenant)
        self.priority = int(priority)
        self.handoff = handoff
        # the engine's seed, stamped by the scheduler at submission
        self.seed = None

        self.state = RequestState.QUEUED
        self.slot = None                 # engine slot while PREFILL/DECODE
        # times this request was preempted by recompute (KV blocks
        # reclaimed under pool pressure, requeued with prompt + output)
        self.preemptions = 0
        # scheduler-private: waiting at the queue head for KV blocks
        self._cache_waiting = False
        self.output_tokens = []
        # eos | stop | max_tokens | length | timeout | error | rejected
        self.finish_reason = None
        self.error = None
        self.callback_error = None
        self.submit_time = None
        self.prefill_time = None
        self.first_token_time = None
        self.last_token_time = None
        self.done_time = None
        self._done_event = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def _mark_submitted(self):
        self.submit_time = time.monotonic()

    def _start_prefill(self, slot):
        self.state = RequestState.PREFILL
        self.slot = slot
        self.prefill_time = time.monotonic()

    def _emit(self, token_id):
        """Record one generated token (the first one comes from prefill)."""
        token_id = int(token_id)
        now = time.monotonic()
        if self.first_token_time is None:
            self.first_token_time = now
        self.last_token_time = now
        self.state = RequestState.DECODE
        self.output_tokens.append(token_id)
        if self.on_token is not None:
            try:
                self.on_token(self, token_id)
            except Exception as e:    # noqa: BLE001 — client code
                self.callback_error = e

    def _finish(self, reason, error=None):
        self.state = RequestState.DONE
        self.finish_reason = reason
        if error is not None:
            self.error = str(error)
        self.slot = None
        self.done_time = time.monotonic()
        self._done_event.set()

    def _fail(self, error):
        """Resolve with finish_reason "error" (the rest of the batch keeps
        decoding)."""
        self._finish("error", error=error)

    def _reject(self, why, raise_error=True):
        """Shed at admission (finish_reason "rejected"); raises to the
        submitting caller by default."""
        self.state = RequestState.REJECTED
        self.finish_reason = "rejected"
        self.error = str(why)
        self.done_time = time.monotonic()
        self._done_event.set()
        if raise_error:
            raise ValueError(why)

    def _timed_out(self):
        return (self.timeout is not None and self.submit_time is not None
                and time.monotonic() - self.submit_time > self.timeout)

    def _hit_stop(self):
        """True when stop_context + output ends with a stop sequence
        (checked after each new token, so a match lying wholly inside
        the context never fires)."""
        out = self._stop_context + self.output_tokens
        return any(len(out) >= len(seq) and out[-len(seq):] == seq
                   for seq in self.stop_sequences)

    # ------------------------------------------------------------ client API
    @property
    def done(self):
        return self.state in (RequestState.DONE, RequestState.REJECTED)

    def wait(self, timeout=None):
        """Block until DONE/REJECTED; False when the wait timed out."""
        return self._done_event.wait(timeout)

    @property
    def ttft(self):
        """Time to first token in seconds (None until it exists)."""
        if self.first_token_time is None or self.submit_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def latency(self):
        if self.done_time is None or self.submit_time is None:
            return None
        return self.done_time - self.submit_time

    @property
    def tpot(self):
        """Mean time-per-output-token in seconds: the inter-token span
        divided by the gap count. None until a second token exists (the
        first token's latency is TTFT, not TPOT)."""
        n = len(self.output_tokens)
        if n < 2 or self.first_token_time is None \
                or self.last_token_time is None:
            return None
        return (self.last_token_time - self.first_token_time) / (n - 1)

    def __repr__(self):
        return (f"Request(id={self.request_id}, state={self.state}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.output_tokens)}/{self.max_tokens}, "
                f"finish={self.finish_reason})")
