"""ServingEngine: slot-based continuous batching over a dense KV cache
(the port of `paddle_tpu/serving/engine.py`), and the base of the paged
engine.

The dense cache is one [num_slots, heads, max_len, head_dim] pair per
layer. An admission pads the prompt to the `prefill_len` bucket and runs
the model's `prefill` (flash attention, K1 on the card) once: its
frontier logits give the first token and the slot's cache row is
copied into the batched caches at a device index, so every slot shares
one prefill program. A retired slot's row is left as is: the next
prefill overwrites it, and the decode frontier rewrites each position
before the ks <= pos mask exposes it.

The engine owns `num_slots` decode slots. Slot bookkeeping (positions,
tokens, sampling knobs, block tables) is host-authoritative. Every input
of a program lives in a device buffer allocated once per engine
(`graphs.StaticInputs`): before each run the host writes the values
into one pinned staging buffer and one host-to-device copy moves them;
the [S, V] logit-bias matrix moves only the rows that changed. A wave ends
with one device-to-host read of its tokens and finite flags, the one
unavoidable sync per wave (the tokens are the product being streamed).

Each program — the decode wave, and the prefill (the whole bucket here,
one chunk in the paged engine) — reads only those buffers and writes
its own output tensors (`graphs.Program`). With `cuda_graph=True` (the
default; the JAX package's `jit_compile`) an engine on the card runs
each program as one CUDA graph per key, the key being whether a lane
samples: the first call with a key runs eagerly on a side stream, the
second captures and replays, every later call replays. A greedy stream
thus holds one decode and one prefill graph (`decode_compiles`,
`prefill_compiles`), the JAX package's compile-once contract. A
capture that fails raises; nothing falls back to the eager program. On
the CPU, or with `cuda_graph=False`, the same program functions run
eagerly and both counters stay 0.

The KV caches and pools are updated in place by the model's scatters:
there is no donation. Sampling draws its Gumbel noise inside the program from a
`torch.Generator` seeded with `seed` and registered with every graph, so
each replay draws fresh noise and a fresh engine with the same seed
replays sampled streams; it does not reproduce JAX's bits.
"""
import numpy as np
import torch

from ..device import resolve_device
from ..graphs import Program, StaticInputs
from ..nn.decode import gumbel_
from ..nn.transformer import infer_cache_dtype

_NEG = -1e9     # the logit-bias "forbidden" value and the filter fill

HEALTH_STATES = ("ok", "degraded", "draining")


def _filter_top_k_top_p(lo, top_k, top_p):
    """Per-row top-k then nucleus filtering of temperature-scaled logits
    [S, V] with per-row knobs top_k [S] (<= 0 = off) and top_p [S]
    (>= 1 = off). Top-k keeps the kth value and its ties; top-p keeps the
    smallest prefix of the renormalised top-k survivors whose cumulative
    probability reaches p (the best token always kept). Filtered logits
    become -1e9; disabled rows pass through unchanged."""
    v = lo.shape[-1]
    sort_idx = torch.argsort(-lo, dim=-1, stable=True)
    sorted_lo = torch.gather(lo, -1, sort_idx)
    kth = torch.gather(sorted_lo, -1,
                       (torch.clamp(top_k, 1, v) - 1).long()[:, None])
    in_k = (sorted_lo >= kth) | (top_k <= 0)[:, None]
    # a fill, not a host-to-device copy: the wave is captured in a graph
    neg = torch.full((), _NEG, dtype=lo.dtype, device=lo.device)
    probs = torch.softmax(torch.where(in_k, sorted_lo, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = ((cum - probs) < top_p[:, None]) | (top_p >= 1.0)[:, None]
    keep_sorted[:, 0].fill_(True)
    keep_sorted &= in_k
    inv = torch.argsort(sort_idx, dim=-1)
    keep = torch.gather(keep_sorted, -1, inv)
    return torch.where(keep, lo, neg)


def _sample(scaled, top_k, top_p, gumbel):
    """Categorical draw as argmax(filtered logits + Gumbel noise) — the
    same construction `jax.random.categorical` uses, so tests that hand
    both sides the same noise compare token for token."""
    return torch.argmax(_filter_top_k_top_p(scaled, top_k, top_p) + gumbel,
                        dim=-1)


def _select_wave_tokens(lo, tok, pos, active, sample, temps, top_k, top_p,
                        bias, gumbel):
    """The decode wave's token selection over f32 logits [S, V]. `bias`
    [S, V] is the per-slot logit-bias/token-mask row; greedy lanes take
    the argmax of the biased logits; sampling lanes draw with `gumbel`
    [S, V] (None when no lane samples). The non-finite sentinel comes
    back as one [S] bool with the tokens; lanes that are inactive or
    non-finite keep their token and position."""
    lo = lo + bias
    finite = torch.isfinite(lo).all(dim=-1)
    nxt = torch.argmax(lo, dim=-1)
    if gumbel is not None:
        scaled = lo / torch.clamp(temps, min=1e-6)[:, None]
        nxt = torch.where(sample, _sample(scaled, top_k, top_p, gumbel),
                          nxt)
    ok = active & finite
    nxt = torch.where(ok, nxt, tok.long())
    new_pos = torch.where(ok, pos + 1, pos)
    return nxt, new_pos, finite


def _select_first_token(lo, sample, temp, top_k, top_p, bias, gumbel):
    """First-token selection from the prefill's frontier logits [V]: the
    same temperature/top-k/top-p/bias as the decode tail. The knobs are
    0-d device tensors (host scalars are taken too); `gumbel` [V] is None
    when the request does not sample, and the pick is then the greedy
    one."""
    lo = lo + bias
    greedy = torch.argmax(lo)
    if gumbel is None:
        return greedy
    sample, temp, top_k, top_p = (torch.as_tensor(x, device=lo.device)
                                  for x in (sample, temp, top_k, top_p))
    scaled = (lo / torch.clamp(temp, min=1e-6))[None, :]
    sampled = _sample(scaled, top_k.reshape(1), top_p.reshape(1),
                      gumbel[None, :])[0]
    return torch.where(sample, sampled, greedy)


class ServingEngine:
    """Fixed-shape batched decode executor. The Scheduler decides WHICH
    request occupies which slot and when; the engine only knows slots.

    model: a causal LM exposing init_cache / prefill / decode_step /
        prefill_route (nlp.GPTForPretraining, nlp.LlamaForCausalLM).
    num_slots: concurrent sequences per wave.
    max_len: per-slot horizon (prompt + generated tokens).
    prefill_len: prompt padding bucket (<= max_len; default max_len).
        One bucket => one prefill program for every prompt length.
    device: where the engine runs; None = the CUDA card (RuntimeError
        when there is none — pass device="cpu" for the host).
    cuda_graph: on the card, run each program as CUDA-graph replays
        (the default; the inference Config's `ir_optim`); False runs
        them eagerly. The CPU always runs them eagerly.
    """

    _WAVE_NAME = "serving.decode_wave"
    _PREFILL_NAME = "serving.prefill"

    def __init__(self, model, num_slots=4, max_len=256, prefill_len=None,
                 cache_dtype=None, seed=0, device=None, cuda_graph=True):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.prefill_len = int(prefill_len or max_len)
        if self.prefill_len > max_len:
            raise ValueError(f"prefill_len {self.prefill_len} > max_len "
                             f"{max_len}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model.eval()
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.cache_dtype = (cache_dtype if cache_dtype is not None
                            else infer_cache_dtype(model))
        self._caches = self._make_caches()
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)

        S = self.num_slots
        self.vocab_size = int(model.cfg.vocab_size)
        self.slot_active = [False] * S
        self.slot_pos = [0] * S        # next cache write position
        self.slot_tok = [0] * S        # token fed to the next wave
        self.slot_sample = [False] * S
        self.slot_temp = [1.0] * S
        self.slot_top_k = [0] * S
        self.slot_top_p = [1.0] * S
        # a lane whose bias row is a token_mask the scheduler refreshes
        # every wave: a speculative engine drafts nothing for it
        self.slot_dynamic_mask = [False] * S
        self._slot_bias = np.zeros((S, self.vocab_size), np.float32)
        self._slot_bias_nonzero = [False] * S
        # rows of the device bias matrix to copy before the next wave
        # (the common case is all zeros and no copy)
        self._bias_dirty = set()
        # admissions mid-prefill (slot -> engine-specific state)
        self._pending_prefill = {}
        self.last_nonfinite_slots = []
        self.last_starved_slots = []
        self.health_state = "ok"
        # the scheduler's queue-depth probe and an optional dict-returning
        # probe merged into health() (newest wins for each)
        self._queue_depth_fn = None
        self._health_probe_fn = None
        # slot -> (trace_id, trace_pid) of the admitted request
        self._slot_trace = {}
        # draft tokens proposed and accepted by the latest wave: None for
        # an engine that drafts nothing (SpeculativePagedEngine counts)
        self.last_spec_proposed = self.last_spec_accepted = None
        # programs run (each decode wave and each prefill chunk is one
        # pass through every layer: eager, or one graph replay)
        self.decode_waves_run = 0
        self.prefill_chunks_run = 0
        self.cuda_graph = bool(cuda_graph)
        self.wave_inputs = StaticInputs(self._wave_fields(), self.device)
        for name in ("bias", "gumbel"):
            self.wave_inputs.add(name, torch.zeros(
                (S, self.vocab_size), device=self.device))
        self.wave_program = Program(self._WAVE_NAME, self._wave_program,
                                    self.device, cuda_graph, [self._gen])
        # f32 logits [S, V] of the latest wave: the program's output,
        # overwritten by the next wave
        self.last_wave_logits = None
        self._prefill_bias_nonzero = False
        self.prefill_inputs = StaticInputs(self._prefill_fields(),
                                           self.device)
        for name in ("bias", "gumbel"):
            self.prefill_inputs.add(name, torch.zeros(
                (self.vocab_size,), device=self.device))
        self.prefill_program = Program(self._PREFILL_NAME,
                                       self._prefill_program, self.device,
                                       cuda_graph, [self._gen])
        # f32 frontier logits [V] of the latest prefill (the program's
        # output, overwritten by the next one)
        self.last_prefill_logits = None

    @property
    def decode_compiles(self):
        """CUDA graphs captured for the decode wave: 1 over a greedy
        stream, 2 once a lane has sampled; 0 on the eager path."""
        return self.wave_program.compiles

    @property
    def prefill_compiles(self):
        """CUDA graphs captured for the prefill: 1 over a greedy stream;
        0 on the eager path."""
        return self.prefill_program.compiles

    @property
    def prefill_route(self):
        """How the prefill bucket is computed: "k1" (flash attention's
        kernel route) or "dense" (see the model's prefill_route)."""
        return self.model.prefill_route(self.prefill_len)

    def describe(self):
        """The engine's construction config."""
        return {"engine": "dense", "num_slots": self.num_slots,
                "max_len": self.max_len, "prefill_len": self.prefill_len,
                "seed": self.seed,
                "cache_dtype": str(self.cache_dtype).split(".")[-1]}

    def _wave_fields(self):
        """(name, dtype, shape) of the wave's staged inputs."""
        S = self.num_slots
        return [("tok", torch.int64, (S,)), ("pos", torch.int64, (S,)),
                ("top_k", torch.int64, (S,)), ("temps", torch.float32, (S,)),
                ("top_p", torch.float32, (S,)), ("active", torch.bool, (S,)),
                ("sample", torch.bool, (S,))]

    def _prefill_fields(self):
        """(name, dtype, shape) of the prefill's staged inputs."""
        return [("prompt", torch.int64, (1, self.prefill_len)),
                ("slot", torch.int64, (1,)), ("frontier", torch.int64, ()),
                ("sample", torch.bool, ()), ("temp", torch.float32, ()),
                ("top_k", torch.int64, ()), ("top_p", torch.float32, ())]

    def _make_caches(self):
        return self.model.init_cache(self.num_slots, self.max_len,
                                     dtype=self.cache_dtype)

    # ------------------------------------------------------------ health
    def attach_queue_probe(self, fn):
        """Register the scheduler's zero-arg queue-depth callable, read by
        health(). The newest scheduler wins."""
        self._queue_depth_fn = fn

    def attach_health_probe(self, fn):
        """Register a zero-arg dict-returning callable merged into
        health() (an SLO verdict, alert state). Newest wins."""
        self._health_probe_fn = fn

    def set_slot_trace(self, slot, trace_id, trace_pid=0):
        """Record the admitted request's trace context on its slot
        (cleared at retirement)."""
        self._slot_trace[slot] = (int(trace_id), int(trace_pid))

    def set_health_state(self, state):
        """ok | degraded | draining: the scheduler sets it, so health()
        reports the engine's real state."""
        if state not in HEALTH_STATES:
            raise ValueError(f"health state must be one of "
                             f"{HEALTH_STATES}, got {state!r}")
        self.health_state = state

    def _health(self):
        qfn = self._queue_depth_fn
        h = {
            "status": self.health_state,
            "num_slots": self.num_slots,
            "slots_active": len(self.active_slots()),
            "queue_depth": int(qfn()) if qfn is not None else 0,
            "max_len": self.max_len,
            "decode_compiles": self.decode_compiles,
            "prefill_compiles": self.prefill_compiles,
        }
        if self._health_probe_fn is not None:
            h.update(self._health_probe_fn() or {})
        return h

    def health(self):
        """The engine's health payload: status, load, compile counts."""
        return self._health()

    # ------------------------------------------------------------- slots
    def free_slots(self):
        return [i for i, a in enumerate(self.slot_active)
                if not a and i not in self._pending_prefill]

    def active_slots(self):
        return [i for i, a in enumerate(self.slot_active) if a]

    def prefilling_slots(self):
        return sorted(self._pending_prefill)

    def _normalize_bias(self, logit_bias):
        """One [V] float32 bias row from None, a {token_id: bias} dict, or
        a [V] array (a bool array is an ALLOWED mask: False -> -1e9)."""
        row = np.zeros((self.vocab_size,), np.float32)
        if logit_bias is None:
            return row
        if isinstance(logit_bias, dict):
            for t, v in logit_bias.items():
                row[int(t)] = float(v)
            return row
        arr = np.asarray(logit_bias)
        if arr.shape != (self.vocab_size,):
            raise ValueError(f"logit bias/mask must be [{self.vocab_size}] "
                             f"(vocab), got {arr.shape}")
        if arr.dtype == bool:
            return np.where(arr, 0.0, _NEG).astype(np.float32)
        return arr.astype(np.float32)

    def set_slot_bias(self, slot, bias, dynamic=True):
        """Replace the slot's logit-bias / token-mask row between waves
        (the scheduler's per-wave token_mask refresh). The row reaches
        the wave's static bias buffer by an in-place copy before the next
        run. `dynamic` keeps a speculative engine from drafting ahead of
        the lane."""
        self._set_bias_row(slot, self._normalize_bias(bias))
        self.slot_dynamic_mask[slot] = bool(dynamic)

    def _set_bias_row(self, slot, row):
        nonzero = bool(np.any(row))
        if nonzero or self._slot_bias_nonzero[slot]:
            self._bias_dirty.add(slot)
        self._slot_bias[slot] = row
        self._slot_bias_nonzero[slot] = nonzero

    def _arm_slot(self, slot, first, n, sampling):
        """Post-prefill arming: the request's sampling surface becomes
        per-slot state for the next wave."""
        self.slot_active[slot] = True
        self.slot_pos[slot] = n
        self.slot_tok[slot] = first
        self.slot_sample[slot] = bool(sampling["sample"])
        self.slot_temp[slot] = float(sampling["temp"])
        self.slot_top_k[slot] = int(sampling["top_k"])
        self.slot_top_p[slot] = float(sampling["top_p"])
        self._set_bias_row(slot, sampling["bias"])
        self.slot_dynamic_mask[slot] = sampling["dynamic_mask"]

    def _sampling_state(self, do_sample, temperature, top_k, top_p,
                        logit_bias, dynamic_mask=False):
        return {"sample": bool(do_sample), "temp": float(temperature),
                "top_k": int(top_k), "top_p": float(top_p),
                "bias": self._normalize_bias(logit_bias),
                "dynamic_mask": bool(dynamic_mask)}

    # --------------------------------------------------------- admission
    def validate_prompt(self, prompt):
        """Admission check: the prompt must fit the prefill bucket and
        leave room to decode at least one token under the horizon."""
        n = len(prompt)
        if n > self.prefill_len:
            return (f"prompt length {n} exceeds the prefill bucket "
                    f"{self.prefill_len} (engine prefill_len)")
        if n + 1 > self.max_len:
            return (f"prompt length {n} leaves no room to decode under "
                    f"max_len {self.max_len}")
        return None

    def begin_prefill(self, slot, prompt, do_sample=False, temperature=1.0,
                      top_k=0, top_p=1.0, logit_bias=None,
                      dynamic_mask=False):
        """Stage an admission on the slot; the work runs in prefill_step,
        which completes the dense prefill in one step. `dynamic_mask`
        flags a bias row the scheduler refreshes every wave."""
        why = self.validate_prompt(prompt)
        if why:
            raise ValueError(why)
        if self.slot_active[slot] or slot in self._pending_prefill:
            raise RuntimeError(f"slot {slot} is busy")
        self._pending_prefill[slot] = (
            list(prompt), self._sampling_state(do_sample, temperature,
                                               top_k, top_p, logit_bias,
                                               dynamic_mask))

    def prefill_step(self, slot):
        """Run the slot's staged admission. Returns its first token."""
        prompt, st = self._pending_prefill.pop(slot)
        return self.prefill_slot(slot, prompt, do_sample=st["sample"],
                                 temperature=st["temp"], top_k=st["top_k"],
                                 top_p=st["top_p"], logit_bias=st["bias"],
                                 dynamic_mask=st["dynamic_mask"])

    def prefill_slot(self, slot, prompt, do_sample=False, temperature=1.0,
                     top_k=0, top_p=1.0, logit_bias=None, dynamic_mask=False):
        """Admit a prompt into a free slot: run the prefill program (the
        slot index, the prompt and the knobs staged into its buffers),
        arm the slot for the next wave. Returns the first token."""
        why = self.validate_prompt(prompt)
        if why:
            raise ValueError(why)
        if self.slot_active[slot]:
            raise RuntimeError(f"slot {slot} is busy")
        sampling = self._sampling_state(do_sample, temperature, top_k,
                                        top_p, logit_bias, dynamic_mask)
        n = len(prompt)
        host = self.prefill_inputs.stage()
        host["prompt"][...] = 0
        host["prompt"][0, :n] = prompt
        host["slot"][...] = slot
        host["frontier"][...] = n - 1
        self._stage_sampling(host, sampling, sampling["sample"])
        first, self.last_prefill_logits = self.prefill_program(
            sampling["sample"])
        self.prefill_chunks_run += 1
        first = int(first.item())
        self._arm_slot(slot, first, n, sampling)
        return first

    def _stage_sampling(self, host, sampling, sampled, move_bias=True):
        """Write the first-token knobs and upload the staged prefill
        inputs. With move_bias (a run whose selection is read), the bias
        row moves too, when it or the one before is not zero."""
        host["sample"][...] = sampled
        host["temp"][...] = sampling["temp"]
        host["top_k"][...] = sampling["top_k"]
        host["top_p"][...] = sampling["top_p"]
        self.prefill_inputs.upload()
        if not move_bias:
            return
        nonzero = bool(np.any(sampling["bias"]))
        if nonzero or self._prefill_bias_nonzero:
            self.prefill_inputs.tensors["bias"].copy_(
                torch.from_numpy(sampling["bias"]))
        self._prefill_bias_nonzero = nonzero

    def _prefill_program(self, sampled):
        """The bucket's prefill over the static buffers: the model's
        prefill with the frontier at prompt_len - 1, the slot's cache
        rows copied into the batched caches at the staged slot index,
        and the first-token selection (Gumbel noise drawn in place when
        `sampled`). Returns the token (0-d) and the f32 frontier logits
        [V]."""
        p = self.prefill_inputs.tensors
        gumbel = gumbel_(p["gumbel"], self._gen) if sampled else None
        logits, rows = self.model.prefill(p["prompt"], self.max_len,
                                          dtype=self.cache_dtype,
                                          frontier=p["frontier"])
        for (ck, cv), (rk, rv) in zip(self._caches, rows):
            ck.index_copy_(0, p["slot"], rk)
            cv.index_copy_(0, p["slot"], rv)
        lo = logits[0, 0].float()
        return _select_first_token(lo, p["sample"], p["temp"], p["top_k"],
                                   p["top_p"], p["bias"], gumbel), lo

    # ------------------------------------------------------------- waves
    def decode_wave(self):
        """One batched decode step over all slots. Returns {slot: token}
        for the slots that were active this wave AND produced finite
        logits; lanes whose logits went non-finite are excluded, frozen,
        and listed in `last_nonfinite_slots` for the scheduler to retire
        (finish_reason "error")."""
        active_now = list(self.slot_active)
        if not any(active_now):
            self.last_nonfinite_slots = []
            self.last_starved_slots = []
            return {}
        # back each lane's next write (paged engines allocate blocks;
        # starved lanes are dropped and reported for preemption)
        active_now = self._prepare_wave(active_now)
        if not any(active_now):
            self.last_nonfinite_slots = []
            return {}
        sampled = self._upload_wave(active_now)
        picked, self.last_wave_logits = self.wave_program(sampled)
        self.decode_waves_run += 1
        # the one device->host sync of the wave
        read = picked.tolist()
        tok, finite = read[:self.num_slots], read[self.num_slots:]
        out, bad = {}, []
        for s, was_active in enumerate(active_now):
            if not was_active:
                continue
            if not finite[s]:
                bad.append(s)
                continue
            self.slot_pos[s] += 1
            self.slot_tok[s] = int(tok[s])
            out[s] = int(tok[s])
        self.last_nonfinite_slots = bad
        return out

    def _upload_wave(self, active_now):
        """Stage the wave's inputs and enqueue their copy (and the bias
        rows that changed). Returns whether a lane of the wave samples,
        the key of the wave's programs."""
        host = self.wave_inputs.stage()
        host["tok"][:] = self.slot_tok
        host["pos"][:] = self.slot_pos
        host["active"][:] = active_now
        host["sample"][:] = self.slot_sample
        host["temps"][:] = self.slot_temp
        host["top_k"][:] = self.slot_top_k
        host["top_p"][:] = self.slot_top_p
        self._stage_wave(host, active_now)
        self.wave_inputs.upload()
        bias = self.wave_inputs.tensors["bias"]
        for s in sorted(self._bias_dirty):
            bias[s].copy_(torch.from_numpy(self._slot_bias[s]))
        self._bias_dirty.clear()
        return any(s and a for s, a in zip(self.slot_sample, active_now))

    def _prepare_wave(self, active_now):
        self.last_starved_slots = []
        return active_now

    def _stage_wave(self, host, active_now):
        """Write the engine's own staged wave inputs (none here)."""

    def _wave_program(self, sampled):
        """The decode wave over the static buffers: the model over every
        lane, then token selection (Gumbel noise drawn in place when a
        lane samples). Returns the [2S] int64 next tokens and finite
        flags, and the f32 logits [S, V]."""
        w = self.wave_inputs.tensors
        gumbel = gumbel_(w["gumbel"], self._gen) if sampled else None
        lo = self._wave_logits(w)
        nxt, _, finite = _select_wave_tokens(
            lo, w["tok"], w["pos"], w["active"], w["sample"], w["temps"],
            w["top_k"], w["top_p"], w["bias"], gumbel)
        return torch.cat([nxt, finite.long()]), lo

    def _wave_logits(self, w):
        """f32 logits [S, V] of one decode step over the wave buffers:
        every lane writes its K/V at its position (a lane outside the
        wave into its own row, which the next prefill rewrites)."""
        logits, _ = self.model.decode_step(w["tok"][:, None], self._caches,
                                           w["pos"])
        return logits[:, 0, :].float()

    def slot_full(self, slot):
        """True when the slot's next write would fall past the horizon."""
        return self.slot_pos[slot] >= self.max_len

    def retire_slot(self, slot):
        """Free a slot between waves (also aborts a mid-prefill
        admission parked on it). The cache row is left as is."""
        self.slot_active[slot] = False
        self.slot_sample[slot] = False
        self.slot_temp[slot] = 1.0
        self.slot_top_k[slot] = 0
        self.slot_top_p[slot] = 1.0
        self.slot_dynamic_mask[slot] = False
        self._set_bias_row(slot, np.zeros((self.vocab_size,), np.float32))
        self._pending_prefill.pop(slot, None)
        self._slot_trace.pop(slot, None)
