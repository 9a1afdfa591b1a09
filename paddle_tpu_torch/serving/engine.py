"""ServingEngine base: slot-based continuous batching state and the
decode wave (the port of `paddle_tpu/serving/engine.py`).

The engine owns `num_slots` decode slots. Slot bookkeeping (positions,
tokens, sampling knobs, block tables) is host-authoritative. Every input
of a program lives in a device buffer allocated once per engine
(`StaticInputs`): before each run the host writes the values into one
pinned staging buffer and one host-to-device copy moves them; the
[S, V] logit-bias matrix moves only the rows that changed. A wave ends
with one device-to-host read of its tokens and finite flags, the one
unavoidable sync per wave (the tokens are the product being streamed).

Each program — the decode wave here, the prefill chunk in the paged
engine — reads only those buffers and writes its own output tensors
(`Program`). With `cuda_graph=True` (the default; the JAX package's
`jit_compile`) an engine on the card runs each program as one CUDA graph
per key, the key being whether a lane samples: the first call with a key
runs eagerly on a side stream, the second captures and replays, every
later call replays. A greedy stream thus holds one decode and one
prefill graph (`decode_compiles`, `prefill_compiles`), the JAX package's
compile-once contract. A capture that fails raises; nothing falls back
to the eager program. On the CPU, or with `cuda_graph=False`, the same
program functions run eagerly and both counters stay 0.

The KV pools are updated in place by the model's scatters: there is no
donation. Sampling draws its Gumbel noise inside the program from a
`torch.Generator` seeded with `seed` and registered with every graph, so
each replay draws fresh noise and a fresh engine with the same seed
replays sampled streams; it does not reproduce JAX's bits.

The dense engine's own prefill needs flash-attention kernel K1 and is not
ported yet; `PagedServingEngine` (serving/paged) is the engine this slice
serves with.
"""
import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

_NEG = -1e9     # the logit-bias "forbidden" value and the filter fill
_NUMPY = {torch.int64: np.int64, torch.int32: np.int32,
          torch.float32: np.float32, torch.bool: np.bool_}


def _infer_cache_dtype(model):
    """Majority floating dtype of the parameters: a bf16 model gets bf16
    KV pools (halving the bytes that bound decode), an f32 model f32."""
    counts = {}
    for p in model.parameters():
        if p.dtype in (torch.bfloat16, torch.float16, torch.float32):
            counts[p.dtype] = counts.get(p.dtype, 0) + p.numel()
    low = {d: c for d, c in counts.items() if d != torch.float32}
    if low and sum(low.values()) > counts.get(torch.float32, 0):
        return max(low, key=low.get)
    return torch.float32


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


def _gumbel_(buf, gen):
    """Fill `buf` in place with Gumbel(0, 1) noise from `gen`: torch.rand's
    uniform draw, then -log(-log(u))."""
    buf.uniform_(0, 1, generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    return buf.clamp_(min=tiny).log_().neg_().log_().neg_()


class StaticInputs:
    """The input buffers of one engine program, allocated once and never
    replaced: a CUDA graph replays on the addresses it captured.

    `fields` [(name, dtype, shape)] are typed views (`tensors[name]`) of
    one device byte buffer, written through numpy views (`host[name]`)
    of one pinned host byte buffer and moved by one copy per run:
    `stage()` returns the host views once the previous run's copy has
    read them (a run that ends without a sync may still be queued behind
    it), `upload()` enqueues the copy. `add` registers a device buffer
    the program reads that moves by other means (the logit bias, the
    Gumbel noise the program draws)."""

    def __init__(self, fields, device):
        spans, size = {}, 0
        for name, dtype, shape in fields:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            spans[name] = (size, size + nbytes)
            size += -(-nbytes // 16) * 16
        self.device = device
        self._dev = torch.empty(size, dtype=torch.uint8, device=device)
        self._host = torch.empty(size, dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        raw = self._host.numpy()
        self.host, self.tensors = {}, {}
        for name, dtype, shape in fields:
            a, b = spans[name]
            self.host[name] = raw[a:b].view(_NUMPY[dtype]).reshape(shape)
            self.tensors[name] = self._dev[a:b].view(dtype).reshape(shape)
        self._copied = None

    def add(self, name, tensor):
        self.tensors[name] = tensor

    def stage(self):
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        return self.host

    def upload(self):
        self._dev.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()


class _Graph:
    """One captured program: the graph, its output tensors, the kernel
    launches it holds (by `kernels.launch_counts` key) and its replays."""

    def __init__(self, graph, outs, launches):
        self.graph = graph
        self.outs = outs
        self.launches = launches
        self.replays = 0


class Program:
    """One engine program, `fn(key)` over the engine's static buffers,
    returning its output tensors. Eager on the CPU or with
    `cuda_graph=False`. Otherwise one CUDA graph per key, captured as
    `jit.TrainStep` captures a step: the first call with a key runs `fn`
    eagerly on a side stream, the second captures it (the generator
    registered, so every replay draws fresh noise) and replays, every
    later call replays and returns the graph's own output tensors, which
    the next replay overwrites. `graphs` maps each key to its `_Graph`
    (None after its eager first call). The graphs of one program share a
    memory pool; each engine program has its own."""

    def __init__(self, name, fn, device, cuda_graph, generator):
        self.name = name
        self._fn = fn
        self._device = device
        self._generator = generator
        self.graphed = bool(cuda_graph) and device.type == "cuda"
        self.graphs = {}
        self._pool = None

    @property
    def compiles(self):
        return sum(g is not None for g in self.graphs.values())

    @property
    def replays(self):
        return sum(g.replays for g in self.graphs.values() if g is not None)

    def __call__(self, key):
        with torch.profiler.record_function(self.name):
            if not self.graphed:
                return self._fn(key)
            if key not in self.graphs:
                self.graphs[key] = None
                return self._warm_up(key)
            g = self.graphs[key]
            if g is None:
                g = self.graphs[key] = self._capture(key)
            g.graph.replay()
            g.replays += 1
            return g.outs

    def _warm_up(self, key):
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outs = self._fn(key)
        current.wait_stream(side)
        return outs

    def _capture(self, key):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outs = self._fn(key)
        except Exception as exc:
            raise RuntimeError(f"{self.name}: CUDA-graph capture failed: "
                               f"{exc}") from exc
        after = kernels.launch_counts()
        if self._pool is None:
            self._pool = graph.pool()
        return _Graph(graph, outs,
                      {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)})


class ServingEngine:
    """Fixed-shape batched decode executor. The Scheduler decides WHICH
    request occupies which slot and when; the engine only knows slots.

    model: a causal LM exposing decode_step (GPTForPretraining).
    num_slots: concurrent sequences per wave.
    max_len: per-slot horizon (prompt + generated tokens).
    device: where the engine runs; None = the CUDA card (RuntimeError
        when there is none — pass device="cpu" for the host).
    cuda_graph: on the card, run each program as CUDA-graph replays
        (the default; the inference Config's `ir_optim`); False runs
        them eagerly. The CPU always runs them eagerly.
    """

    def __init__(self, model, num_slots=4, max_len=256, cache_dtype=None,
                 seed=0, device=None, cuda_graph=True):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model.eval()
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.cache_dtype = (cache_dtype if cache_dtype is not None
                            else _infer_cache_dtype(model))
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
        self._slot_bias = np.zeros((S, self.vocab_size), np.float32)
        self._slot_bias_nonzero = [False] * S
        # rows of the device bias matrix to copy before the next wave
        # (the common case is all zeros and no copy)
        self._bias_dirty = set()
        # admissions mid-prefill (slot -> engine-specific state)
        self._pending_prefill = {}
        self.last_nonfinite_slots = []
        self.last_starved_slots = []
        # programs run (each decode wave and each prefill chunk is one
        # pass through every layer: eager, or one graph replay)
        self.decode_waves_run = 0
        self.prefill_chunks_run = 0
        self.cuda_graph = bool(cuda_graph)
        self.wave_inputs = StaticInputs(self._wave_fields(), self.device)
        for name in ("bias", "gumbel"):
            self.wave_inputs.add(name, torch.zeros(
                (S, self.vocab_size), device=self.device))
        self.wave_program = Program("serving.decode_wave",
                                    self._wave_program, self.device,
                                    cuda_graph, self._gen)
        # f32 logits [S, V] of the latest wave: the program's output,
        # overwritten by the next wave
        self.last_wave_logits = None

    @property
    def decode_compiles(self):
        """CUDA graphs captured for the decode wave: 1 over a greedy
        stream, 2 once a lane has sampled; 0 on the eager path."""
        return self.wave_program.compiles

    def _wave_fields(self):
        """(name, dtype, shape) of the wave's staged inputs."""
        S = self.num_slots
        return [("tok", torch.int64, (S,)), ("pos", torch.int64, (S,)),
                ("top_k", torch.int64, (S,)), ("temps", torch.float32, (S,)),
                ("top_p", torch.float32, (S,)), ("active", torch.bool, (S,)),
                ("sample", torch.bool, (S,))]

    def _make_caches(self):
        raise NotImplementedError(
            "the dense ServingEngine, its KV cache and GPT prefill are not "
            "ported yet (ROADMAP Queue 1 item 3: dense ServingEngine and "
            "prefill); use serving.PagedServingEngine")

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

    def _sampling_state(self, do_sample, temperature, top_k, top_p,
                        logit_bias):
        return {"sample": bool(do_sample), "temp": float(temperature),
                "top_k": int(top_k), "top_p": float(top_p),
                "bias": self._normalize_bias(logit_bias)}

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
        sampled = any(s and a for s, a in zip(self.slot_sample, active_now))
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
        gumbel = _gumbel_(w["gumbel"], self._gen) if sampled else None
        lo = self._wave_logits(w)
        nxt, _, finite = _select_wave_tokens(
            lo, w["tok"], w["pos"], w["active"], w["sample"], w["temps"],
            w["top_k"], w["top_p"], w["bias"], gumbel)
        return torch.cat([nxt, finite.long()]), lo

    def _wave_logits(self, w):
        """f32 logits [S, V] of one decode step over the wave buffers."""
        raise NotImplementedError

    def slot_full(self, slot):
        """True when the slot's next write would fall past the horizon."""
        return self.slot_pos[slot] >= self.max_len

    def retire_slot(self, slot):
        """Free a slot between waves (also aborts a mid-prefill
        admission parked on it)."""
        self.slot_active[slot] = False
        self.slot_sample[slot] = False
        self.slot_temp[slot] = 1.0
        self.slot_top_k[slot] = 0
        self.slot_top_p[slot] = 1.0
        self._set_bias_row(slot, np.zeros((self.vocab_size,), np.float32))
        self._pending_prefill.pop(slot, None)
