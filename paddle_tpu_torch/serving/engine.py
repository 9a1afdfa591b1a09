"""ServingEngine base: slot-based continuous batching state and the
decode wave (the port of `paddle_tpu/serving/engine.py`).

The engine owns `num_slots` decode slots. Slot bookkeeping (positions,
tokens, sampling knobs) is host-authoritative: a handful of tiny [S]
uploads per wave, and one device-to-host read of the wave's tokens and
finite flags, which is the one unavoidable sync per wave (the tokens are
the product being streamed).

The wave runs eagerly: there is no jit and no donation. The KV pools are
updated in place by the model's scatters. Sampling draws its Gumbel noise
from a `torch.Generator` seeded with `seed`, so a fresh engine with the
same seed replays sampled streams; it does not reproduce JAX's bits.

The dense engine's own prefill needs flash-attention kernel K1 and is not
ported yet; `PagedServingEngine` (serving/paged) is the engine this slice
serves with.
"""
import numpy as np
import torch

from ..device import resolve_device

_NEG = -1e9     # the logit-bias "forbidden" value and the filter fill


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
    neg = torch.tensor(_NEG, dtype=lo.dtype, device=lo.device)
    probs = torch.softmax(torch.where(in_k, sorted_lo, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = ((cum - probs) < top_p[:, None]) | (top_p >= 1.0)[:, None]
    keep_sorted[:, 0] = True
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
    same temperature/top-k/top-p/bias as the decode tail."""
    lo = lo + bias
    if not sample:
        return torch.argmax(lo)
    scaled = (lo / max(float(temp), 1e-6))[None, :]
    knob_k = torch.tensor([int(top_k)], device=lo.device)
    knob_p = torch.tensor([float(top_p)], device=lo.device)
    return _sample(scaled, knob_k, knob_p, gumbel[None, :])[0]


class ServingEngine:
    """Fixed-shape batched decode executor. The Scheduler decides WHICH
    request occupies which slot and when; the engine only knows slots.

    model: a causal LM exposing decode_step (GPTForPretraining).
    num_slots: concurrent sequences per wave.
    max_len: per-slot horizon (prompt + generated tokens).
    device: where the engine runs; None = the CUDA card (RuntimeError
        when there is none — pass device="cpu" for the host).
    """

    def __init__(self, model, num_slots=4, max_len=256, cache_dtype=None,
                 seed=0, device=None):
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
        # device copy of the [S, V] bias matrix, re-uploaded only when a
        # row changes (the common case is all zeros)
        self._slot_bias_dev = None
        self._slot_bias_nonzero = [False] * S
        # admissions mid-prefill (slot -> engine-specific state)
        self._pending_prefill = {}
        self.last_nonfinite_slots = []
        self.last_starved_slots = []
        # programs run (each decode wave and each prefill chunk is one
        # eager pass through every layer)
        self.decode_waves_run = 0
        self.prefill_chunks_run = 0

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
            self._slot_bias_dev = None
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

    def _gumbel(self, shape):
        """Gumbel(0, 1) noise from the engine's generator."""
        u = torch.rand(shape, generator=self._gen, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

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
        dev = self.device
        if self._slot_bias_dev is None:
            self._slot_bias_dev = torch.tensor(self._slot_bias, device=dev)
        sample = torch.tensor(self.slot_sample, device=dev)
        gumbel = (self._gumbel((self.num_slots, self.vocab_size))
                  if any(s and a for s, a in zip(self.slot_sample,
                                                 active_now)) else None)
        tok, finite = self._run_wave(
            active_now,
            torch.tensor(self.slot_tok, dtype=torch.long, device=dev),
            torch.tensor(self.slot_pos, dtype=torch.long, device=dev),
            torch.tensor(active_now, device=dev), sample,
            torch.tensor(self.slot_temp, dtype=torch.float32, device=dev),
            torch.tensor(self.slot_top_k, device=dev),
            torch.tensor(self.slot_top_p, dtype=torch.float32, device=dev),
            self._slot_bias_dev, gumbel)
        self.decode_waves_run += 1
        # the one device->host sync of the wave
        host = torch.cat([tok, finite.long()]).tolist()
        tok, finite = host[:self.num_slots], host[self.num_slots:]
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

    def _run_wave(self, active_now, tok, pos, active, sample, temps, top_k,
                  top_p, bias, gumbel):
        """Run the model over every lane and select tokens; returns the
        device tensors (next tokens [S], finite [S])."""
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
