#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout (nvcc, sm_90a, into
build/paddle_tpu_torch/), holds it against its plain PyTorch version at
the serving path's shapes, checks the fp32 serving streams of GPT-2
small width against the gather-then-attend reference kernel, then serves
GPT-2 small in bf16 through the front door
(`inference.Config().enable_llm_engine(paged=True, ...)` ->
`create_llm_predictor` -> submit/run) and shows that the path launched
the kernel. Each phase prints one JSON line; a failed check raises and
exits non-zero. The last lines are the kernel summary, the card's name
and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.

Needs one CUDA card; exits non-zero without printing a result when there
is none, or when run outside a checkout of the repository.
"""
import json
import os
import subprocess
import sys
import time

SEED = 0
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/nn/paged_attention.py:248"
# main-path shapes: GPT-2 small (12 heads of 64), 16-token blocks, a
# 1024-token horizon (64 blocks per lane), 8 lanes, 64-token chunks
HEADS, HEAD_DIM, BLOCK, NBLK, LANES, CHUNK = 12, 64, 16, 64, 8, 64
NUM_BLOCKS = LANES * NBLK + 1
LAYERS = 12
# peak rates of the card by nvidia-smi name: HBM bytes/s, and dense
# operations/s by input type (bf16 on the tensor cores; f32 outside
# them) — NVIDIA's H100 data sheets
PEAKS = {"pcie": {"bw": 2.0e12, "bf16": 756e12, "f32": 51e12},
         "sxm": {"bw": 3.35e12, "bf16": 989e12, "f32": 67e12}}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    """Mean ms per eager call over `iters` calls, CUDA events around the
    run: the device time, or the host's when the host cannot keep the
    device busy (a Python loop of small kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls, replays=20):
    """Device ms per call: `calls` calls captured into one CUDA graph and
    replayed, so no host overhead is in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------------------
# kernels: K4 against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def make_case(form, dtype, gen, dev, sets=1):
    """Inputs of one K4 call as the serving path gives them: pools with
    NaN in scratch block 0, lane tables mapping distinct real blocks up
    to each lane's frontier and scratch past it. `sets` pool copies (one
    per layer) so timed launches find their pool cold, as each layer of
    a wave does."""
    import torch
    if form == "decode":
        b, c = LANES, 1
        start = torch.randint(128, 832, (b,), generator=gen,
                              device="cpu").to(dev)
    else:
        b, c = 1, CHUNK
        start = torch.tensor([512], device=dev)
    last = (start + c - 1).tolist()
    perm = (torch.randperm(NUM_BLOCKS - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((b, NBLK), dtype=torch.int32)
    for i in range(b):
        used = last[i] // BLOCK + 1
        tables[i, :used] = torch.tensor(perm[:used])
        perm = perm[used:]
    tables = tables.to(dev)
    shape = (NUM_BLOCKS, HEADS, BLOCK, HEAD_DIM)
    pools = []
    for _ in range(sets):
        pk = torch.randn(shape, generator=gen).to(dev, dtype)
        pv = torch.randn(shape, generator=gen).to(dev, dtype)
        pk[0] = float("nan")
        pv[0] = float("nan")
        pools.append((pk, pv))
    q = torch.randn((b, HEADS, c, HEAD_DIM), generator=gen).to(dev, dtype)
    return q, pools, tables, start


def bound(q, pk, start, window, peaks):
    """Least time for the call: the bytes it must move (q, the K and V
    rows each lane attends, the table entries of the blocks holding them
    and the positions read once, the output written once) over the HBM
    rate, against its operations (q.k and p.v multiply-adds over the
    attended keys) over the peak for the pool type. Returns
    (ms, "bytes" | "operations")."""
    b, h, c, d = q.shape
    hkv, elt = pk.shape[1], pk.element_size()
    nbytes = q.numel() * q.element_size() + b * h * c * d * elt + b * c * 4
    flops = 0
    for s in start.reshape(-1).tolist():
        hi = s + c - 1                   # the lane's last attended key
        lo = 0 if window is None else max(0, s - window + 1)
        nbytes += (hi - lo + 1) * 2 * hkv * d * elt      # K and V rows
        nbytes += (hi // BLOCK - lo // BLOCK + 1) * 4     # table entries
        for r in range(c):
            keys = s + r + 1 - (0 if window is None
                                else max(0, s + r - window + 1))
            flops += 4 * h * keys * d
    rate = peaks["bf16" if pk.element_size() == 2 else "f32"]
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_phase(dev, peaks):
    import torch
    from paddle_tpu_torch.nn import paged_attention as pa

    gen = torch.Generator().manual_seed(SEED)
    scale = 1.0 / HEAD_DIM ** 0.5
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    results = {}
    for form in ("decode", "chunk"):
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, pools, tables, start = make_case(form, dtype, gen, dev)
            pk, pv = pools[0]
            for window in (None, 256):
                out = pa.cuda_core(q, pk, pv, tables, start, scale, window,
                                   form=form)
                ref = pa.plain_core(q, pk, pv, tables, start, scale,
                                    window)
                torch.cuda.synchronize()
                check(torch.isfinite(out).all().item(),
                      f"{form} {dtype} window={window}: scratch NaN leaked")
                err = (out.float() - ref.float()).abs()
                lim = tol[dtype] * torch.clamp(ref.float().abs(), min=1.0)
                check(bool((err <= lim).all()),
                      f"{form} {dtype} window={window}: max abs err "
                      f"{err.max().item()} over tolerance {tol[dtype]}")
                worst[dtype] = max(worst.get(dtype, 0.0),
                                   err.max().item())
            # attended NaN reaches the output, and only its own lane
            bad = tables.clone()
            bad[0, 0] = 0
            out = pa.cuda_core(q, pk, pv, bad, start, scale, form=form)
            check(not torch.isfinite(out[0]).all().item(),
                  f"{form} {dtype}: attended NaN did not propagate")
            check(torch.isfinite(out[1:]).all().item(),
                  f"{form} {dtype}: attended NaN leaked to other lanes")
            # rows with no attended key are exactly 0
            neg = torch.full_like(start, -CHUNK)
            out = pa.cuda_core(q, pk, pv, tables, neg, scale, form=form)
            check(bool((out == 0).all()),
                  f"{form} {dtype}: fully masked rows are not exactly 0")
        # times at the main path's type (bf16 pools), pools cold per call
        q, pools, tables, start = make_case(form, torch.bfloat16, gen, dev,
                                            sets=LAYERS)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % LAYERS
            return pools[it["i"]]

        def run_kernel():
            pk, pv = nxt()
            pa.cuda_core(q, pk, pv, tables, start, scale, form=form)

        def run_plain():
            pk, pv = nxt()
            pa.plain_core(q, pk, pv, tables, start, scale)

        # the library yardstick: SDPA over the gathered per-lane view
        # (gathered outside the timed call), never used by the port
        from paddle_tpu_torch.nn.transformer import gather_block_kv
        views = [(gather_block_kv(pk, tables), gather_block_kv(pv, tables))
                 for pk, pv in pools]
        b, c = q.shape[0], q.shape[2]
        qpos = pa.query_positions(start, b, c, dev).long()
        ks = torch.arange(NBLK * BLOCK, device=dev)
        mask = (ks[None, None, :] <= qpos[:, :, None])[:, None]

        def run_library():
            it["i"] = (it["i"] + 1) % LAYERS
            k, v = views[it["i"]]
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale)

        bound_ms, bound_by = bound(q, pools[0][0], start, None, peaks)
        results[form] = {
            # the main path's pool type; f32 pools reported beside it
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32_pools": worst[torch.float32],
            # device time of the wrapper (q cast, positions, kernel,
            # output cast), one pool set per call as the layers of a wave
            "kernel_ms": graph_ms(run_kernel, LAYERS),
            "eager_call_ms": time_ms(run_kernel, 60),
            "plain_ms": time_ms(run_plain, 6),
            "library_ms": graph_ms(run_library, LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del pools, views
    return results


# ---------------------------------------------------------------------------
# parity: the CUDA kernel against the reference kernel through serving
# ---------------------------------------------------------------------------

def record_streams(model, kernel, prompts, max_tokens, dev):
    """Serve `prompts` greedily through create_llm_predictor and record
    the logits row behind every emitted token of every request."""
    import torch
    from paddle_tpu_torch import inference

    cfg = inference.Config().enable_llm_engine(
        paged=True, num_slots=4, max_len=256, block_size=BLOCK,
        prefill_len=CHUNK, paged_kernel=kernel, device=dev)
    pred = inference.create_llm_predictor(cfg, model=model)
    eng, sched = pred.engine, pred.scheduler
    reqs = []
    steps = [[] for _ in prompts]
    last_chunk = {}
    orig_step = eng.prefill_step

    def prefill_step(slot):
        st = eng._pending_prefill[slot]
        last_chunk["slot"] = slot
        last_chunk["last"] = st["next"] + eng.prefill_chunk_len >= st["n"]
        return orig_step(slot)

    def owner(slot):
        req = sched._slot_req[slot]
        return next(i for i, r in enumerate(reqs) if r is req)

    orig_prefill, orig_decode = model.prefill_chunk, model.decode_step

    def prefill_chunk(*a, **k):
        logits, caches = orig_prefill(*a, **k)
        if last_chunk["last"]:
            steps[owner(last_chunk["slot"])].append(
                logits[0, 0].float().cpu())
        return logits, caches

    def decode_step(*a, **k):
        logits, caches = orig_decode(*a, **k)
        rows = logits[:, 0].float().cpu()
        for s, live in enumerate(eng.slot_active):
            if live and s not in eng.last_starved_slots:
                steps[owner(s)].append(rows[s])
        return logits, caches

    eng.prefill_step = prefill_step
    model.prefill_chunk, model.decode_step = prefill_chunk, decode_step
    try:
        reqs.extend(pred.submit(prompt=p, max_tokens=max_tokens)
                    for p in prompts)
        pred.run()
    finally:
        del model.prefill_chunk, model.decode_step
    torch.cuda.synchronize()
    return [r.output_tokens for r in reqs], steps


def parity_phase(dev):
    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small

    tol = 1e-3
    # initializer 0.1: at the default 0.02 a random GPT's greedy stream
    # repeats one token and proves little; at 0.2 (the 2-layer CPU tests'
    # setting) 12 random layers amplify f32 summation-order differences
    # in attention past the 1e-3 logit tolerance
    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0,
                                         initializer_range=0.1),
                              device=dev, dtype=torch.float32, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).tolist()
               for n in (37, 64, 100, 150)]
    ref_toks, ref_steps = record_streams(model, "reference", prompts, 16,
                                         dev)
    out_toks, out_steps = record_streams(model, "cuda", prompts, 16, dev)
    near_ties, max_err, compared, scale = 0, 0.0, 0, 0.0
    for i in range(len(prompts)):
        check(len(out_toks[i]) == len(ref_toks[i]) == 16,
              f"request {i}: stream lengths {len(out_toks[i])} / "
              f"{len(ref_toks[i])}")
        for t, (a, b) in enumerate(zip(ref_toks[i], out_toks[i])):
            lr, lc = ref_steps[i][t], out_steps[i][t]
            check(bool(torch.isfinite(lc).all()),
                  f"request {i} step {t}: non-finite logits")
            err = (lr - lc).abs().max().item()
            scale = max(scale, lr.abs().max().item())
            max_err = max(max_err, err)
            compared += 1
            check(err <= tol, f"request {i} step {t}: logits differ by "
                              f"{err} > {tol}")
            if a != b:
                top2 = torch.topk(lr, 2).values
                gap = (top2[0] - top2[1]).item()
                check(gap < tol, f"request {i} step {t}: tokens {a} vs {b}"
                                 f" with top-2 gap {gap} >= {tol}")
                near_ties += 1
                break               # the streams diverge from here on
    emit("parity", dtype="float32", layers=LAYERS, requests=len(prompts),
         steps_compared=compared, max_logit_err=max_err, tolerance=tol,
         max_abs_logit=scale, near_tie_steps=near_ties,
         streams_equal=ref_toks == out_toks,
         distinct_tokens=[len(set(t)) for t in ref_toks])


# ---------------------------------------------------------------------------
# serve: GPT-2 small, bf16, through the front door
# ---------------------------------------------------------------------------

def serve_phase(dev):
    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small
    from paddle_tpu_torch.nn import paged_attention as pa
    from paddle_tpu_torch.serving import ServingMetrics

    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                              device=dev, dtype=torch.bfloat16, seed=SEED)
    cfg = inference.Config().enable_llm_engine(
        paged=True, num_slots=LANES, max_len=NBLK * BLOCK,
        block_size=BLOCK, prefill_len=CHUNK)
    pred = inference.create_llm_predictor(cfg, model=model)
    check(pred.engine.paged_kernel == "cuda",
          f"engine resolved kernel {pred.engine.paged_kernel!r}")
    pred.generate(list(range(1, 70)), max_tokens=2)        # warm-up
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    eng = pred.engine
    waves0, chunks0 = eng.decode_waves_run, eng.prefill_chunks_run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the timed window's metrics leave out the warm-up request
    pred.scheduler.metrics = ServingMetrics(eng.num_slots)
    pa.launches["decode"] = pa.launches["chunk"] = 0
    t0 = time.perf_counter()
    reqs = [pred.submit(prompt=p, max_tokens=64) for p in prompts]
    pred.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.launches)
    waves = eng.decode_waves_run - waves0
    chunks = eng.prefill_chunks_run - chunks0
    snap = pred.metrics.snapshot()
    done = [r for r in reqs if r.finish_reason == "max_tokens"]
    check(len(done) == 16, "finish reasons "
          f"{[r.finish_reason for r in reqs]}")
    vocab = model.cfg.vocab_size
    check(all(len(r.output_tokens) == 64
              and all(0 <= t < vocab for t in r.output_tokens)
              for r in reqs), "every request yields 64 in-vocab tokens")
    total = launches["decode"] + launches["chunk"]
    check(total > 0, "the serving path never launched the kernel")
    check(launches["decode"] == LAYERS * waves
          and launches["chunk"] == LAYERS * chunks,
          f"launches {launches} != {LAYERS} x (waves {waves}, prefill "
          f"chunks {chunks})")
    tokens = sum(len(r.output_tokens) for r in reqs)
    emit("serve", model="gpt2_small", dtype="bfloat16", requests=16,
         completed=len(done), tokens_generated=tokens, wall_s=wall,
         tokens_per_s=tokens / wall, ttft_p50_s=snap["ttft_p50_s"],
         tpot_p50_s=snap["tpot_p50_s"], decode_waves=waves,
         prefill_chunks=chunks, k4_launches=total,
         k4_launches_by_form=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from paddle_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    peaks = PEAKS["pcie" if "pcie" in smi.lower() else "sxm"]
    info = kernels.build_info("paged_attention")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         peaks=peaks, kernel_build_s=info["seconds"],
         kernel_built=info["built"],
         ptxas=[ln for ln in info["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln])
    k = kernels_phase(dev, peaks)
    emit("kernels", **k)
    parity_phase(dev)
    launches = serve_phase(dev)
    rows = []
    for form in ("decode", "chunk"):
        row = dict(k[form])
        rows.append({"name": f"paged_attention_{form}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES,
                     "launches": launches[form],
                     "ms": row.pop("kernel_ms"), **row})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
