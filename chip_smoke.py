#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

    python3 chip_smoke.py [--only PHASE[,PHASE...]]

Builds the port's CUDA kernels from the checkout (one nvcc per source,
all started together; sm_90a, into build/paddle_tpu_torch/), then runs
its phases:

  kernels       K4 (paged attention: split kernel and combine) against
                its plain PyTorch version at the serving path's shapes
                (both forms, f32 and bf16 pools, windows, strided and
                misaligned q, GQA, ragged chunks, int32/int64/int
                starts, the NaN contracts), timed, with a split-size
                sweep and a profiler count of device kernels per call;
                GQA at rep 2, 3 (LLaMA's 12 heads over 4) and 4, and
                each form at rep 3 timed with its own bound and sweep;
                and at the speculative verify's shape (8 lanes of
                C = k + 1 = 5 queries, an [8] int64 start, f32 and bf16
                pools, every tile height the kernels take there),
                timed with the launch rule's choices beside each other
                (the split kernel's 8-row and 4-row tiles, the
                tensor-core kernel the rule takes);
  flash         K1-K3 (flash attention forward, dK/dV, dQ) and the dd
                kernel (rowsum(dO * O)) against their plain versions at
                the training path's shapes (BSHD views of the qkv
                projection, and BHSD), windowed cases, q_len < kv_len
                and q_len > kv_len cases and a single 128-row tile, f32
                and bf16, with the NaN and fully-masked-row contracts
                and the alignment rules; timed by CUDA-graph replay (in
                TFLOP/s too, K1-K3's registers, spills and shared memory
                beside), with the port's whole backward against SDPA's,
                both captured in CUDA graphs; K1 again at the dense
                prefill's shape [1, 768, 12, 64], against its plain
                version and SDPA's forward; K1-K3 and dd at
                Transformer-base's two attention shapes (8 heads,
                non-causal BSHD: self [64, 384, 8, 64], cross q 256 over
                k 384), held and timed at batch 64, beside their
                bounds, plain versions and SDPA; and at BERT-base's
                self-attention (12 heads, separate q/k/v projections,
                non-causal BSHD [16, 512, 12, 64]), held at f32 and bf16
                and timed the same way;
  optimizer     the fused Adam/AdamW kernel against its plain
                `_foreach_*` twin over GPT-2 small's 148 parameter
                shapes (AdamW with bf16 and f32 weights and with bf16
                weights and f32 masters, Adam with an L2 decay, the L1
                and L2 regularizer terms with and without the decoupled
                decay, a learning-rate multiplier, four groups in one
                step; 3 steps with the learning rate changed before the
                third), odd sizes and more tensors than one launch
                carries, the NaN contract and the refusals; one whole
                optimizer step timed by CUDA-graph replay against its
                byte bound, the plain twin and
                torch.optim.AdamW(fused=True), and the four-group step;
                the nine other optimizers (Momentum ... Dpsgd) over the
                same shapes in f32, each step() captured in a CUDA graph:
                graphed equal to eager, within rtol 1e-5 of a CPU run,
                one step timed against its byte bound; Dpsgd's noise
                drawn fresh by every replay, at its stated std;
  parity        fp32 serving streams of GPT-2 small width through the
                CUDA kernel against the gather-then-attend reference
                (both eager); the graphed engine against the eager one
                (equal streams, logits within 1e-6 relative, one decode
                and one prefill graph); two graphed sampling engines with
                one seed against each other, and against the eager one;
                the dense engine (K1 prefill, dense decode) eager and
                graphed: streams equal to the paged engine's, logits
                within 1e-3 of the reference engine's per step, graphed
                equal to eager (logits within 1e-6 relative, one graph
                per program); the speculative engine (k = 4; a
                DistilGPT2-shaped draft, and the target as its own
                draft) eager and graphed: graphed streams equal to
                eager, one graph per program (three), streams equal to
                the paged engine's except where its top-2 logit margin
                is under 1e-3 (position and margin reported); a
                prefill-role and a decode-role engine, graphed, joined
                by the handoff loop: streams equal the paged engine's
                (the same near-tie rule), one graph of each role's own
                program and none of the other's, every payload equal to
                its blocks gathered after synchronize(), a payload with
                one flipped byte refused with the pool unchanged; a
                dynamic token mask through the graphed dense, paged and
                speculative engines (every masked token allowed, the
                unmasked streams equal the paged ones, masked spec lanes
                propose nothing); one injected wave fault on the graphed
                paged engine (greedy and sampled streams equal the
                unfaulted ones, one retry); drain() then close() (work
                completes, a new submit is shed, health "draining");
                then an fp32 LLaMA at full width and 2 layers (12 heads
                over 4 KV heads): K4 against the reference kernel,
                graphed equal to eager, the dense, speculative (a
                1-layer LLaMA draft) and disaggregated streams equal to
                the paged engine's;
  train_parity  fp32 GPT training (head_dim 64) through the CUDA
                kernels against the dense reference: step-1 gradients,
                5-step SGD and AdamW loss trajectories, window off/on;
                the graphed TrainStep against the eager sequence, with
                and without a set_lr before step 4; two replays at lr 0
                equal without dropout and different with it; the
                vocab-chunked fused head against the dense head (loss,
                every gradient, the tied embedding's); the graphed
                TrainStep against the eager one under LinearWarmup over
                CosineAnnealingDecay, the device lr the schedule's at
                every replay; an fp32 LLaMA (6 heads of 64 over 2 KV
                heads, 2 layers): step-1 gradients against the dense
                reference, window off and 64, and the graphed TrainStep
                against the eager one over 5 AdamW steps;
  serve         GPT-2 small in bf16 through the front door
                (`inference.Config().enable_llm_engine(paged=True, ...)`
                -> `create_llm_predictor` -> submit/run), 16 requests
                served with the wave and the chunk as CUDA graphs and
                eagerly (`switch_ir_optim(False)`) in turns, showing the
                path launched K4 (the graphs' captured launches times
                their replays, and none from Python); a torch.profiler
                window of 20 steady rounds (device time per wave and per
                chunk, idle share, host time per round);
  serve_dense   the serve phase's 16 requests through the front door's
                default, the dense engine (`inference.Config()
                .enable_llm_engine(num_slots=8, max_len=1024,
                prefill_len=768)`), graphed and eager in turns: every
                prefill on K1's route at a 768-token bucket, 12 K1
                launches per admission (the prefill graph's captured
                launches times its replays); the wave and the prefill
                graph replayed alone and profiled by kernel group; then
                `generate(use_cache=True)` at batch 8, 64 new tokens:
                a call's wall time (position 0 eager, 1 captured, one
                graph replay per later position) against its eager
                run, and the replays' device time per position;
  serve_spec    the serve phase's 16 requests through
                `enable_llm_engine(speculative=True, k=4)` and
                `create_llm_predictor(..., draft_model=)`, the draft
                DistilGPT2-shaped (6 layers, 768 wide, 12 heads, vocab
                50304; random weights), graphed and eager in turns:
                tokens/s, TTFT and TPOT, acceptance and tokens per lane
                per wave, K4's launches per program (captured launches
                times replays: the draft wave's decode form, the
                verify's chunk form at C = 5, the spec prefill chunk's);
                each of the three graphs replayed alone and profiled by
                kernel group; then the target as its own draft
                (acceptance near 1: the bonus token) and the paged
                engine on the same traffic;
  serve_disagg  the serve phase's 16 requests through a prefill-role and
                a decode-role scheduler of 8 slots each (one card),
                joined by the handoff loop of the JAX fleet's
                DisaggFleetRouter, twice: tokens/s, TTFT, TPOT (the
                decode hop's gaps, the seam, each request's mean), the
                handoff's bytes and host ms a request (export, import,
                the sha256 digests apart), K4's launches per role (the
                prefill role's chunk form, the decode role's decode
                form); then the unified paged engine on the same
                traffic;
  serve_llama   the serve workload on the JAX package's serving LLaMA
                (vocab 32000, 768 wide, 12 layers, 12 heads over 4 KV
                heads, SwiGLU 2048) in bf16 through the front door: the
                paged engine graphed, eager, graphed, the dense engine
                (a 768 bucket, K1) and the speculative one (k = 4, a
                2-layer LLaMA draft) graphed, each with its counts set
                to 0 before it; GPT-2 small's paged engine beside them;
                each graph replayed alone, the paged wave profiled by
                kernel group with RMSNorm, RoPE and SiLU·mul timed
                alone, and the KV bytes a token;
  train         GPT-2 small in bf16 at bench.py's GPU shapes through
                `GPTForPretraining` -> `gpt_pretrain_loss` -> `AdamW`
                in `jit.TrainStep`, one CUDA graph per step after the
                eager first call and the capture, 10 timed replays,
                showing every layer's K1-K3 and dd kernels and one
                optimizer kernel in each replay (the captured launches
                times the replays, against the profiler's count of
                each kernel per step), with the eager step beside it;
  train_llama   the same recipe on serve_llama's LLaMA (vocab 32000):
                12 launches each of K1-K3 and dd and 1 optimizer launch
                a replay; step ms, tokens/s, MFU, peak memory, idle
                share and device time by kernel group;
  train_fused_head
                GPT-2 small with its padded vocab 50304, batch 16 x seq
                1024, bf16, AdamW, the head on auto: the f32 logits
                (3.30 GB) pass 2 GiB, so the vocab-chunked fused head
                trains it; the graphed step's ms, tokens/s, MFU, peak
                memory and device time by group, the chunked head's
                forward and backward timed alone, the dense head never
                called on the loss path; then the same model with
                fused_head_loss=False: its step ms and peak memory;
  eager         the Paddle Tensor surface (to_tensor, the op library,
                autograd): every case of tests/torch_op_cases.py (every
                op in the port's OP_REGISTRY and the data-dependent-shape
                ops) on CUDA inputs against the CPU, forward and
                gradients, outputs on the card, the forward under
                torch.cuda.set_sync_debug_mode("warn") (the ops that
                synchronise listed); GPT-2 small written in the Tensor
                surface (`tensor_gpt_loss`) at f32 against the port's
                GPTForPretraining from the same weights (batch 2 x seq
                256: loss and every gradient); 3 bf16 AdamW steps at
                batch 8 x seq 1024 through pt.Parameters against the
                nn.Module's eager steps (losses within 2e-2), forward and
                backward ms apart, K1-K3 and dd 12 launches a step; the
                host microseconds per dispatched op (pt.add against
                torch.add on [8] f32);
  nn            GPT-2 small built from nn layers (`layer_gpt`) at f32
                against GPTForPretraining, its bf16 eager steps beside
                the module's and the Tensor surface's, the same model in
                a graphed jit.TrainStep (12 launches each of K1-K3 and
                dd and 1 Adam launch a step; its loss equal to the eager
                Layer step's; timed in turns with the module's graphed
                step and the eager Layer step), llama_attention, a
                sparse embedding under lazy Adam, a small conv net;
  transformer   Transformer-base (Vaswani et al. 2017, Table 3 "base":
                6 + 6 layers, d_model 512, 8 heads, d_ff 2048, vocab
                37000) built from nn layers (`layer_transformer`): f32
                at batch 2 through the kernels against kernel="plain"
                (loss and every gradient) and the graphed TrainStep
                against the eager one over 3 steps; dropout drawn afresh
                by every replay; bf16 at batch 64 x (384 source, 256
                target) tokens on AdamW/NoamDecay as one graph replay a
                step (12 launches each of K1-K3 and dd, 1 Adam): step
                ms, tokens/s, MFU, peak memory, device time by group,
                the dense masked attention timed alone, the eager step;
                incremental decoding (gen_cache, 32 greedy steps)
                against the full decoder; beam search (beam 4, batch 64,
                64 steps) on the card against the CPU, over a cell that
                contracts in f32 and over one that does not in f64;
  bert          BERT-base pretraining (`scripts/bench_sweep.py:158-181`:
                12 layers, 768 wide, 12 heads of 64, FFN 3072, vocab
                30522, no dropout) built from nn layers
                (`nlp.BertForPretraining`): f32 at 2 layers and batch 2
                x 512 through the kernels against kernel="plain" (loss
                and every gradient) and the graphed TrainStep against
                the eager one over 3 steps; bf16 at batch 16 x 512 (15%
                MLM and NSP labels) on AdamW(1e-4) as one graph replay a
                step (12 launches each of K1-K3 and dd, 1 Adam): step
                ms, samples/s, tokens/s, MFU, peak memory, device time
                by group, the eager step;
  amp           the f32 GPT-2 small Layer at 8 x 1024 under
                `amp.auto_cast()`: 3 eager steps with a GradScaler and a
                graphed TrainStep entered under auto_cast, K1-K3 launched
                in bf16 (12 a step); 3 steps at 2 layers and batch 2 x
                1024 against the same steps on the CPU's plain kernels
                (losses within 2e-2 relative); auto_cast(dtype="float16")
                into attention raises the kernel wrapper's TypeError;
  hapi          SKILL.md flow 1 (BASELINE.json configs[0]): LeNet through
                `hapi.Model` (Adam, cross entropy, Accuracy) fit on the
                synthetic MNIST for 2 epochs at batch 64, one graph
                replay a step; evaluate (test accuracy above 0.7),
                predict, a save/load round trip, a save at step 10
                resumed by load_latest and fit(resume=True) against the
                run without a stop, the first 20 losses against the
                same fit on the CPU; then GPT-2 small (the Layer
                GPTForPretraining) at bench.py's shapes through
                `Model.fit` on a DataLoader of seeded ids: one replay a
                step holding 12 launches each of K1-K3 and dd and 1
                Adam launch, fit's step ms against the bare graphed
                TrainStep's on the same batches, in turns;
  resnet        ResNet-50 (BASELINE.json configs[1],
                `scripts/bench_sweep.py:130-155`: 1000 classes, bf16,
                Momentum(0.1, 0.9), batch 128) through `Model.fit` on a
                seeded class-per-directory tree of .npy images read by
                `vision.datasets.DatasetFolder` (RandomResizedCrop(224),
                RandomHorizontalFlip, ToTensor, Normalize) and a
                DataLoader of forked shared-memory workers, with
                Accuracy(top 1, top 5): images/s, step ms, the
                data-wait share, MFU, peak memory, the bare graphed
                step on staged batches in turns, the device time by
                group (convolutions, BatchNorm, layout transposes,
                elementwise, optimizer), evaluate's images/s; the
                forked loader's batches against the single-process
                loader's, f32 steps on the card against the CPU, and
                the graphed step against the eager one with BatchNorm's
                running statistics moving on every replay.

Each phase prints one JSON line; a failed check raises and exits
non-zero. `--only` runs a subset (for short checks); the full run, with
no arguments, ends with the kernel summary, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.

Needs one CUDA card; exits non-zero without printing a result when there
is none, or when run outside a checkout of the repository.
"""
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/nn/paged_attention.py:248"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "paddle_tpu/ops/pallas/flash_attention.py:137",
                  "dkv": "paddle_tpu/ops/pallas/flash_attention.py:300",
                  "dq": "paddle_tpu/ops/pallas/flash_attention.py:385",
                  "dd": "no Pallas counterpart: XLA-fused jnp in "
                        "_flash_bwd_pallas, paddle_tpu/ops/pallas/"
                        "flash_attention.py:466-469"}
FLASH_NAMES = {"fwd": "flash_attention_fwd", "dkv": "flash_attention_dkv",
               "dq": "flash_attention_dq", "dd": "flash_attention_row_dot"}
# device kernel names (torch.profiler) of each counted launch
DEVICE_NAMES = {"flash_attention.fwd": "flash_fwd_wgmma",
                "flash_attention.dkv": "flash_bwd_dkv_wgmma",
                "flash_attention.dq": "flash_bwd_dq_wgmma",
                "flash_attention.dd": "row_dot_kernel",
                "optimizer.adam": "adam_kernel"}
OPT_SOURCE = "paddle_tpu_torch/csrc/optimizer.cu"
OPT_REPLACES = ("no Pallas counterpart: the jnp update that XLA fuses into "
                "the compiled train step, Adam._update / AdamW._update, "
                "paddle_tpu/optimizer/optimizer.py:372-382, 413-425")
# training shapes of bench.py's GPU configuration: GPT-2 small (12 heads
# of 64), vocab 32768, batch 8, seq 1024
TRAIN_B, TRAIN_S, TRAIN_VOCAB = 8, 1024, 32768
# Transformer-base (Vaswani et al. 2017, "Attention Is All You Need",
# Table 3, "base"): 6 + 6 layers, d_model 512, 8 heads of 64, d_ff 2048,
# P_drop 0.1, the shared WMT14 EN-DE BPE vocabulary of 37000 tokens;
# batch 64 x 384 source tokens (24576, the paper's ~25000 a batch) and
# 256 target tokens
TF_VOCAB, TF_D, TF_HEADS, TF_FF, TF_LAYERS = 37000, 512, 8, 2048, 6
TF_B, TF_SRC, TF_TGT = 64, 384, 256
# BERT-base pretraining (`scripts/bench_sweep.py:158-181`, BASELINE.json
# configs[2]): 12 layers, 768 wide, 12 heads of 64, FFN 3072, vocab 30522;
# batch 16 x 512, 15% MLM labels and NSP labels; bf16, AdamW(1e-4)
BERT_B, BERT_S = 16, 512
PHASES = ("kernels", "flash", "optimizer", "parity", "train_parity",
          "serve", "serve_dense", "serve_spec", "serve_disagg",
          "serve_llama", "train", "train_llama", "train_fused_head",
          "eager", "nn", "transformer", "bert", "amp", "hapi", "resnet")
# main-path shapes: GPT-2 small (12 heads of 64), 16-token blocks, a
# 1024-token horizon (64 blocks per lane), 8 lanes, 64-token chunks
HEADS, HEAD_DIM, BLOCK, NBLK, LANES, CHUNK = 12, 64, 16, 64, 8, 64
NUM_BLOCKS = LANES * NBLK + 1
# speculative decoding: k draft tokens a wave (the JAX package's default),
# so the verify chunk is C = k + 1 queries a lane; the draft has the
# DistilGPT2 shape (Hugging Face `distilgpt2` config.json: n_layer 6,
# n_embd 768, n_head 12), its vocabulary padded as GPT-2 small's
SPEC_K = 4
VERIFY_C = SPEC_K + 1
DRAFT_LAYERS = 6
# the dense engine's prompt bucket: the serve prompts' longest, a
# multiple of 128, so every prefill is K1 at [1, 768, 12, 64]
DENSE_BUCKET = 768
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


def zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from paddle_tpu_torch import kernels
    for counts in kernels.COUNTERS.values():
        for key in counts:
            counts[key] = 0


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

def make_case(form, dtype, gen, dev, sets=1, hkv=HEADS, c=None,
              start=None, strided_q=False, llama_q=False):
    """Inputs of one K4 call as the serving path gives them: pools with
    NaN in scratch block 0, lane tables mapping distinct real blocks up
    to each lane's frontier and scratch past it. `sets` pool copies (one
    per layer) so timed launches find their pool cold, as each layer of
    a wave does. Decode: 8 lanes at seeded positions 128-831; chunk: one
    lane of C = 64 queries from 512; verify: the speculative verify's
    chunk form, 8 lanes of C = k + 1 queries at seeded [8] starts
    128-831. `hkv` < HEADS gives GQA pools; `strided_q` gives q as
    GPT's `_split_heads` does, a view of a [B, C, 3, H, D] projection,
    `llama_q` as LLaMA's attention does, the [B, H, C, D] view of a
    rotated [B, C, H, D] tensor."""
    import torch
    if form in ("decode", "verify"):
        b, c = LANES, (1 if form == "decode" else VERIFY_C)
        if start is None:
            start = torch.randint(128, 832, (b,), generator=gen,
                                  device="cpu")
    else:
        b, c = 1, CHUNK if c is None else c
        if start is None:
            start = torch.tensor([512])
    start = torch.as_tensor(start).to(dev)
    last = (start.expand(b) + c - 1).tolist()
    perm = (torch.randperm(NUM_BLOCKS - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((b, NBLK), dtype=torch.int32)
    for i in range(b):
        used = last[i] // BLOCK + 1
        tables[i, :used] = torch.tensor(perm[:used])
        perm = perm[used:]
    tables = tables.to(dev)
    shape = (NUM_BLOCKS, hkv, BLOCK, HEAD_DIM)
    pools = []
    for _ in range(sets):
        pk = torch.randn(shape, generator=gen).to(dev, dtype)
        pv = torch.randn(shape, generator=gen).to(dev, dtype)
        pk[0] = float("nan")
        pv[0] = float("nan")
        pools.append((pk, pv))
    if strided_q:
        qkv = torch.randn((b, c, 3, HEADS, HEAD_DIM), generator=gen)
        q = qkv.to(dev, dtype).permute(2, 0, 3, 1, 4)[0]
    elif llama_q:
        q = torch.randn((b, c, HEADS, HEAD_DIM), generator=gen).to(
            dev, dtype).transpose(1, 2)
    else:
        q = torch.randn((b, HEADS, c, HEAD_DIM), generator=gen).to(dev,
                                                                   dtype)
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


def profile_calls(fn, calls, name="paged_attn"):
    """What `calls` eager calls of `fn` run on the device, from
    torch.profiler (CUPTI): device activities (kernels, copies, fills)
    per call, the device ms per call of the kernels whose name holds
    `name` (K4's own), and device ms per call by name. Returns
    "not measured: ..." when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        return "not measured: the profiler recorded no device activity"
    return {
        "device_kernels_per_call": sum(e.count for e in rows) / calls,
        "device_ms_per_call": sum(e.self_device_time_total
                                  for e in rows) / 1e3 / calls,
        "k4_only_ms": sum(e.self_device_time_total for e in rows
                          if name in e.key) / 1e3 / calls,
        "device_ms_per_call_by_name": {
            e.key[:72]: e.self_device_time_total / 1e3 / calls
            for e in rows}}


def held(name, out, ref, dtype, finite=True):
    """K4's output against its plain version: the same non-finite
    entries, the rest within 1e-4 (f32 pools) or 1e-2 (bf16) x max(1,
    |ref|). Returns the max abs error over the finite entries."""
    import torch
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    torch.cuda.synchronize()
    check(tuple(out.shape) == tuple(ref.shape) and out.dtype == ref.dtype,
          f"{name}: {out.dtype}{tuple(out.shape)} against "
          f"{ref.dtype}{tuple(ref.shape)}")
    ok = torch.isfinite(ref)
    check(bool((torch.isfinite(out) == ok).all()),
          f"{name}: non-finite entries differ from plain's")
    check(not finite or bool(ok.all()), f"{name}: scratch NaN leaked")
    err = torch.where(ok, (out.float() - ref.float()).abs(), 0.0)
    lim = tol * torch.clamp(ref.float().abs(), min=1.0)
    check(bool((err <= lim)[ok].all()),
          f"{name}: max abs err {err.max().item()} over tolerance {tol}")
    return err.max().item()


def kernels_checks(pa, dev, gen, scale):
    """Every check of K4 against `plain_core`; returns the max abs error
    by (form, dtype) over the main-shape cases."""
    import torch
    worst = {}
    for form in ("decode", "chunk"):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{form} {str(dtype).split('.')[-1]}"

            def run(name, q, pk, pv, tables, start, window=None,
                    finite=True, main=False):
                out = pa.cuda_core(q, pk, pv, tables, start, scale, window,
                                   form=form)
                ref = pa.plain_core(q, pk, pv, tables, start, scale,
                                    window)
                err = held(f"{tag} {name}", out, ref, dtype, finite)
                if main:
                    worst[(form, dtype)] = max(worst.get((form, dtype), 0.0),
                                               err)
                return out

            q, pools, tables, start = make_case(form, dtype, gen, dev)
            pk, pv = pools[0]
            # windows 256 and 64 empty the leading splits of later lanes
            for window in (None, 256, 64):
                run(f"window={window}", q, pk, pv, tables, start, window,
                    main=True)
            # start as int32, int64 and a host int
            run("int32 start", q, pk, pv, tables, start.int())
            run("int64 start", q, pk, pv, tables, start.long())
            run("int start", q, pk, pv, tables, int(start.min()))
            # attended NaN reaches the output, and only its own lane
            bad = tables.clone()
            bad[0, 0] = 0
            out = run("attended NaN", q, pk, pv, bad, start, finite=False)
            check(not torch.isfinite(out[0]).all().item(),
                  f"{tag}: attended NaN did not propagate")
            check(torch.isfinite(out[1:]).all().item(),
                  f"{tag}: attended NaN leaked to other lanes")
            # a NaN in one split only (pool block 9: split 1 of 8 blocks)
            # of the lane that reaches furthest
            i = int(start.argmax())
            check(int(start[i]) >= 10 * BLOCK, "no lane reaches block 9")
            nan_k = pk.clone()
            nan_k[tables[i, 9]] = float("nan")
            out = run("NaN in split 1", q, nan_k, pv, tables, start,
                      finite=False)
            others = torch.arange(out.shape[0], device=dev) != i
            check(not torch.isfinite(out[i]).all().item()
                  and torch.isfinite(out[others]).all().item(),
                  f"{tag}: a NaN in one split did not stay in its lane")
            # rows with no attended key (every split empty) are exactly 0
            neg = torch.full_like(start, -CHUNK)
            out = run("no attended key", q, pk, pv, tables, neg)
            check(bool((out == 0).all()),
                  f"{tag}: fully masked rows are not exactly 0")
            # q as the strided view `_split_heads` gives
            q, pools, tables, start = make_case(form, dtype, gen, dev,
                                                strided_q=True)
            check(not q.is_contiguous(), "strided q case is contiguous")
            run("strided q", q, *pools[0], tables, start)
            run("strided q window=64", q, *pools[0], tables, start, 64)
            # q one element into a flat buffer: rows not 16-byte aligned
            flat = torch.randn(q.numel() + 1, generator=gen).to(dev, dtype)
            run("misaligned q", flat[1:].view(q.shape), *pools[0], tables,
                start)
            # GQA: rep 2, rep 3 (LLaMA's 12 heads over 4) and rep 4
            for hkv in (HEADS // 2, HEADS // 3, HEADS // 4):
                q, pools, tables, start = make_case(form, dtype, gen, dev,
                                                    hkv=hkv)
                run(f"hkv={hkv}", q, *pools[0], tables, start)
                run(f"hkv={hkv} window=64", q, *pools[0], tables, start, 64)
            if form == "decode":
                # a lane at the table's last key
                start = torch.randint(128, 832, (LANES,), generator=gen)
                start[3] = NBLK * BLOCK - 1
                q, pools, tables, start = make_case(form, dtype, gen, dev,
                                                    start=start)
                run("lane at the last key", q, *pools[0], tables, start)
            else:
                # C not a multiple of 16, and a chunk from position 0
                for c, st in ((37, 512), (37, 980), (64, 0)):
                    q, pools, tables, start = make_case(
                        form, dtype, gen, dev, c=c, start=[st])
                    run(f"C={c} start={st}", q, *pools[0], tables, start)
                    run(f"C={c} start={st} window=64", q, *pools[0], tables,
                        start, 64)
    return worst


def verify_checks(pa, dev, gen, scale):
    """K4's chunk form at the speculative verify's shape (8 lanes of
    C = k + 1 queries, an [8] int64 start, rows = C = 5 a (lane,
    kv-head)) against `plain_core`, both pool types, and every kernel the
    launch rule picks at that start: the tensor-core kernel (bf16 q and
    pools at 5 rows), the split kernel's 4-row tiles (f32 pools), its
    8-row tile (f32 q over bf16 pools) and its 1, 2 and 4 rows a CUDA
    block (the first 1, 2 and 4 queries). Returns the max abs error by
    pool dtype over the main-shape cases."""
    import torch
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"verify {str(dtype).split('.')[-1]}"

        def run(name, q, pk, pv, tables, start, window=None, finite=True,
                main=False):
            out = pa.cuda_core(q, pk, pv, tables, start, scale, window,
                               form="chunk")
            ref = pa.plain_core(q, pk, pv, tables, start, scale, window)
            err = held(f"{tag} {name}", out, ref, dtype, finite)
            if main:
                worst[dtype] = max(worst.get(dtype, 0.0), err)
            return out

        q, pools, tables, start = make_case("verify", dtype, gen, dev,
                                            strided_q=True)
        check(start.dtype == torch.int64 and start.shape == (LANES,),
              f"verify start {start.dtype}{tuple(start.shape)}")
        pk, pv = pools[0]
        for window in (None, 256, 64):
            run(f"window={window}", q, pk, pv, tables, start, window,
                main=True)
        if dtype == torch.bfloat16:
            for window in (None, 64):
                run(f"f32 q window={window}", q.float(), pk, pv, tables,
                    start, window, main=True)
        for c in (1, 2, 4):
            for window in (None, 64):
                run(f"C={c} window={window}", q[:, :, :c], pk, pv, tables,
                    start, window)
        run("int32 start", q, pk, pv, tables, start.int())
        run("contiguous q", q.contiguous(), pk, pv, tables, start)
        bad = tables.clone()
        bad[0, 0] = 0
        out = run("attended NaN", q, pk, pv, bad, start, finite=False)
        check(not torch.isfinite(out[0]).all().item()
              and torch.isfinite(out[1:]).all().item(),
              f"{tag}: an attended NaN did not stay in its lane")
        neg = torch.full_like(start, -VERIFY_C)
        out = run("no attended key", q, pk, pv, tables, neg)
        check(bool((out == 0).all()),
              f"{tag}: fully masked rows are not exactly 0")
        # LLaMA's verify: rep 3 (15 rows a KV head), q the [S, H, C, D]
        # view of the rotated [S, C, H, D] projection
        q, pools, tables, start = make_case("verify", dtype, gen, dev,
                                            hkv=HEADS // 3, llama_q=True)
        for window in (None, 64):
            run(f"rep 3 window={window}", q, *pools[0], tables, start,
                window)
    return worst


def kernels_phase(dev, peaks):
    import torch
    from paddle_tpu_torch.nn import paged_attention as pa

    gen = torch.Generator().manual_seed(SEED)
    scale = 1.0 / HEAD_DIM ** 0.5
    worst = kernels_checks(pa, dev, gen, scale)
    for dtype, err in verify_checks(pa, dev, gen, scale).items():
        worst[("verify", dtype)] = err
    results = {}
    for form in ("decode", "chunk", "verify"):
        # times at the main path's type (bf16 pools), pools cold per call
        q, pools, tables, start = make_case(form, torch.bfloat16, gen, dev,
                                            sets=LAYERS,
                                            strided_q=form == "verify")
        it = {"i": 0}
        launch_form = "decode" if form == "decode" else "chunk"

        def nxt():
            it["i"] = (it["i"] + 1) % LAYERS
            return pools[it["i"]]

        def kernel(split=None):
            def run():
                pk, pv = nxt()
                pa.cuda_core(q, pk, pv, tables, start, scale,
                             form=launch_form, split_blocks=split)
            return run

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
            "max_abs_err": worst[(form, torch.bfloat16)],
            "max_abs_err_f32_pools": worst[(form, torch.float32)],
            # device time of the whole call (the split kernel and the
            # combine), one pool set per call as the layers of a wave
            "kernel_ms": graph_ms(kernel(), LAYERS),
            "eager_call_ms": time_ms(kernel(), 60),
            "plain_ms": time_ms(run_plain, 6),
            "library_ms": graph_ms(run_library, LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "split_blocks": pa.default_split_blocks(q.shape[2]),
            "kernel_ms_by_split_blocks": {
                p: graph_ms(kernel(p), LAYERS) for p in (4, 8, 16, NBLK)},
            "profile": profile_calls(kernel(), LAYERS),
        }
        if form == "verify":
            results[form]["shape"] = {"q": list(q.shape),
                                      "start": "[8] int64, 128-831"}
            # f32 q over the same bf16 pools: the rule's split kernel at
            # its 8-row tile (bf16 q takes the tensor cores)
            qf = q.float()

            def split_tile():
                pk, pv = nxt()
                pa.cuda_core(qf, pk, pv, tables, start, scale, form="chunk")
            results[form]["kernel_ms_f32_q"] = graph_ms(split_tile, LAYERS)
        del pools, views
    for form in ("decode", "chunk", "verify"):
        results[form]["rep3"] = rep3_timing(pa, form, dev, gen, scale, peaks)
    return results


def rep3_timing(pa, form, dev, gen, scale, peaks):
    """K4 at LLaMA's GQA rep 3 (12 query heads over 4 KV heads), bf16
    pools and q as the LLaMA serving path gives them: its error against
    `plain_core`, its device ms per call (one pool set per layer, by
    graph replay; also at 2, 4, 8 and 16 pool blocks a split) beside its
    bound, the plain version and SDPA over the pre-gathered view with
    the KV heads repeated outside the timed call."""
    import torch
    from paddle_tpu_torch.nn.transformer import gather_block_kv
    q, pools, tables, start = make_case(form, torch.bfloat16, gen, dev,
                                        sets=LAYERS, hkv=HEADS // 3,
                                        llama_q=True)
    launch_form = "decode" if form == "decode" else "chunk"
    pk, pv = pools[0]
    err = held(f"rep 3 {form}", pa.cuda_core(q, pk, pv, tables, start, scale,
                                             form=launch_form),
               pa.plain_core(q, pk, pv, tables, start, scale),
               torch.bfloat16)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % LAYERS
        return it["i"]

    def kernel(split=None):
        def run():
            pk, pv = pools[nxt()]
            pa.cuda_core(q, pk, pv, tables, start, scale, form=launch_form,
                         split_blocks=split)
        return run

    def plain():
        pk, pv = pools[nxt()]
        pa.plain_core(q, pk, pv, tables, start, scale)

    views = [tuple(gather_block_kv(p, tables).repeat_interleave(3, dim=1)
                   for p in pair) for pair in pools]
    b, c = q.shape[0], q.shape[2]
    qpos = pa.query_positions(start, b, c, dev).long()
    ks = torch.arange(NBLK * BLOCK, device=dev)
    mask = (ks[None, None, :] <= qpos[:, :, None])[:, None]

    def library():
        k, v = views[nxt()]
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)

    bound_ms, bound_by = bound(q, pk, start, None, peaks)
    return {"shape": {"q": list(q.shape), "pools": list(pk.shape)},
            "max_abs_err": err, "kernel_ms": graph_ms(kernel(), LAYERS),
            "split_blocks": pa.default_split_blocks(q.shape[1] // pk.shape[1]
                                                    * q.shape[2]),
            "kernel_ms_by_split_blocks": {
                p: graph_ms(kernel(p), LAYERS) for p in (2, 4, 8, 16)},
            "plain_ms": time_ms(plain, 6),
            "library_ms": graph_ms(library, LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# optimizer: the fused Adam/AdamW kernel against its plain twin
# ---------------------------------------------------------------------------

def train_config(**over):
    """The train phase's model: bench.py's GPU configuration."""
    from paddle_tpu_torch.nlp import GPTConfig
    return GPTConfig(**{**dict(vocab_size=TRAIN_VOCAB, hidden_size=768,
                               num_layers=12, num_heads=12,
                               max_seq_len=TRAIN_S, dropout=0.0,
                               attn_dropout=0.0), **over})


def gpt2_param_shapes():
    """The 148 parameter shapes of the train phase's GPT-2 small."""
    from paddle_tpu_torch.framework.state import host_init_ctx
    from paddle_tpu_torch.nlp.gpt import GPTModel
    with host_init_ctx(SEED):
        model = GPTModel(train_config())
    return [tuple(p.shape) for p in model.parameters()]


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps (bit patterns mapped onto one
    monotone integer line)."""
    import torch

    def line(x):
        i = x.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (line(a) - line(b)).abs()


def opt_slots(opt, params):
    """The weights and each state slot of `opt`, as lists."""
    slots = {"weight": list(params)}
    for name in ("moment1", "moment2", "master"):
        if name in opt._state[0]:
            slots[name] = [opt._state[i][name] for i in range(len(params))]
    return slots


def opt_held(name, got, ref):
    """The kernel's weights and state (`got`, from `opt_slots`) against
    the plain twin's: the same non-finite entries; moments within rtol
    1e-5 and atol 1e-9; f32 weights and masters within 1e-6 absolute;
    bf16 weights equal in at least 99.9% of elements and never more than
    one bf16 ulp apart. Returns the error figures."""
    import torch
    stats = {}
    for slot, gl in got.items():
        g = torch.cat([t.detach().reshape(-1) for t in gl])
        r = torch.cat([t.detach().reshape(-1) for t in ref[slot]])
        fin = torch.isfinite(r)
        check(bool((torch.isfinite(g) == fin).all()),
              f"optimizer {name}: {slot} non-finite entries differ from "
              f"plain's")
        err = torch.where(fin, (g.float() - r.float()).abs(), 0.0)
        stats[f"{slot}_max_abs_err"] = err.max().item()
        if slot in ("moment1", "moment2"):
            ok = err <= 1e-9 + 1e-5 * r.float().abs()
            check(bool(ok[fin].all()),
                  f"optimizer {name}: {slot} max abs err "
                  f"{stats[f'{slot}_max_abs_err']} over rtol 1e-5 / atol "
                  f"1e-9")
        elif g.dtype == torch.float32:
            check(stats[f"{slot}_max_abs_err"] <= 1e-6,
                  f"optimizer {name}: {slot} max abs err "
                  f"{stats[f'{slot}_max_abs_err']} over 1e-6")
        else:
            ulps = torch.where(fin, bf16_ulps(g, r), 0)
            stats["weight_equal_share"] = (ulps == 0).float().mean().item()
            stats["weight_max_ulps"] = int(ulps.max())
            check(stats["weight_equal_share"] >= 0.999
                  and stats["weight_max_ulps"] <= 1,
                  f"optimizer {name}: bf16 weights equal in "
                  f"{stats['weight_equal_share']} of elements (needs "
                  f">= 0.999), {stats['weight_max_ulps']} ulps apart at "
                  f"most (needs <= 1)")
    return stats


def opt_case(name, make, dtype, shapes, gen, dev, steps=3, nan_at=None):
    """The kernel (kernel="cuda") and the plain twin (kernel="plain")
    from the same weights over `steps` steps of the same seeded grads,
    the learning rate halved before step 3, held against each other
    after every step. `nan_at` = (tensor, flat index) poisons that grad
    element at step 1. Returns (the last step's figures, kernel launches
    a step)."""
    import torch
    from paddle_tpu_torch.optimizer import fused_adam
    init = [torch.randn(s, generator=gen, device=dev) * 0.05 for s in shapes]
    pk = [torch.nn.Parameter(t.to(dtype, copy=True)) for t in init]
    pp = [torch.nn.Parameter(t.to(dtype, copy=True)) for t in init]
    del init
    check(all(a.data_ptr() != b.data_ptr() for a, b in zip(pk, pp)),
          f"optimizer {name}: the two sides share weights")
    ok, op = make(pk, "cuda"), make(pp, "plain")
    lr = ok.get_lr()
    for step in range(1, steps + 1):
        if step == 3:
            ok.set_lr(lr / 2)
            op.set_lr(lr / 2)
        for i, (a, b) in enumerate(zip(pk, pp)):
            g = (torch.randn(a.shape, generator=gen, device=dev)
                 * 1e-2).to(dtype)
            if nan_at is not None and step == 1 and i == nan_at[0]:
                g.view(-1)[nan_at[1]] = float("nan")
            a.grad = b.grad = g
        before = fused_adam.launches["adam"]
        ok.step()
        op.step()
        per_step = fused_adam.launches["adam"] - before
        stats = opt_held(f"{name} step {step}", opt_slots(ok, pk),
                         opt_slots(op, pp))
    if nan_at is not None:
        t, j = nan_at
        for slot, tensors in opt_slots(ok, pk).items():
            bad = [int((~torch.isfinite(x)).sum()) for x in tensors]
            check(sum(bad) == 1 and bad[t] == 1
                  and not torch.isfinite(tensors[t].view(-1)[j]).item(),
                  f"optimizer {name}: a NaN grad element reached {slot} "
                  f"other than at its own element ({sum(bad)} non-finite)")
    return stats, per_step


def opt_bound(params, master, peaks):
    """Least time of one step: each weight (read and written), grad
    (read) and f32 moment and master (read and written) moved once over
    the HBM rate, against about 20 f32 operations an element over the
    f32 peak. Returns (ms, "bytes" | "operations", bytes)."""
    nbytes = sum(p.numel() * (3 * p.element_size() + 16 + (8 if master
                                                           else 0))
                 for p in params)
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = 20 * sum(p.numel() for p in params) / peaks["f32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (nbytes,)


def with_attrs(make, attrs):
    """`make` over parameters given the attributes attrs(i) first."""
    def made(ps, kernel):
        for i, p in enumerate(ps):
            for key, val in attrs(i).items():
                setattr(p, key, val)
        return make(ps, kernel)
    return made


def all_l1(i):
    from paddle_tpu_torch.regularizer import L1Decay
    return {"regularizer": L1Decay(1e-3)}


def l2_half(i):
    from paddle_tpu_torch.regularizer import L2Decay
    return {"regularizer": L2Decay(1e-2), "learning_rate": 0.5}


def mixed_groups(i):
    """Four groups: L1, lr x 2, L2 with lr x 0.5, the defaults."""
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay
    return ({"regularizer": L1Decay(1e-3)}, {"learning_rate": 2.0},
            {"regularizer": L2Decay(1e-2), "learning_rate": 0.5}, {})[i % 4]


def optimizer_phase(dev, peaks):
    import numpy as np
    import torch
    from paddle_tpu_torch.optimizer import Adam, AdamW, fused_adam
    from paddle_tpu_torch.regularizer import L1Decay

    shapes = gpt2_param_shapes()
    check(len(shapes) == 148 and sum(int(np.prod(s)) for s in shapes)
          == 111008256, f"GPT-2 small: {len(shapes)} parameter tensors")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32

    def adamw(**kw):
        return lambda ps, k: AdamW(1e-3, parameters=ps, weight_decay=0.01,
                                   kernel=k, **kw)

    def adam_l2(ps, k):
        return Adam(1e-3, parameters=ps, weight_decay=0.01, kernel=k)

    def adam_l1(ps, k):
        return Adam(1e-3, parameters=ps, weight_decay=L1Decay(1e-3),
                    kernel=k)

    cases = {}
    for name, make, dtype in (("adamw bf16", adamw(), bf16),
                              ("adamw f32", adamw(), f32),
                              ("adamw bf16 multi_precision",
                               adamw(multi_precision=True), bf16),
                              ("adam l2 bf16", adam_l2, bf16)):
        stats, per_step = opt_case(name, make, dtype, shapes, gen, dev)
        check(per_step == 1, f"optimizer {name}: {per_step} launches a "
                             f"step, not 1")
        cases[name] = stats
        torch.cuda.empty_cache()
    # odd sizes (the scalar tail) and 300 tensors (two launches a step)
    rng = np.random.default_rng(SEED + 6)
    ragged = [(int(n),) for n in rng.integers(1, 20000, 300)]
    for name, make, dtype in (("ragged adamw bf16 multi_precision",
                               adamw(multi_precision=True), bf16),
                              ("ragged adam l2 f32", adam_l2, f32)):
        stats, per_step = opt_case(name, make, dtype, ragged, gen, dev)
        check(per_step == 2, f"optimizer {name}: {per_step} launches a "
                             f"step for 300 tensors, not 2")
        cases[name] = stats
    # a NaN in one grad element reaches only that element
    cases["nan"], _ = opt_case("nan", adamw(), bf16, shapes, gen, dev,
                               steps=1, nan_at=(4, 12345))
    torch.cuda.empty_cache()
    # the regularizer's gradient term (L1, L2) with and without AdamW's
    # decoupled decay, a learning-rate multiplier, and four groups in one
    # step (a launch each)
    for name, make, dtype, want in (
            ("adam l1 bf16", adam_l1, bf16, 1),
            ("adamw l1 bf16 multi_precision",
             with_attrs(adamw(multi_precision=True), all_l1), bf16, 1),
            ("adamw l2 lr_scale 0.5 f32", with_attrs(adamw(), l2_half), f32,
             1),
            ("adamw mixed groups bf16 multi_precision",
             with_attrs(adamw(multi_precision=True), mixed_groups), bf16,
             4)):
        stats, per_step = opt_case(name, make, dtype, shapes, gen, dev)
        check(per_step == want, f"optimizer {name}: {per_step} launches a "
                                f"step, not {want}")
        cases[name] = stats
        torch.cuda.empty_cache()

    # refusals, before any launch: a CPU tensor, a misaligned view
    p = torch.zeros(1024, dtype=bf16, device=dev)
    m = torch.zeros(1024, device=dev)
    sc = torch.zeros(2, device=dev)
    flat = torch.zeros(1025, dtype=bf16, device=dev)
    before = dict(fused_adam.launches)
    for what, args, want in (
            ("a CPU weight", ([p.cpu()], [p], [m], [m]), "param 0 is on cpu"),
            ("a misaligned weight", ([flat[1:]], [p], [m], [m]),
             "param 0 needs"),
            ("a misaligned grad", ([p], [flat[1:]], [m], [m]),
             "grad 0 needs")):
        try:
            fused_adam.cuda_adam(*args, None, sc, 0.9, 0.999, 1e-8)
            refused = None
        except (RuntimeError, ValueError) as exc:
            refused = str(exc)
        check(refused is not None and want in refused
              and fused_adam.launches == before,
              f"optimizer: {what} was not refused by name ({refused})")

    # times: one whole AdamW step over GPT-2 small's bf16 weights
    init = [torch.randn(s, generator=gen, device=dev).to(bf16) * 0.05
            for s in shapes]
    sets = []
    for _ in range(3):
        ps = [torch.nn.Parameter(t.clone()) for t in init]
        for q in ps:
            q.grad = (torch.randn(q.shape, generator=gen, device=dev)
                      * 1e-2).to(bf16)
        sets.append(ps)
    del init
    ok = AdamW(1e-4, parameters=sets[0], weight_decay=0.01, kernel="cuda")
    op = AdamW(1e-4, parameters=sets[1], weight_decay=0.01, kernel="plain")
    bound_ms, bound_by, nbytes = opt_bound(sets[0], False, peaks)
    kernel_ms = graph_ms(ok.step, 1)
    results = {
        "cases": cases, "tensors": len(shapes),
        "params": sum(q.numel() for q in sets[0]),
        "max_abs_err": cases["adamw bf16"]["weight_max_abs_err"],
        "kernel_ms": kernel_ms,
        "gbytes_per_s": nbytes / kernel_ms * 1e-6,
        "eager_call_ms": time_ms(ok.step, 20),
        "plain_ms": graph_ms(op.step, 1),
        "plain_eager_ms": time_ms(op.step, 5),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "what": "kernel_ms / plain_ms / library_ms: one optimizer step "
                "captured in a CUDA graph and replayed; eager_call_ms and "
                "plain_eager_ms: eager calls, CUDA events (host time)"}
    try:
        lib = torch.optim.AdamW(sets[2], lr=1e-4, weight_decay=0.01,
                                fused=True, capturable=True)
        results["library_ms"] = graph_ms(lib.step, 1)
        results["library"] = (
            "torch.optim.AdamW(fused=True, capturable=True) on the same "
            "bf16 weights and grads: not the same rule, since it keeps its "
            "moments in the weights' dtype (bf16: 14 bytes a parameter, "
            "not 22) and decays p by (1 - lr wd) before the update")
    except RuntimeError as exc:
        results["library_ms"] = None
        results["library"] = f"null: {type(exc).__name__}: {exc}"[:400]
    # the four-group step (L1; lr x 2; L2 with lr x 0.5; defaults) over
    # the same weights with f32 masters: four launches
    for ps in sets[:2]:
        for i, q in enumerate(ps):
            for key, val in mixed_groups(i).items():
                setattr(q, key, val)
    okm = AdamW(1e-4, parameters=sets[0], weight_decay=0.01,
                multi_precision=True, kernel="cuda")
    opm = AdamW(1e-4, parameters=sets[1], weight_decay=0.01,
                multi_precision=True, kernel="plain")
    mixed_bound, _, mixed_bytes = opt_bound(sets[0], True, peaks)
    results["mixed_groups"] = {
        "what": "AdamW, bf16 weights with f32 masters, 4 groups a step "
                "(L1 / lr x 2 / L2 and lr x 0.5 / defaults): 4 launches",
        "kernel_ms": graph_ms(okm.step, 1), "plain_ms": graph_ms(opm.step, 1),
        "bound_ms": mixed_bound, "bound_bytes": mixed_bytes}
    del sets, ok, op, okm, opm
    torch.cuda.empty_cache()
    results["nine"] = nine_optimizers(dev, peaks, shapes, gen)
    return results


# the other nine rules (`_foreach_*` over all parameters), each as a user
# would build it, and the f32 state slots each reads and writes
NINE = {
    "Momentum": (lambda o, ps: o.Momentum(1e-2, momentum=0.9,
                                          use_nesterov=True, parameters=ps),
                 1),
    "Adamax": (lambda o, ps: o.Adamax(1e-3, parameters=ps), 2),
    "Adagrad": (lambda o, ps: o.Adagrad(
        1e-2, parameters=ps, initial_accumulator_value=0.1), 1),
    "Adadelta": (lambda o, ps: o.Adadelta(1.0, parameters=ps), 2),
    "RMSProp": (lambda o, ps: o.RMSProp(1e-3, momentum=0.9, centered=True,
                                        parameters=ps), 3),
    "Lamb": (lambda o, ps: o.Lamb(1e-3, parameters=ps), 2),
    "Lars": (lambda o, ps: o.Lars(1e-2, parameters=ps), 1),
    "Ftrl": (lambda o, ps: o.Ftrl(0.05, l2=0.01, parameters=ps), 2),
    "Dpsgd": (lambda o, ps: o.Dpsgd(1e-2, sigma=0.0, parameters=ps,
                                    seed=SEED), 0),
}


def capture(fn, generators=()):
    """fn captured in a CUDA graph (after the caller's eager warm-up),
    the generators registered so that each replay draws fresh numbers;
    returns the graph."""
    import torch
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        fn()
    return graph


def opt_state_equal(a, b):
    """Whether two optimizers hold bitwise equal state."""
    import torch
    return all(torch.equal(a._state[i][n], b._state[i][n])
               for i in a._state for n in a._state[i])


def nine_optimizers(dev, peaks, shapes, gen, steps=3, cpu_steps=1):
    """Each of the nine over GPT-2 small's 148 f32 parameter shapes: one
    eager step, then its step() captured in a CUDA graph and replayed,
    against the same optimizer stepped eagerly (bitwise equal after every
    one of `steps` steps), and after `cpu_steps` steps against a CPU run
    (weights within rtol 1e-5, atol 1e-7). The CPU's steps are the
    phase's cost (about 0.9 s each over 111M parameters), so there is
    one: it runs every operation of the rule, on zero state; one step's
    device ms by graph
    replay beside its byte bound (each weight read and written, each
    grad read, each f32 state slot read and written, once). Dpsgd runs
    at sigma 0 here (its noise is held by `dpsgd_noise`)."""
    import torch
    from paddle_tpu_torch import optimizer as topt
    out = {}
    cur = torch.cuda.current_stream()
    for name, (make, slots) in NINE.items():
        init = [torch.randn(s, generator=gen, device=dev) * 0.05
                for s in shapes]
        grads = [torch.randn(s, generator=gen, device=dev) * 1e-2
                 for s in shapes]
        pe = [torch.nn.Parameter(t.clone()) for t in init]
        pg = [torch.nn.Parameter(t.clone()) for t in init]
        pc = [torch.nn.Parameter(t.cpu()) for t in init]
        del init
        for a, b, c, g in zip(pe, pg, pc, grads):
            a.grad = b.grad = g
            c.grad = g.cpu()
        oe, og, oc = make(topt, pe), make(topt, pg), make(topt, pc)
        t0 = time.perf_counter()
        for _ in range(cpu_steps):
            oc.step()
        cpu_s = time.perf_counter() - t0
        oe.step()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            og.step()                  # eager: makes the state and the pair
        cur.wait_stream(side)
        graph = capture(og.step, [og.generator] if name == "Dpsgd" else [])
        errs, used = [], []
        for step in range(1, steps + 1):
            if step > 1:
                oe.step()
                og._advance()
                graph.replay()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(pe, pg))
                  and opt_state_equal(oe, og),
                  f"optimizer {name}: the graphed step {step} differs "
                  f"from the eager one")
            if step != cpu_steps:
                continue
            for a, c in zip(pe, pc):
                ref = c.detach().to(dev)
                err = (a.detach() - ref).abs()
                lim = 1e-5 * ref.abs() + 1e-7
                check(bool((err <= lim).all()),
                      f"optimizer {name}: CUDA weights differ from the CPU "
                      f"run by {err.max().item()} (rtol 1e-5, atol 1e-7)")
                errs.append(err.max().item())
                used.append((err / lim).max().item())
        n = sum(p.numel() for p in pe)
        nbytes = n * (12 + 8 * slots)
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / 10,
                     "bound_ms": nbytes / peaks["bw"] * 1e3,
                     "bound_by": "bytes", "bound_bytes": nbytes,
                     "max_abs_err_vs_cpu": max(errs),
                     "tolerance_used_vs_cpu": max(used),
                     "cpu_s_per_step": cpu_s / cpu_steps,
                     "graphed_steps_equal_eager": steps,
                     "cpu_steps": cpu_steps}
        del pe, pg, pc, grads, oe, og, oc, graph
        torch.cuda.empty_cache()
    out["dpsgd_noise"] = dpsgd_noise(dev)
    return out


def dpsgd_noise(dev, lr=0.1, clip=2.0, sigma=1.5, batch=8.0):
    """Dpsgd with sigma > 0 in a CUDA graph, its generator registered:
    with zero grads an update is -lr * noise; two replays draw different
    noise whose std is clip * sigma / batch_size within 2%, and a second
    optimizer with the same seed draws the same first noise."""
    import torch
    from paddle_tpu_torch.optimizer import Dpsgd
    std = clip * sigma / batch
    ps = [torch.nn.Parameter(torch.zeros(2048, 1024, device=dev))
          for _ in range(2)]
    opts = [Dpsgd(lr, clip=clip, batch_size=batch, sigma=sigma,
                  parameters=[p], seed=SEED) for p in ps]
    for p in ps:
        p.grad = torch.zeros_like(p)
    for o in opts:
        o.step()
    check(torch.equal(ps[0], ps[1]), "dpsgd: one seed drew two noises")
    opt, p = opts[0], ps[0]
    graph = capture(opt.step, [opt.generator])
    draws = []
    for _ in range(2):
        before = p.detach().clone()
        opt._advance()
        graph.replay()
        torch.cuda.synchronize()
        draws.append((before - p.detach()) / lr)
    stds = [d.std().item() for d in draws]
    check(not torch.equal(draws[0], draws[1]),
          "dpsgd: two replays drew the same noise")
    check(all(abs(x / std - 1) < 0.02 for x in stds),
          f"dpsgd: noise std {stds}, not {std} within 2%")
    return {"noise_std": stds, "want": std, "elements": p.numel()}


# ---------------------------------------------------------------------------
# parity: the CUDA kernel against the reference kernel through serving
# ---------------------------------------------------------------------------

def record_streams(model, kernel, prompts, max_tokens, dev, graphed,
                   paged=True, **sampling):
    """Serve `prompts` through create_llm_predictor, as CUDA graphs or
    eagerly (`switch_ir_optim`), on the paged engine (its `kernel`) or
    the dense one (a 256-token bucket), and record the f32 logits row
    behind every emitted token of every request. The rows are read from
    the engine's program outputs after each wave and each final prefill
    (chunk): under graph replay the model's methods run only at capture.
    Returns the streams, the rows and the engine."""
    import torch
    from paddle_tpu_torch import inference

    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    if paged:
        cfg.enable_llm_engine(paged=True, num_slots=4, max_len=256,
                              block_size=BLOCK, prefill_len=CHUNK,
                              paged_kernel=kernel, device=dev)
    else:
        cfg.enable_llm_engine(num_slots=4, max_len=256, prefill_len=256,
                              device=dev)
    pred = inference.create_llm_predictor(cfg, model=model)
    eng, sched = pred.engine, pred.scheduler
    reqs = []
    steps = [[] for _ in prompts]

    def owner(slot):
        req = sched._slot_req[slot]
        return next(i for i, r in enumerate(reqs) if r is req)

    orig_prefill, orig_wave = eng.prefill_step, eng.decode_wave

    def prefill_step(slot):
        st = eng._pending_prefill[slot]
        last = not paged or st["next"] + eng.prefill_chunk_len >= st["n"]
        first = orig_prefill(slot)
        if last:
            steps[owner(slot)].append(
                eng.last_prefill_logits.to("cpu", copy=True))
        return first

    def decode_wave():
        live = [s for s, a in enumerate(eng.slot_active) if a]
        out = orig_wave()
        waved = [s for s in live if s not in eng.last_starved_slots]
        if waved:
            rows = eng.last_wave_logits.to("cpu", copy=True)
            for s in waved:
                steps[owner(s)].append(rows[s])
        return out

    eng.prefill_step, eng.decode_wave = prefill_step, decode_wave
    reqs.extend(pred.submit(prompt=p, max_tokens=max_tokens, **sampling)
                for p in prompts)
    pred.run()
    torch.cuda.synchronize()
    return [r.output_tokens for r in reqs], steps, eng


def against_reference(ref_toks, ref_steps, out_toks, out_steps, tol):
    """The CUDA kernel's streams against the reference kernel's: finite
    logits within `tol` at every step up to where the streams part,
    which they may only at a top-2 margin under `tol`. Returns (max
    logit error, steps compared, max |logit|, near ties)."""
    import torch
    near_ties, max_err, compared, scale = 0, 0.0, 0, 0.0
    for i in range(len(ref_toks)):
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
    return max_err, compared, scale, near_ties


def graphed_against_eager(out_toks, out_steps, g_toks, g_steps, graph_tol):
    """Graphed streams equal the eager ones and every logits row lies
    within graph_tol x max(1, |eager|). Returns (max error, max error
    over its bound)."""
    check(g_toks == out_toks, f"graphed streams {g_toks} != eager {out_toks}")
    graph_err, graph_share = 0.0, 0.0
    for i in range(len(out_toks)):
        check(len(g_steps[i]) == len(out_steps[i]) == 16,
              f"request {i}: {len(g_steps[i])} graphed logits rows")
        for t, (le, lg) in enumerate(zip(out_steps[i], g_steps[i])):
            err = (le - lg).abs().max().item()
            bound = graph_tol * max(1.0, le.abs().max().item())
            graph_err = max(graph_err, err)
            graph_share = max(graph_share, err / bound)
            check(err <= bound, f"request {i} step {t}: graphed logits "
                                f"differ from eager by {err} > {bound}")
    return graph_err, graph_share


def parity_phase(dev, smi):
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
    ref_toks, ref_steps, _ = record_streams(model, "reference", prompts,
                                            16, dev, graphed=False)
    out_toks, out_steps, _ = record_streams(model, "cuda", prompts, 16, dev,
                                            graphed=False)
    max_err, compared, scale, near_ties = against_reference(
        ref_toks, ref_steps, out_toks, out_steps, tol)

    # the graphed engine against the eager one: the same kernels on the
    # same inputs, so equal streams and logits equal to 1e-6 relative
    g_toks, g_steps, g_eng = record_streams(model, "cuda", prompts, 16, dev,
                                            graphed=True)
    graph_tol = 1e-6
    graph_err, graph_share = graphed_against_eager(out_toks, out_steps,
                                                   g_toks, g_steps,
                                                   graph_tol)
    compiles = {"decode": g_eng.decode_compiles,
                "prefill": g_eng.prefill_compiles}
    check(compiles == {"decode": 1, "prefill": 1},
          f"graphed greedy engine compiled {compiles}")
    replays = {"decode": g_eng.wave_program.replays,
               "prefill": g_eng.prefill_program.replays}

    # sampled streams: two graphed engines with one seed, and the eager one
    knobs = dict(do_sample=True, top_k=50, top_p=0.9)
    s1, _, s_eng = record_streams(model, "cuda", prompts, 16, dev,
                                  graphed=True, **knobs)
    s2, _, _ = record_streams(model, "cuda", prompts, 16, dev, graphed=True,
                              **knobs)
    s_eager, _, _ = record_streams(model, "cuda", prompts, 16, dev,
                                   graphed=False, **knobs)
    check(s1 == s2, f"two graphed sampled engines with one seed differ: "
                    f"{s1} vs {s2}")
    dense = dense_parity(model, prompts, dev, ref_toks, ref_steps, out_toks,
                         tol, graph_tol)
    spec = spec_parity(model, prompts, dev, out_toks, out_steps, tol)
    disagg = disagg_parity(model, prompts, dev, out_toks, out_steps, tol)
    mask = mask_parity(model, prompts, dev, out_toks, out_steps, tol)
    fault = fault_parity(model, prompts, dev, g_toks, s1, knobs)
    drain = drain_check(model, prompts, dev)
    del model
    llama = llama_parity(dev, [len(p) for p in prompts], tol, graph_tol)
    emit("parity", dtype="float32", layers=LAYERS, requests=len(prompts),
         steps_compared=compared, max_logit_err=max_err, tolerance=tol,
         max_abs_logit=scale, near_tie_steps=near_ties,
         streams_equal=ref_toks == out_toks,
         distinct_tokens=[len(set(t)) for t in ref_toks],
         graphed_vs_eager={
             "streams_equal": g_toks == out_toks,
             "max_logit_err": graph_err,
             "max_err_over_bound": graph_share,
             "tolerance": f"{graph_tol} x max(1, |eager logits|)",
             "compiles": compiles, "replays": replays},
         sampled={"knobs": knobs, "graphed_twice_equal": s1 == s2,
                  "graphed_equals_eager": s1 == s_eager,
                  "equals_greedy": s1 == g_toks,
                  "compiles": {"decode": s_eng.decode_compiles,
                               "prefill": s_eng.prefill_compiles},
                  "distinct_tokens": [len(set(t)) for t in s1]},
         dense=dense, spec=spec, disagg=disagg, token_mask=mask,
         wave_fault=fault, drain=drain, llama=llama, nvidia_smi=smi)


def llama_config(**kw):
    """The JAX package's serving LLaMA (scripts/bench_decode.py:47-49):
    vocab 32000, 768 wide, 12 layers, 12 heads of 64 over 4 KV heads
    (GQA rep 3); LlamaConfig's defaults otherwise (SwiGLU 2048, rope
    theta 10000, a 2048-row rope table, RMSNorm eps 1e-6, tied
    embeddings)."""
    from paddle_tpu_torch.nlp import LlamaConfig
    return LlamaConfig(**dict(dict(vocab_size=32000, hidden_size=768,
                                   num_layers=12, num_heads=12,
                                   num_kv_heads=4), **kw))


def llama_parity(dev, lengths, tol, graph_tol):
    """fp32 LLaMA serving at full width and 2 layers (GQA rep 3): the
    paged engine's streams through K4 against the reference kernel's,
    graphed equal to eager; the dense engine (K1 prefill), the
    speculative engine (a 1-layer LLaMA draft) and a prefill-role /
    decode-role pair joined by the handoff, each against the paged
    engine's streams (the shared near-tie rule). `lengths`: the prompts'
    token counts (seeded ids in LLaMA's vocabulary)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    model = LlamaForCausalLM(llama_config(num_layers=2,
                                          initializer_range=0.1),
                             device=dev, dtype=torch.float32, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in lengths]
    ref_toks, ref_steps, _ = record_streams(model, "reference", prompts,
                                            16, dev, graphed=False)
    out_toks, out_steps, _ = record_streams(model, "cuda", prompts, 16, dev,
                                            graphed=False)
    max_err, compared, scale, near_ties = against_reference(
        ref_toks, ref_steps, out_toks, out_steps, tol)
    g_toks, g_steps, g_eng = record_streams(model, "cuda", prompts, 16, dev,
                                            graphed=True)
    graph_err, graph_share = graphed_against_eager(out_toks, out_steps,
                                                   g_toks, g_steps,
                                                   graph_tol)
    compiles = {"decode": g_eng.decode_compiles,
                "prefill": g_eng.prefill_compiles}
    check(compiles == {"decode": 1, "prefill": 1},
          f"graphed greedy LLaMA engine compiled {compiles}")
    del g_eng
    dense = dense_parity(model, prompts, dev, ref_toks, ref_steps, out_toks,
                         tol, graph_tol)
    draft = LlamaForCausalLM(llama_config(num_layers=1,
                                          initializer_range=0.1),
                             device=dev, dtype=torch.float32,
                             seed=SEED + 7)
    spec = spec_parity(model, prompts, dev, out_toks, out_steps, tol,
                       drafts={"llama_1_layer": draft})
    disagg = disagg_parity(model, prompts, dev, out_toks, out_steps, tol)
    del model, draft
    torch.cuda.synchronize()
    return {"config": "vocab 32000, 768 wide, 2 layers, 12 heads over 4 "
                      "KV heads (rep 3), SwiGLU 2048, initializer 0.1",
            "steps_compared": compared, "max_logit_err": max_err,
            "max_abs_logit": scale, "near_tie_steps": near_ties,
            "streams_equal": ref_toks == out_toks,
            "distinct_tokens": [len(set(t)) for t in ref_toks],
            "graphed_vs_eager": {"streams_equal": True,
                                 "max_logit_err": graph_err,
                                 "max_err_over_bound": graph_share,
                                 "compiles": compiles},
            "dense": dense, "spec": spec, "disagg": disagg}


def distilgpt2_shape(**kw):
    """The draft's config: GPT-2 small's widths and padded vocabulary at
    DRAFT_LAYERS layers, dropout off."""
    from paddle_tpu_torch.nlp import GPTConfig
    return GPTConfig(hidden_size=768, num_layers=DRAFT_LAYERS, num_heads=12,
                     dropout=0.0, attn_dropout=0.0, **kw)


def spec_streams(model, draft, prompts, max_tokens, dev, graphed):
    """Greedy streams of the speculative engine (k = SPEC_K) through the
    front door, the parity phase's paged configuration, as CUDA graphs or
    eagerly. Returns the streams and the predictor."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import SpeculativePagedEngine
    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    cfg.enable_llm_engine(speculative=True, k=SPEC_K, num_slots=4,
                          max_len=256, block_size=BLOCK, prefill_len=CHUNK,
                          device=dev)
    pred = inference.create_llm_predictor(cfg, model=model,
                                          draft_model=draft)
    check(isinstance(pred.engine, SpeculativePagedEngine)
          and pred.engine.paged_kernel == "cuda",
          f"speculative front door built {pred.engine.describe()}")
    reqs = [pred.submit(prompt=p, max_tokens=max_tokens) for p in prompts]
    pred.run()
    torch.cuda.synchronize()
    return [r.output_tokens for r in reqs], pred


def near_tie_check(name, want_toks, want_steps, got_toks, tol):
    """Streams equal the reference's, or part from it at a position where
    the reference's top-2 logit margin is under `tol`. Returns where."""
    import torch
    diverged = []
    for i, (want, got) in enumerate(zip(want_toks, got_toks)):
        check(len(got) == len(want), f"{name} request {i}: {len(got)} "
                                     f"tokens, want {len(want)}")
        for t, (a, b) in enumerate(zip(want, got)):
            if a != b:
                top2 = torch.topk(want_steps[i][t], 2).values
                gap = (top2[0] - top2[1]).item()
                check(gap < tol, f"{name} request {i} position {t}: "
                                 f"tokens {a} vs {b} with top-2 margin "
                                 f"{gap} >= {tol}")
                diverged.append({"request": i, "position": t,
                                 "top2_margin": gap})
                break
    return diverged


def spec_parity(model, prompts, dev, paged_toks, paged_steps, tol,
                drafts=None):
    """fp32 greedy streams of the speculative engine over each of
    `drafts` (name -> draft; by default, at GPT-2 width, a
    DistilGPT2-shaped random draft and the target as its own draft),
    eager and graphed: graphed equal to eager, one graph per program, and
    equal to the paged CUDA engine's streams. Where a stream leaves the
    paged one, the paged target's top-2 logit margin at that position
    must be under `tol` (a near tie that the verify chunk's summation
    order may break the other way); the position and margin are
    reported."""
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining
    if drafts is None:
        drafts = {"distilgpt2_shape": GPTForPretraining(
            distilgpt2_shape(initializer_range=0.1), device=dev,
            dtype=torch.float32, seed=SEED + 7), "self": model}
    out = {}
    for name, dm in drafts.items():
        eager, e_pred = spec_streams(model, dm, prompts, 16, dev, False)
        graphed, g_pred = spec_streams(model, dm, prompts, 16, dev, True)
        check(graphed == eager, f"spec {name}: graphed streams {graphed} "
                                f"!= eager {eager}")
        eng = g_pred.engine
        compiles = {"draft": eng.draft_compiles,
                    "verify": eng.decode_compiles,
                    "prefill": eng.prefill_compiles}
        check(compiles == {"draft": 1, "verify": 1, "prefill": 1},
              f"spec {name}: graphed greedy engine compiled {compiles}")
        diverged = near_tie_check(f"spec {name}", paged_toks, paged_steps,
                                  eager, tol)
        snap = e_pred.metrics.snapshot()
        out[name] = {"streams_equal_paged": eager == paged_toks,
                     "diverged_at": diverged,
                     "graphed_equals_eager": True, "compiles": compiles,
                     "replays": {"draft": eng.draft_program.replays,
                                 "verify": eng.wave_program.replays,
                                 "prefill": eng.prefill_program.replays},
                     "acceptance_rate": snap["spec_acceptance_rate"],
                     "decode_waves": snap["decode_waves"]}
        del e_pred, g_pred, eng
    del drafts
    torch.cuda.synchronize()
    return out


def dense_parity(model, prompts, dev, ref_toks, ref_steps, paged_toks, tol,
                 graph_tol):
    """The dense engine (K1 prefill at a 256-token bucket, the dense
    decode wave) on the parity prompts, eager and graphed: its streams
    equal the paged CUDA engine's, its logits within `tol` of the
    reference engine's at every step up to where the reference's own
    stream leaves it (a near tie, as the paged check allows), and the
    graphed engine equal to the eager one (logits within `graph_tol` x
    max(1, |eager|), one decode and one prefill graph)."""
    import torch
    d_toks, d_steps, d_eng = record_streams(model, None, prompts, 16, dev,
                                            graphed=False, paged=False)
    check(d_eng.prefill_route == "k1",
          f"dense parity engine took the {d_eng.prefill_route} route")
    check(d_toks == paged_toks, f"dense streams {d_toks} != paged "
                                f"{paged_toks}")
    max_err, compared = 0.0, 0
    for i in range(len(prompts)):
        for t, (a, b) in enumerate(zip(ref_toks[i], d_toks[i])):
            err = (ref_steps[i][t] - d_steps[i][t]).abs().max().item()
            max_err = max(max_err, err)
            compared += 1
            check(err <= tol, f"dense request {i} step {t}: logits differ "
                              f"from the reference engine's by {err}")
            if a != b:
                top2 = torch.topk(ref_steps[i][t], 2).values
                gap = (top2[0] - top2[1]).item()
                check(gap < tol, f"dense request {i} step {t}: tokens {a} "
                                 f"vs {b} with top-2 gap {gap} >= {tol}")
                break
    g_toks, g_steps, g_eng = record_streams(model, None, prompts, 16, dev,
                                            graphed=True, paged=False)
    check(g_toks == d_toks, f"graphed dense streams {g_toks} != eager "
                            f"{d_toks}")
    graph_err = 0.0
    for i in range(len(prompts)):
        check(len(g_steps[i]) == len(d_steps[i]) == 16,
              f"dense request {i}: {len(g_steps[i])} graphed logits rows")
        for t, (le, lg) in enumerate(zip(d_steps[i], g_steps[i])):
            err = (le - lg).abs().max().item()
            graph_err = max(graph_err, err)
            check(err <= graph_tol * max(1.0, le.abs().max().item()),
                  f"dense request {i} step {t}: graphed logits differ "
                  f"from eager by {err}")
    compiles = {"decode": g_eng.decode_compiles,
                "prefill": g_eng.prefill_compiles}
    check(compiles == {"decode": 1, "prefill": 1},
          f"graphed greedy dense engine compiled {compiles}")
    torch.cuda.synchronize()
    return {"route": d_eng.prefill_route, "streams_equal_paged": True,
            "streams_equal_reference": d_toks == ref_toks,
            "steps_compared": compared, "max_logit_err": max_err,
            "graphed_vs_eager": {"streams_equal": True,
                                 "max_logit_err": graph_err,
                                 "compiles": compiles,
                                 "replays": {
                                     "decode": g_eng.wave_program.replays,
                                     "prefill":
                                         g_eng.prefill_program.replays}}}


# ---------------------------------------------------------------------------
# the serving policy: disaggregated roles, token masks, wave faults, drain
# ---------------------------------------------------------------------------

def handoff_loop(prefill, decode, jobs):
    """Disaggregated serving's round (the JAX fleet's DisaggFleetRouter
    .step / ._handoff): step the prefill-role scheduler, hand each staged
    (request, payload) to the decode-role scheduler as prompt + first
    token with the remaining budget, step the decode role; until both
    are idle. Returns [(prefill hop, decode hop or None)] per job."""
    from paddle_tpu_torch.serving import Request
    firsts = [prefill.submit(prompt=p, max_tokens=m) for p, m in jobs]
    hops = {}
    while True:
        pending = prefill.step()
        for req, payload in prefill.take_handoffs():
            check(payload is not None,
                  f"handoff export failed: {prefill.last_error!r}")
            hops[id(req)] = decode.submit(request=Request(
                prompt=req.prompt + req.output_tokens,
                max_tokens=req.max_tokens - len(req.output_tokens),
                handoff=payload))
        pending += decode.step()
        if not pending:
            return [(r, hops.get(id(r))) for r in firsts]


def hop_stream(first, hop):
    return first.output_tokens + (hop.output_tokens if hop else [])


def role_schedulers(model, num_slots, max_len, chunk, graphed=True):
    """A prefill-role and a decode-role scheduler, each over its own
    PagedServingEngine of one geometry, sharing `model`."""
    from paddle_tpu_torch.serving import PagedServingEngine, Scheduler
    return [Scheduler(PagedServingEngine(
        model, num_slots=num_slots, max_len=max_len, block_size=BLOCK,
        prefill_chunk_len=chunk, device=model.device, cuda_graph=graphed),
        role=role) for role in ("prefill", "decode")]


def disagg_parity(model, prompts, dev, paged_toks, paged_steps, tol):
    """fp32 disaggregated serving: a prefill-role and a decode-role
    engine, graphed, joined by the handoff loop. Streams equal the
    unified paged engine's (near ties aside); the roles stay pure by
    graph count; every payload equals a gather of its blocks taken after
    synchronize(); a payload with one flipped byte is refused with the
    importing pool unchanged."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import HandoffRefused
    prefill, decode = role_schedulers(model, 4, 256, CHUNK)
    pe, de = prefill.engine, decode.engine
    export, exported = pe.export_slot_kv, []

    def checked_export(slot):
        blocks = list(pe._slot_blocks[slot])
        req = prefill._slot_req[slot]
        payload = export(slot)
        torch.cuda.synchronize()
        idx = torch.tensor(blocks, device=dev)
        for pool, a in zip(pe._pool_leaves(), payload["layers"]):
            check(np.array_equal(pool.index_select(0, idx).cpu().numpy(),
                                 a), "a payload differs from its blocks "
                                     "gathered after synchronize()")
        exported.append((req.prompt + req.output_tokens, payload))
        return payload
    pe.export_slot_kv = checked_export
    pairs = handoff_loop(prefill, decode, [(p, 16) for p in prompts])
    toks = [hop_stream(a, b) for a, b in pairs]
    diverged = near_tie_check("disagg", paged_toks, paged_steps, toks, tol)
    compiles = {"prefill_role": {"decode": pe.decode_compiles,
                                 "prefill": pe.prefill_compiles},
                "decode_role": {"decode": de.decode_compiles,
                                "prefill": de.prefill_compiles}}
    check(compiles == {"prefill_role": {"decode": 0, "prefill": 1},
                       "decode_role": {"decode": 1, "prefill": 0}},
          f"disagg roles compiled {compiles}")
    check(pe.decode_waves_run == 0 and de.prefill_chunks_run == 0,
          "a role ran the other role's program")
    cont, payload = exported[0]
    bad = dict(payload, layers=[np.array(a) for a in payload["layers"]])
    bad["layers"][0].view(np.uint8).flat[0] ^= 1
    used = de.block_pool.used
    try:
        de.import_handoff(0, cont, bad)
        refused = False
    except HandoffRefused:
        refused = True
    check(refused and de.block_pool.used == used and not de.slot_active[0],
          "a corrupt payload was not refused with the pool rolled back")
    de.import_handoff(0, cont, payload)
    check(de.slot_active[0] and de.block_pool.used == used + len(
        payload["manifest"]), "the pristine payload did not import")
    de.retire_slot(0)
    torch.cuda.synchronize()
    return {"streams_equal_paged": toks == paged_toks,
            "diverged_at": diverged, "compiles": compiles,
            "payloads_checked": len(exported),
            "payload_bytes": [p["nbytes"] for _, p in exported],
            "corrupt_payload_refused": refused}


MASK_ALLOWED = (3, 5, 9)


def alternating_mask(vocab):
    """The JAX token-mask test's mask (tests/test_serving_spec.py) over a
    vocabulary: the legal token alternates with the emitted stream's
    length."""
    import numpy as np

    def mask(req):
        m = np.zeros((vocab,), bool)
        m[MASK_ALLOWED[len(req.output_tokens) % len(MASK_ALLOWED)]] = True
        return m
    return mask


def policy_predictor(model, kind, dev, draft=None, graphed=True):
    """The parity phase's configuration of an engine kind (dense, paged,
    spec) through the front door."""
    from paddle_tpu_torch import inference
    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    if kind == "dense":
        cfg.enable_llm_engine(num_slots=4, max_len=256, prefill_len=256,
                              device=dev)
    else:
        cfg.enable_llm_engine(paged=True, speculative=kind == "spec",
                              k=SPEC_K, num_slots=4, max_len=256,
                              block_size=BLOCK, prefill_len=CHUNK,
                              device=dev)
    return inference.create_llm_predictor(cfg, model=model,
                                          draft_model=draft)


def masked_run(pred, jobs):
    """jobs [(prompt, masked)]: 16 tokens each, the masked ones under
    the alternating token mask."""
    mask = alternating_mask(pred.engine.vocab_size)
    reqs = [pred.submit(prompt=prompt, max_tokens=16,
                        token_mask=mask if masked else None)
            for prompt, masked in jobs]
    pred.run()
    return reqs


def mask_parity(model, prompts, dev, paged_toks, paged_steps, tol):
    """A dynamic token mask through the graphed dense, paged and
    speculative engines (a DistilGPT2-shaped draft): every masked token
    is allowed, the unmasked streams equal the paged engine's (near ties
    aside), and with only masked lanes the speculative engine proposes
    no draft token."""
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining
    draft = GPTForPretraining(distilgpt2_shape(initializer_range=0.1),
                              device=dev, dtype=torch.float32,
                              seed=SEED + 7)
    want = [MASK_ALLOWED[i % 3] for i in range(16)]
    jobs = [(p, i < 2) for i, p in enumerate(prompts)]
    out = {}
    for kind in ("dense", "paged", "spec"):
        pred = policy_predictor(model, kind, dev, draft)
        reqs = masked_run(pred, jobs)
        check(all(r.output_tokens == want for r in reqs[:2]),
              f"{kind}: masked streams {[r.output_tokens for r in reqs]}")
        out[kind] = near_tie_check(f"masked {kind}", paged_toks[2:],
                                   paged_steps[2:],
                                   [r.output_tokens for r in reqs[2:]], tol)
        check(pred.engine.decode_compiles >= 1,
              f"{kind}: the masked run was not graphed")
        del pred
    pred = policy_predictor(model, "spec", dev, draft)
    reqs = masked_run(pred, [(p, True) for p in prompts[:2]])
    snap = pred.metrics.snapshot()
    check(all(r.output_tokens == want for r in reqs)
          and snap["spec_tokens_proposed"] == 0 and snap["decode_waves"] > 0,
          f"masked spec lanes proposed {snap['spec_tokens_proposed']}")
    del pred, draft
    torch.cuda.synchronize()
    return {"allowed": list(MASK_ALLOWED), "unmasked_diverged_at": out,
            "masked_spec_proposed": snap["spec_tokens_proposed"],
            "masked_spec_waves": snap["decode_waves"]}


class FaultyWave:
    """An engine's wave program that raises at its `fail_at`-th call,
    before the program runs (nothing on the card moves and the generator
    is untouched), as the JAX package's chaos hook does."""

    def __init__(self, program, fail_at):
        self._program, self._fail_at, self.calls = program, fail_at, 0

    def __call__(self, key):
        self.calls += 1
        if self.calls == self._fail_at:
            raise RuntimeError("injected wave fault")
        return self._program(key)

    def __getattr__(self, name):
        return getattr(self._program, name)


def fault_parity(model, prompts, dev, greedy_toks, sampled_toks, knobs):
    """One wave fault injected into the graphed paged engine (its first
    replay): the wave is retried once, and the greedy stream and the
    sampled one (same seed) equal the unfaulted graphed engine's."""
    out = {}
    for name, want, kw in (("greedy", greedy_toks, {}),
                           ("sampled", sampled_toks, knobs)):
        pred = policy_predictor(model, "paged", dev)
        pred.engine.wave_program = FaultyWave(pred.engine.wave_program, 3)
        reqs = [pred.submit(prompt=p, max_tokens=16, **kw) for p in prompts]
        pred.run()
        snap = pred.metrics.snapshot()
        got = [r.output_tokens for r in reqs]
        check(got == want, f"faulted {name} streams {got} != {want}")
        check(snap["wave_retries"] == 1
              and snap["faults"] == {"wave_error": 1},
              f"faulted {name}: retries {snap['wave_retries']}, faults "
              f"{snap['faults']}")
        check(pred.engine.decode_compiles == 1 and not pred.scheduler.degraded,
              f"faulted {name}: compiles {pred.engine.decode_compiles}")
        out[name] = {"streams_equal": True,
                     "wave_retries": snap["wave_retries"],
                     "replays": pred.engine.wave_program.replays}
        del pred
    return out


def drain_check(model, prompts, dev):
    """drain() mid-stream on the graphed paged engine, then the
    predictor's close() (shutdown): accepted work completes, a new submit
    is shed as rejected, health() reads "draining"."""
    pred = policy_predictor(model, "paged", dev)
    reqs = [pred.submit(prompt=p, max_tokens=16)
            for p in prompts + prompts[:2]]             # 4 slots + 2 queued
    pred.scheduler.step()
    pred.scheduler.drain()
    status = pred.health()["status"]
    try:
        pred.submit(prompt=prompts[0], max_tokens=4)
        shed = None
    except ValueError as e:
        shed = str(e)
    pred.close()
    check(status == "draining" and shed is not None
          and "draining" in shed, f"drain: health {status}, submit {shed}")
    check(all(r.finish_reason == "max_tokens" and len(r.output_tokens) == 16
              for r in reqs),
          f"drain: finish reasons {[r.finish_reason for r in reqs]}")
    snap = pred.metrics.snapshot()
    check(snap["rejected"] == 1, f"drain: {snap['rejected']} rejected")
    return {"health_status": status, "late_submit": "rejected",
            "completed": len(reqs), "rejected": snap["rejected"]}


# ---------------------------------------------------------------------------
# serve: GPT-2 small, bf16, through the front door, graphed and eager
# ---------------------------------------------------------------------------

def serve_predictor(model, graphed):
    """The serve configuration through the front door, CUDA graphs on or
    off, warmed up: a two-chunk prompt and three tokens run each
    program's eager first call and (graphed) its capture."""
    from paddle_tpu_torch import inference
    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    cfg.enable_llm_engine(paged=True, num_slots=LANES, max_len=NBLK * BLOCK,
                          block_size=BLOCK, prefill_len=CHUNK)
    pred = inference.create_llm_predictor(cfg, model=model)
    check(pred.engine.paged_kernel == "cuda",
          f"engine resolved kernel {pred.engine.paged_kernel!r}")
    pred.generate(list(range(1, 70)), max_tokens=3)
    return pred


def serve_run(pred, prompts):
    """One timed run of the 16 requests on a warmed-up predictor, with
    its K4 launches: from Python (eager), or the graphs' captured
    launches times their replays in the run, which must launch nothing
    from Python."""
    import statistics

    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingMetrics

    eng = pred.engine
    graphed = eng.wave_program.graphed
    waves0, chunks0 = eng.decode_waves_run, eng.prefill_chunks_run
    replays0 = (eng.wave_program.replays, eng.prefill_program.replays)
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the timed window's metrics leave out the warm-up request
    pred.scheduler.metrics = ServingMetrics(eng.num_slots)
    t0 = time.perf_counter()
    reqs = [pred.submit(prompt=p, max_tokens=64) for p in prompts]
    rounds = pred.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    python = {k.split(".")[1]: n - before.get(k, 0)
              for k, n in kernels.launch_counts().items()
              if k.startswith("paged_attention.")}
    waves = eng.decode_waves_run - waves0
    chunks = eng.prefill_chunks_run - chunks0
    snap = pred.metrics.snapshot()
    done = [r for r in reqs if r.finish_reason == "max_tokens"]
    check(len(done) == 16, "finish reasons "
          f"{[r.finish_reason for r in reqs]}")
    vocab = pred.engine.model.cfg.vocab_size
    check(all(len(r.output_tokens) == 64
              and all(0 <= t < vocab for t in r.output_tokens)
              for r in reqs), "every request yields 64 in-vocab tokens")
    compiles = {"decode": eng.decode_compiles,
                "prefill": eng.prefill_compiles}
    if graphed:
        check(compiles == {"decode": 1, "prefill": 1},
              f"graphed serve compiled {compiles}")
        captured = {"decode": eng.wave_program.graphs[False].launches,
                    "chunk": eng.prefill_program.graphs[False].launches}
        check(captured == {"decode": {"paged_attention.decode": LAYERS},
                           "chunk": {"paged_attention.chunk": LAYERS}},
              f"the graphs hold the K4 launches {captured}")
        check(python == {"decode": 0, "chunk": 0},
              f"a graphed run launched K4 from Python: {python}")
        replays = {"decode": eng.wave_program.replays - replays0[0],
                   "chunk": eng.prefill_program.replays - replays0[1]}
        check(replays == {"decode": waves, "chunk": chunks},
              f"replays {replays} for {waves} waves, {chunks} chunks")
        launches = {k: LAYERS * n for k, n in replays.items()}
    else:
        check(compiles == {"decode": 0, "prefill": 0},
              f"eager serve compiled {compiles}")
        launches = python
    check(launches["decode"] + launches["chunk"] > 0,
          "the serving path never launched the kernel")
    check(launches == {"decode": LAYERS * waves, "chunk": LAYERS * chunks},
          f"launches {launches} != {LAYERS} x (waves {waves}, prefill "
          f"chunks {chunks})")
    tokens = sum(len(r.output_tokens) for r in reqs)
    return {"graphed": graphed, "tokens_generated": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_p50_s": snap["ttft_p50_s"],
            "tpot_p50_s": snap["tpot_p50_s"],
            "request_mean_tpot_p50_s": statistics.median(
                r.tpot for r in reqs), "rounds": rounds,
            "host_ms_per_round": wall * 1e3 / rounds, "decode_waves": waves,
            "prefill_chunks": chunks, "compiles": compiles,
            "k4_launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


SERVE_RANGES = ("serving.decode_wave", "serving.prefill_chunk")
K4_DEVICE_NAMES = ("paged_attn_split_kernel", "paged_attn_chunk_mma",
                   "paged_attn_combine")
# kernel-name fragments -> category of a serving round's device time
SERVE_GROUPS = (("K4 (paged attention)", ("paged_attn",)),
                ("matmul", ("gemm", "gemv", "xmma", "cutlass", "sm90_",
                            "nvjet")),
                ("sort (sampling filter)", ("sort", "radix")),
                ("copies", ("memcpy", "memset")))


def profile_serve(pred, prompts, warm_rounds=8, rounds=20):
    """torch.profiler over `rounds` steady scheduling rounds of a graphed
    predictor serving `prompts` (after `warm_rounds` rounds): the
    device's busy time (the union of its kernel and copy intervals) and
    the window's idle share, host ms per round, device ms per wave and
    per chunk (each program's range as the profiler mirrors it on the
    device's timeline), device ms per round by kernel group and the top
    kernels, and the profiler's count of K4's kernels per replay. Then
    each graph replayed alone, back to back, by CUDA events. Returns
    "not measured: ..." when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, sched = pred.engine, pred.scheduler
    for p in prompts:
        pred.submit(prompt=p, max_tokens=64)
    for _ in range(warm_rounds):
        sched.step()
    torch.cuda.synchronize()
    waves0, chunks0 = eng.decode_waves_run, eng.prefill_chunks_run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            sched.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    waves = eng.decode_waves_run - waves0
    chunks = eng.prefill_chunks_run - chunks0
    pred.run()
    intervals, calls = [], dict.fromkeys(K4_DEVICE_NAMES, 0)
    spans = {k: [] for k in SERVE_RANGES}
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in SERVE_RANGES:
            # the program's range mirrored on the device's timeline (the
            # host range gets no device time: the graph's kernels are
            # not attributed to it)
            spans[e.name].append(e.time_range.elapsed_us() / 1e3)
        elif not getattr(e, "is_user_annotation", False):
            intervals.append((e.time_range.start, e.time_range.end))
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            for name in K4_DEVICE_NAMES:
                if name in e.name:
                    calls[name] += 1
    if not intervals:
        return "not measured: the profiler recorded no device time"
    busy, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            busy, reach = busy + (b - a), b
        elif b > reach:
            busy, reach = busy + (b - reach), b
    busy /= 1e3
    check(waves > 0 and chunks > 0,
          f"profiled window ran {waves} waves, {chunks} chunks")
    per_replay = {
        "split": calls["paged_attn_split_kernel"] / waves,
        "chunk_mma": calls["paged_attn_chunk_mma"] / chunks,
        "combine": calls["paged_attn_combine"] / (waves + chunks)}
    check(per_replay == {"split": LAYERS, "chunk_mma": LAYERS,
                         "combine": LAYERS},
          f"the profiler saw K4 kernels per replay {per_replay}")
    # each graph alone, back to back: its device time with no host gaps
    alone = {key: replay_alone_ms(prog.graphs[False].graph)
             for key, prog in (("wave", eng.wave_program),
                               ("chunk", eng.prefill_program))}
    groups = {name: 0.0 for name, _ in SERVE_GROUPS}
    groups["other (elementwise, norms, scatters, selection)"] = 0.0
    for key, (ms, _) in by_name.items():
        low = key.lower()
        group = next((name for name, frags in SERVE_GROUPS
                      if any(f in low for f in frags)),
                     "other (elementwise, norms, scatters, selection)")
        groups[group] += ms / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"rounds": rounds, "decode_waves": waves, "prefill_chunks": chunks,
            "profiled_wall_ms": wall, "host_ms_per_round": wall / rounds,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
            "device_ms_per_round_by_group": groups,
            "top_kernels": [{"ms_per_round": ms / rounds,
                             "calls_per_round": n / rounds,
                             "name": key[:90]} for key, (ms, n) in top],
            "device_span_ms_per_program": {
                k: (sum(v) / len(v) if v else None)
                for k, v in spans.items()},
            "k4_kernels_per_replay": per_replay,
            "replay_alone_ms": alone}


def serve_phase(dev, smi):
    import gc
    import statistics

    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small

    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                              device=dev, dtype=torch.bfloat16, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    runs, main_launches = [], None
    # graphed and eager in turns, each run on a fresh predictor (the
    # prefix cache would otherwise skip the repeated prompts' prefill)
    for graphed in (True, False, True):
        if main_launches is None:
            # the main path's run, from building the predictor to its
            # last timed request: every count is 0 before it
            zero_counts()
        pred = serve_predictor(model, graphed)
        run = serve_run(pred, prompts)
        if main_launches is None:
            main_launches = run["k4_launches"]
        runs.append(run)
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    pred = serve_predictor(model, True)
    profile = profile_serve(pred, prompts)
    check(isinstance(profile, dict), f"serve: profile {profile}")
    # the device's share of a graphed run's wall time, from each graph's
    # time replayed alone and the run's replays
    alone = profile["replay_alone_ms"]
    for run in runs:
        if run["graphed"]:
            run["device_share_by_replay_alone"] = (
                run["decode_waves"] * alone["wave"]
                + run["prefill_chunks"] * alone["chunk"]) / (
                    run["wall_s"] * 1e3)
    del pred
    gc.collect()
    torch.cuda.empty_cache()

    def median(graphed, key):
        return statistics.median(r[key] for r in runs
                                 if r["graphed"] == graphed)
    keys = ("tokens_per_s", "tpot_p50_s", "ttft_p50_s", "host_ms_per_round")
    emit("serve", model="gpt2_small", dtype="bfloat16", requests=16,
         order="graphed, eager, graphed", runs=runs,
         median_graphed={k: median(True, k) for k in keys},
         median_eager={k: median(False, k) for k in keys},
         profile=profile, nvidia_smi=smi)
    return main_launches


# ---------------------------------------------------------------------------
# serve_dense: the front door's default engine, graphed and eager
# ---------------------------------------------------------------------------

def serve_dense_predictor(model, graphed):
    """The front door's default engine (the dense ServingEngine) at the
    serve configuration with a 768-token bucket, CUDA graphs on or off,
    warmed up: two short requests run each program's eager first call
    and (graphed) its capture."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import ServingEngine
    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    cfg.enable_llm_engine(num_slots=LANES, max_len=NBLK * BLOCK,
                          prefill_len=DENSE_BUCKET)
    pred = inference.create_llm_predictor(cfg, model=model)
    check(type(pred.engine) is ServingEngine,
          f"the default front door built {type(pred.engine).__name__}")
    check(pred.engine.prefill_route == "k1",
          f"dense prefill route {pred.engine.prefill_route!r}")
    for _ in range(2):
        pred.generate(list(range(1, 70)), max_tokens=3)
    return pred


def serve_dense_run(pred, prompts):
    """One timed run of the 16 requests on a warmed-up dense predictor,
    with K1's launches: from Python (eager), or the prefill graph's
    captured launches times its replays (a graphed run launches nothing
    from Python). No other counted kernel runs on this path."""
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingMetrics

    eng = pred.engine
    graphed = eng.wave_program.graphed
    waves0, admitted0 = eng.decode_waves_run, eng.prefill_chunks_run
    replays0 = (eng.wave_program.replays, eng.prefill_program.replays)
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred.scheduler.metrics = ServingMetrics(eng.num_slots)
    t0 = time.perf_counter()
    reqs = [pred.submit(prompt=p, max_tokens=64) for p in prompts]
    rounds = pred.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    python = {k: n - before.get(k, 0)
              for k, n in kernels.launch_counts().items()
              if n != before.get(k, 0)}
    waves = eng.decode_waves_run - waves0
    admissions = eng.prefill_chunks_run - admitted0
    snap = pred.metrics.snapshot()
    check(admissions == 16 and all(r.finish_reason == "max_tokens"
                                   and len(r.output_tokens) == 64
                                   for r in reqs),
          f"dense serve: {admissions} admissions, finish reasons "
          f"{[r.finish_reason for r in reqs]}")
    vocab = eng.model.cfg.vocab_size
    check(all(0 <= t < vocab for r in reqs for t in r.output_tokens),
          "dense serve: a token outside the vocabulary")
    compiles = {"decode": eng.decode_compiles,
                "prefill": eng.prefill_compiles}
    replays = {"decode": eng.wave_program.replays - replays0[0],
               "prefill": eng.prefill_program.replays - replays0[1]}
    if graphed:
        check(compiles == {"decode": 1, "prefill": 1},
              f"graphed dense serve compiled {compiles}")
        captured = {"decode": eng.wave_program.graphs[False].launches,
                    "prefill": eng.prefill_program.graphs[False].launches}
        check(captured == {"decode": {},
                           "prefill": {"flash_attention.fwd": LAYERS}},
              f"the dense graphs hold the launches {captured}")
        check(python == {}, f"a graphed dense run launched from Python: "
                            f"{python}")
        check(replays == {"decode": waves, "prefill": admissions},
              f"replays {replays} for {waves} waves, {admissions} "
              f"admissions")
        k1 = LAYERS * replays["prefill"]
    else:
        check(compiles == {"decode": 0, "prefill": 0},
              f"eager dense serve compiled {compiles}")
        check(set(python) <= {"flash_attention.fwd"},
              f"the eager dense run launched {python}")
        k1 = python.get("flash_attention.fwd", 0)
    check(k1 == LAYERS * admissions,
          f"K1 launches {k1} != {LAYERS} x {admissions} admissions")
    tokens = sum(len(r.output_tokens) for r in reqs)
    return {"graphed": graphed, "tokens_generated": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_p50_s": snap["ttft_p50_s"],
            "tpot_p50_s": snap["tpot_p50_s"], "rounds": rounds,
            "host_ms_per_round": wall * 1e3 / rounds, "decode_waves": waves,
            "admissions": admissions, "compiles": compiles,
            "replays": replays, "k1_launches": k1,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def replay_alone_ms(graph, replays=20):
    """Device ms of one replay of a captured graph, back to back."""
    import torch
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def generate_run(model, dev, batch=8, prompt_len=64, new_tokens=64):
    """`generate(use_cache=True)` on seeded prompts: graphed twice and
    eagerly once; the graphed ids equal the eager ones. The model keeps
    its programs: the first graphed call runs position 0 eagerly,
    captures position 1 and replays the rest (it also holds the
    process's one-time CUDA set-up); the second call, of the same
    signature, replays the one captured graph at every position, so
    the model holds one graphed program with one capture. The replays
    are timed on the device as well: CUDA events around each replay of
    the second call, the first event to the last over the replays (the
    host enqueues far ahead of the card, so they run back to back)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import generate
    from paddle_tpu_torch.nlp import gpt as gpt_module
    events, plain = [], gpt_module.Program

    class Timed(plain):
        def __call__(self, key):
            if self.graphed and self.graphs.get(key) is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                outs = super().__call__(key)
                end.record()
                events.append((start, end))
                return outs
            return super().__call__(key)

    ids = torch.tensor(np.random.default_rng(SEED + 5).integers(
        0, model.cfg.vocab_size, (batch, prompt_len)), device=dev)
    model.__dict__.pop("_pt_gen_programs", None)
    walls, outs, timed = [], [], []
    gpt_module.Program = Timed      # the programs made here time replays
    try:
        for graphed in (True, True, False):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(generate(model, ids, max_new_tokens=new_tokens,
                                 use_cache=True, cuda_graph=graphed))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            timed.append(len(events))
            if len(walls) == 2:
                replay_ms = events[0][0].elapsed_time(events[-1][1]) \
                    / len(events)
    finally:
        gpt_module.Program = plain
    check(torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2]),
          "generate: graphed ids differ from eager ids")
    check(torch.equal(outs[0][:, :prompt_len], ids),
          "generate: the prompt was not kept")
    steps = prompt_len + new_tokens - 1
    # call 1: the capture's own replay (position 1) is not timed; call 2
    # replays the same graph at every position
    check(timed[:2] == [steps - 2, steps],
          f"generate: {timed[:2]} timed replays for {steps} positions")
    graphed_programs = [run.program for run in
                        gpt_module._gen_programs(model).values()
                        if run.program.graphed]
    check(len(graphed_programs) == 1 and graphed_programs[0].compiles == 1,
          f"generate: {len(graphed_programs)} graphed programs kept, "
          f"captures {[p.compiles for p in graphed_programs]}")
    return {"batch": batch, "prompt_len": prompt_len,
            "new_tokens": new_tokens, "use_cache": True, "positions": steps,
            "per_call": "call 1: position 0 eager, position 1 captured, "
                        "then one graph replay per position; call 2: "
                        "one replay of the kept graph per position",
            "graphed_programs": len(graphed_programs),
            "captures": graphed_programs[0].compiles,
            "graphed_wall_s": walls[1], "first_call_wall_s": walls[0],
            "eager_wall_s": walls[2],
            "tokens_per_s": batch * new_tokens / walls[1],
            "eager_tokens_per_s": batch * new_tokens / walls[2],
            "ms_per_position": walls[1] * 1e3 / steps,
            "eager_ms_per_position": walls[2] * 1e3 / steps,
            "timed_replays": timed[1], "replay_ms_per_position": replay_ms,
            "distinct_tokens": len(set(outs[1][:, prompt_len:]
                                       .flatten().tolist()))}


def serve_dense_phase(dev, smi):
    import statistics

    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small
    from paddle_tpu_torch.ops import flash_attention as fa

    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                              device=dev, dtype=torch.bfloat16, seed=SEED)
    # the serve phase's prompts
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    runs, main_launches = [], None
    for graphed in (True, False, True):
        if main_launches is None:
            # the main path's run, from building the predictor to its
            # last timed request: every count is 0 before it
            zero_counts()
            fa.routes["kernel"] = fa.routes["dense"] = 0
        pred = serve_dense_predictor(model, graphed)
        run = serve_dense_run(pred, prompts)
        if main_launches is None:
            main_launches = run["k1_launches"]
            check(fa.routes["dense"] == 0,
                  f"flash attention went dense {fa.routes['dense']} times")
        runs.append(run)
        if graphed:
            last = pred
        else:
            del pred
        gc.collect()
        torch.cuda.empty_cache()
    eng = last.engine
    wave, prefill = (eng.wave_program.graphs[False].graph,
                     eng.prefill_program.graphs[False].graph)
    alone = {"wave": replay_alone_ms(wave),
             "prefill": replay_alone_ms(prefill)}
    by_group = {"wave": graph_profile(wave),
                "prefill": graph_profile(prefill)}
    for run in runs:
        if run["graphed"]:
            run["device_share_by_replay_alone"] = (
                run["decode_waves"] * alone["wave"]
                + run["admissions"] * alone["prefill"]) / (
                    run["wall_s"] * 1e3)
    del last, eng, wave, prefill
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_run(model, dev)

    def median(graphed, key):
        return statistics.median(r[key] for r in runs
                                 if r["graphed"] == graphed)
    keys = ("tokens_per_s", "tpot_p50_s", "ttft_p50_s", "host_ms_per_round")
    emit("serve_dense", model="gpt2_small", dtype="bfloat16", requests=16,
         prefill_len=DENSE_BUCKET, route="k1",
         order="graphed, eager, graphed", runs=runs,
         median_graphed={k: median(True, k) for k in keys},
         median_eager={k: median(False, k) for k in keys},
         replay_alone_ms=alone, device_ms_per_replay=by_group,
         generate=gen, nvidia_smi=smi)
    return main_launches


# ---------------------------------------------------------------------------
# serve_spec: speculative decoding through the front door
# ---------------------------------------------------------------------------

SERVE_OTHER = "other (elementwise, norms, scatters, selection)"


def spec_programs(eng):
    return {"draft": eng.draft_program, "verify": eng.wave_program,
            "prefill": eng.prefill_program}


def spec_predictor(model, draft, graphed):
    """The serve configuration with speculative=True, k = SPEC_K, through
    the front door, CUDA graphs on or off, warmed up: a two-chunk prompt
    and 16 tokens (three waves or more) run each program's eager first
    call and (graphed) its capture."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import SpeculativePagedEngine
    cfg = inference.Config()
    cfg.switch_ir_optim(graphed)
    cfg.enable_llm_engine(speculative=True, k=SPEC_K, num_slots=LANES,
                          max_len=NBLK * BLOCK, block_size=BLOCK,
                          prefill_len=CHUNK)
    pred = inference.create_llm_predictor(cfg, model=model,
                                          draft_model=draft)
    check(isinstance(pred.engine, SpeculativePagedEngine)
          and pred.engine.paged_kernel == "cuda"
          and pred.engine.spec_k == SPEC_K,
          f"speculative front door built {pred.engine.describe()}")
    pred.generate(list(range(1, 70)), max_tokens=16)
    return pred


def spec_run(pred, prompts):
    """One timed run of the 16 requests on a warmed-up speculative
    predictor: the serve run's metrics, the acceptance, tokens per lane
    per wave, and K4's launches per program — the graphs' captured
    launches times their replays (a graphed run launches nothing from
    Python), or the eager run's Python counts, which must come to the
    same per-call numbers: (k + 1) x draft layers decode-form launches a
    draft wave, 12 chunk-form a verify, 12 + draft layers a prefill
    chunk."""
    import statistics

    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingMetrics

    eng = pred.engine
    dl = eng.draft_model.cfg.num_layers
    progs = spec_programs(eng)
    graphed = eng.wave_program.graphed
    waves0, chunks0 = eng.decode_waves_run, eng.prefill_chunks_run
    replays0 = {k: p.replays for k, p in progs.items()}
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred.scheduler.metrics = ServingMetrics(eng.num_slots)
    t0 = time.perf_counter()
    reqs = [pred.submit(prompt=p, max_tokens=64) for p in prompts]
    rounds = pred.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    python = {k.split(".")[1]: n - before.get(k, 0)
              for k, n in kernels.launch_counts().items()
              if k.startswith("paged_attention.")}
    waves = eng.decode_waves_run - waves0
    chunks = eng.prefill_chunks_run - chunks0
    snap = pred.metrics.snapshot()
    check(all(r.finish_reason == "max_tokens" for r in reqs),
          f"spec serve: finish reasons {[r.finish_reason for r in reqs]}")
    vocab = eng.model.cfg.vocab_size
    check(all(len(r.output_tokens) == 64
              and all(0 <= t < vocab for t in r.output_tokens)
              for r in reqs), "every request yields 64 in-vocab tokens")
    per_call = {"draft": {"paged_attention.decode": dl * (SPEC_K + 1)},
                "verify": {"paged_attention.chunk": LAYERS},
                "prefill": {"paged_attention.chunk": LAYERS + dl}}
    calls = {"draft": waves, "verify": waves, "prefill": chunks}
    compiles = {k: p.compiles for k, p in progs.items()}
    if graphed:
        check(compiles == {"draft": 1, "verify": 1, "prefill": 1},
              f"graphed spec serve compiled {compiles}")
        captured = {k: p.graphs[False].launches for k, p in progs.items()}
        check(captured == per_call,
              f"the spec graphs hold the K4 launches {captured}")
        check(python == {"decode": 0, "chunk": 0},
              f"a graphed spec run launched K4 from Python: {python}")
        replays = {k: p.replays - replays0[k] for k, p in progs.items()}
        check(replays == calls, f"replays {replays} for {waves} waves, "
                                f"{chunks} chunks")
    else:
        check(compiles == {"draft": 0, "verify": 0, "prefill": 0},
              f"eager spec serve compiled {compiles}")
    launches = {k: sum(per_call[k].values()) * n for k, n in calls.items()}
    by_form = {"decode": launches["draft"],
               "chunk": launches["verify"] + launches["prefill"]}
    if not graphed:
        check(python == by_form, f"eager spec launches {python} != "
                                 f"{by_form}")
    check(launches["verify"] > 0, "the verify never launched K4")
    tokens = sum(len(r.output_tokens) for r in reqs)
    lane_waves = snap["slot_occupancy"] * waves * eng.num_slots
    return {"graphed": graphed, "draft_layers": dl, "spec_k": SPEC_K,
            "tokens_generated": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_p50_s": snap["ttft_p50_s"],
            # a wave's tokens stream at one time stamp: the gaps inside a
            # batch are 0, so the p50 of the gaps can be 0; each request's
            # mean gap (`Request.tpot`) beside it
            "tpot_p50_s": snap["tpot_p50_s"],
            "request_mean_tpot_p50_s": statistics.median(
                r.tpot for r in reqs),
            "acceptance_rate": snap["spec_acceptance_rate"],
            "accepted_per_wave": snap["spec_accepted_per_wave"],
            "tokens_per_lane_wave": (tokens - len(reqs)) / lane_waves,
            "rounds": rounds, "host_ms_per_round": wall * 1e3 / rounds,
            "decode_waves": waves, "prefill_chunks": chunks,
            "compiles": compiles, "k4_launches_by_program": launches,
            "k4_launches": by_form,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def serve_spec_phase(dev, smi):
    import statistics

    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small

    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                              device=dev, dtype=torch.bfloat16, seed=SEED)
    draft = GPTForPretraining(distilgpt2_shape(), device=dev,
                              dtype=torch.bfloat16, seed=SEED + 7)
    # the serve phase's prompts
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    runs, main_launches, last = [], None, None
    for graphed in (True, False, True):
        if main_launches is None:
            # the main path's run, from building the predictor to its
            # last timed request: every count is 0 before it
            zero_counts()
        pred = spec_predictor(model, draft, graphed)
        run = spec_run(pred, prompts)
        if main_launches is None:
            main_launches = run["k4_launches_by_program"]
        runs.append(run)
        if graphed:
            last = pred
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    # each program's graph replayed alone, back to back, and profiled
    graphs = {k: p.graphs[False].graph
              for k, p in spec_programs(last.engine).items()}
    alone = {k: replay_alone_ms(g) for k, g in graphs.items()}
    by_group = {k: graph_profile(g, categories=SERVE_GROUPS,
                                 other=SERVE_OTHER)
                for k, g in graphs.items()}
    for run in runs:
        if run["graphed"]:
            run["device_share_by_replay_alone"] = (
                run["decode_waves"] * (alone["draft"] + alone["verify"])
                + run["prefill_chunks"] * alone["prefill"]) / (
                    run["wall_s"] * 1e3)
    del last, graphs
    gc.collect()
    torch.cuda.empty_cache()
    # the target as its own draft (acceptance near 1: the bonus token),
    # and the paged engine on the same traffic, beside it
    pred = spec_predictor(model, model, True)
    self_draft = spec_run(pred, prompts)
    del pred
    pred = serve_predictor(model, True)
    paged = serve_run(pred, prompts)
    del pred
    gc.collect()
    torch.cuda.empty_cache()

    def median(graphed, key):
        return statistics.median(r[key] for r in runs
                                 if r["graphed"] == graphed)
    keys = ("tokens_per_s", "tpot_p50_s", "request_mean_tpot_p50_s",
            "ttft_p50_s", "host_ms_per_round", "acceptance_rate",
            "tokens_per_lane_wave")
    emit("serve_spec", model="gpt2_small", dtype="bfloat16", requests=16,
         draft=f"DistilGPT2 shape ({DRAFT_LAYERS} layers, 768 wide, 12 "
               "heads, vocab 50304), random weights",
         spec_k=SPEC_K, order="graphed, eager, graphed", runs=runs,
         median_graphed={k: median(True, k) for k in keys},
         median_eager={k: median(False, k) for k in keys},
         replay_alone_ms=alone, device_ms_per_replay=by_group,
         self_draft=self_draft,
         paged_beside={k: paged[k] for k in (
             "tokens_per_s", "tpot_p50_s", "ttft_p50_s",
             "host_ms_per_round", "decode_waves", "prefill_chunks")},
         nvidia_smi=smi)
    return main_launches


# ---------------------------------------------------------------------------
# serve_disagg: a prefill role and a decode role joined by the KV handoff
# ---------------------------------------------------------------------------

def disagg_run(scheds, prompts):
    """One timed run of the 16 requests through warmed-up role
    schedulers and the handoff loop: tokens/s, TTFT (the prefill hop's
    first token), TPOT (the decode hop's gaps, the seam gap from the
    first token to the decode hop's first, and each request's mean gap),
    the handoff's bytes and host ms per request (export: gather, copy to
    the host and digest; import: digest and copy into the pools; the
    digests' share apart), and K4's launches per role: each graph's
    captured launches times its replays (a graphed run launches nothing
    from Python)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import ServingMetrics
    from paddle_tpu_torch.serving.paged import engine as paged_engine

    prefill, decode = scheds
    pe, de = prefill.engine, decode.engine
    ms = {"export": [], "import": [], "export_digest": [],
          "import_digest": []}
    nbytes, inside = [], []
    export, import_handoff = pe.export_slot_kv, de.import_handoff
    digest = paged_engine._handoff_digest

    def timed(name, fn):
        def call(*a, **kw):
            inside.append(name)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms[name].append((time.perf_counter() - t) * 1e3)
                inside.pop()
        return call

    def timed_digest(*a):
        t = time.perf_counter()
        out = digest(*a)
        ms[inside[-1] + "_digest"].append((time.perf_counter() - t) * 1e3)
        return out

    def export_bytes(slot):
        payload = export(slot)
        nbytes.append(payload["nbytes"])
        return payload
    pe.export_slot_kv = timed("export", export_bytes)
    de.import_handoff = timed("import", import_handoff)
    paged_engine._handoff_digest = timed_digest
    progs = {"prefill_role": pe.prefill_program,
             "decode_role": de.wave_program}
    replays0 = {k: p.replays for k, p in progs.items()}
    before = kernels.launch_counts()
    for sched in scheds:
        sched.metrics = ServingMetrics(sched.engine.num_slots)
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        pairs = handoff_loop(prefill, decode, [(p, 64) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        paged_engine._handoff_digest = digest
        pe.export_slot_kv, de.import_handoff = export, import_handoff
    python = {k: n - before.get(k, 0)
              for k, n in kernels.launch_counts().items()
              if k.startswith("paged_attention.")}
    check(all(hop is not None and hop.finish_reason == "max_tokens"
              and len(hop_stream(a, hop)) == 64 for a, hop in pairs),
          "disagg: finish reasons "
          f"{[hop and hop.finish_reason for _, hop in pairs]}")
    check(all(n == 0 for n in python.values()),
          f"a graphed disagg run launched K4 from Python: {python}")
    captured = {k: p.graphs[False].launches for k, p in progs.items()}
    check(captured == {"prefill_role": {"paged_attention.chunk": LAYERS},
                       "decode_role": {"paged_attention.decode": LAYERS}},
          f"the role graphs hold the K4 launches {captured}")
    replays = {k: p.replays - replays0[k] for k, p in progs.items()}
    check(pe.decode_waves_run == 0 and de.prefill_chunks_run == 0
          and replays["prefill_role"] > 0 and replays["decode_role"] > 0,
          f"roles ran {replays}, prefill-role waves {pe.decode_waves_run},"
          f" decode-role chunks {de.prefill_chunks_run}")
    tokens = sum(len(hop_stream(a, b)) for a, b in pairs)
    seam = [b.first_token_time - a.first_token_time for a, b in pairs]
    mean_gap = [(b.last_token_time - a.first_token_time)
                / (len(hop_stream(a, b)) - 1) for a, b in pairs]
    snap = decode.metrics.snapshot()
    return {"tokens_generated": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median([a.ttft for a, _ in pairs])),
            "tpot_p50_s_decode_hop": snap["tpot_p50_s"],
            "seam_gap_p50_s": float(np.median(seam)),
            "request_mean_tpot_p50_s": float(np.median(mean_gap)),
            "handoff_bytes_per_request": float(np.mean(nbytes)),
            "handoff_bytes_total": int(sum(nbytes)),
            "handoff_ms_per_request_median": {
                k: float(np.median(v)) for k, v in ms.items()},
            "handoff_ms_per_request_mean": {
                k: float(np.mean(v)) for k, v in ms.items()},
            "digest_gb_per_s": 2 * sum(nbytes) / 1e6 / (
                sum(ms["export_digest"]) + sum(ms["import_digest"])),
            "prefill_chunks": replays["prefill_role"],
            "decode_waves": replays["decode_role"],
            "k4_launches": {"prefill_role_chunk":
                            LAYERS * replays["prefill_role"],
                            "decode_role_decode":
                            LAYERS * replays["decode_role"]},
            "phase_seconds": {"prefill_role":
                              prefill.metrics.snapshot()["phase_seconds"],
                              "decode_role": snap["phase_seconds"]}}


def serve_disagg_phase(dev, smi):
    import numpy as np
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt2_small

    model = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                              device=dev, dtype=torch.bfloat16, seed=SEED)
    # the serve phase's prompts
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    runs, main_launches, counted = [], None, None
    for _ in range(2):
        if main_launches is None:
            # the main path's run, from building the role engines to its
            # last request: every count is 0 before it
            zero_counts()
        scheds = role_schedulers(model, LANES, NBLK * BLOCK, CHUNK)
        # warm-up: a two-chunk prompt and three tokens run each role's
        # program eagerly once, then capture it
        handoff_loop(*scheds, [(list(range(1, 70)), 3)])
        for sched, want in zip(scheds, ({"decode": 0, "prefill": 1},
                                        {"decode": 1, "prefill": 0})):
            got = {"decode": sched.engine.decode_compiles,
                   "prefill": sched.engine.prefill_compiles}
            check(got == want, f"the {sched.role} role compiled {got}")
        runs.append(disagg_run(scheds, prompts))
        if main_launches is None:
            counted = {k: n for k, n in kernels.launch_counts().items()
                       if k.startswith("paged_attention.")}
            check(counted.get("paged_attention.chunk", 0) > 0
                  and counted.get("paged_attention.decode", 0) > 0,
                  f"the disagg path counted K4 launches {counted}")
            main_launches = runs[0]["k4_launches"]
        del scheds
        gc.collect()
        torch.cuda.empty_cache()
    pred = serve_predictor(model, True)
    unified = serve_run(pred, prompts)
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_disagg", model="gpt2_small", dtype="bfloat16", requests=16,
         slots_per_role=LANES, order="disagg, disagg, unified", runs=runs,
         counted_launches=counted,
         unified_beside={k: unified[k] for k in (
             "tokens_per_s", "ttft_p50_s", "tpot_p50_s",
             "request_mean_tpot_p50_s", "host_ms_per_round", "wall_s",
             "decode_waves", "prefill_chunks")},
         nvidia_smi=smi)
    return main_launches


# ---------------------------------------------------------------------------
# serve_llama: the serve workload on the serving LLaMA, three engines
# ---------------------------------------------------------------------------

# the spec engine's LLaMA draft: the target's widths at 2 layers
LLAMA_DRAFT_LAYERS = 2
# kernel-name fragments of a LLaMA wave's own elementwise work, beside
# the serve groups: RMSNorm's rsqrt and mean, SiLU, RoPE's stack (their
# multiplies, adds and casts share generic kernels, counted in "other";
# `llama_op_ms` times each op whole)
LLAMA_SERVE_GROUPS = SERVE_GROUPS + (
    ("RMSNorm (rsqrt, mean)", ("rsqrt", "meanops")),
    ("SiLU", ("silu",)),
    ("RoPE (stack)", ("catarraybatchedcopy",)))


def kv_bytes_per_token(eng):
    """Bytes of K/V a token holds in a paged engine's pools (all layers;
    the draft's too on a speculative engine)."""
    pools = eng._pools()
    total = sum(t.numel() * t.element_size() for pair in pools
                for t in pair)
    return total / (eng.block_pool.num_blocks * eng.block_size)


def llama_op_ms(model, lanes, rows):
    """Device ms of RMSNorm, RoPE (q and k) and SiLU·mul as one program
    runs them over `lanes` x `rows` tokens (a decode wave: 8 x 1; a
    prefill chunk: 1 x 64): each op captured alone in a CUDA graph at the
    program's shapes and dtype, times its calls a program (2 norms a
    layer and the final one; RoPE and SiLU·mul once a layer)."""
    import torch
    from torch.nn import functional as F
    from paddle_tpu_torch.nlp.llama import apply_rope_positions
    cfg, dev = model.cfg, model.device
    dtype = next(iter(model.parameters())).dtype
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hd = cfg.hidden_size // cfg.num_heads

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    x = rnd(lanes, rows, cfg.hidden_size)
    # q and k as the attention rotates them: [B, H, C, D] views
    q = rnd(lanes, rows, cfg.num_heads, hd).transpose(1, 2)
    k = rnd(lanes, rows, cfg.num_kv_heads, hd).transpose(1, 2)
    g, u = rnd(lanes, rows, cfg.intermediate_size), rnd(
        lanes, rows, cfg.intermediate_size)
    pos = torch.randint(0, 1024, (lanes, rows), generator=gen, device=dev)
    norm, rope, L = model.model.norm, model.model.rope, cfg.num_layers
    return {"rms_norm": graph_ms(lambda: norm.infer(x), 2 * L + 1)
            * (2 * L + 1),
            "rope": graph_ms(lambda: (
                apply_rope_positions(q, rope.cos, rope.sin, pos),
                apply_rope_positions(k, rope.cos, rope.sin, pos)), L) * L,
            "silu_mul": graph_ms(lambda: F.silu(g) * u, L) * L}


def serve_llama_phase(dev, smi):
    """The serve workload (16 requests of 128-768 seeded prompt tokens,
    64 greedy tokens each, 8 slots, horizon 1024, 16-token blocks,
    64-token chunks) on the serving LLaMA in bf16 through the front door:
    paged graphed / eager / graphed, dense graphed (a 768 bucket: every
    prefill is K1 at [1, 768, 12, 64]) and speculative k = 4 graphed with
    a 2-layer LLaMA draft, each path driven with the counts set to 0
    just before it; the GPT-2 small paged engine beside them. Each graph
    replayed alone; the paged wave profiled by kernel group with
    RMSNorm, RoPE and SiLU·mul timed alone; the KV bytes a token."""
    import statistics

    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import (GPTForPretraining, LlamaForCausalLM,
                                      gpt2_small)

    model = LlamaForCausalLM(llama_config(), device=dev,
                             dtype=torch.bfloat16, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            int(rng.integers(128, 769))).tolist()
               for _ in range(16)]
    runs, launches, last = [], {}, None
    for graphed in (True, False, True):
        if not runs:
            zero_counts()
        pred = serve_predictor(model, graphed)
        run = serve_run(pred, prompts)
        if not runs:
            launches["paged"] = run["k4_launches"]
        runs.append(run)
        if graphed:
            last = pred
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    eng = last.engine
    paged_graphs = {"wave": eng.wave_program.graphs[False].graph,
                    "chunk": eng.prefill_program.graphs[False].graph}
    paged_alone = {k: replay_alone_ms(g) for k, g in paged_graphs.items()}
    wave_profile = graph_profile(paged_graphs["wave"],
                                 categories=LLAMA_SERVE_GROUPS,
                                 other=SERVE_OTHER)
    check(isinstance(wave_profile, dict),
          f"serve_llama: wave profile {wave_profile}")
    named = {"wave": llama_op_ms(model, LANES, 1),
             "chunk": llama_op_ms(model, 1, CHUNK)}
    kv = {"llama": kv_bytes_per_token(eng)}
    del last, eng, paged_graphs
    gc.collect()
    torch.cuda.empty_cache()

    zero_counts()
    pred = serve_dense_predictor(model, True)
    dense = serve_dense_run(pred, prompts)
    launches["dense_k1"] = dense["k1_launches"]
    deng = pred.engine
    dense["replay_alone_ms"] = {
        "wave": replay_alone_ms(deng.wave_program.graphs[False].graph),
        "prefill": replay_alone_ms(deng.prefill_program.graphs[False].graph)}
    del pred, deng
    gc.collect()
    torch.cuda.empty_cache()

    draft = LlamaForCausalLM(llama_config(num_layers=LLAMA_DRAFT_LAYERS),
                             device=dev, dtype=torch.bfloat16,
                             seed=SEED + 7)
    zero_counts()
    pred = spec_predictor(model, draft, True)
    spec = spec_run(pred, prompts)
    launches["spec"] = spec["k4_launches_by_program"]
    spec["replay_alone_ms"] = {
        k: replay_alone_ms(p.graphs[False].graph)
        for k, p in spec_programs(pred.engine).items()}
    del pred, draft, model
    gc.collect()
    torch.cuda.empty_cache()

    gpt = GPTForPretraining(gpt2_small(dropout=0.0, attn_dropout=0.0),
                            device=dev, dtype=torch.bfloat16, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    gpt_prompts = [rng.integers(0, gpt.cfg.vocab_size,
                                int(rng.integers(128, 769))).tolist()
                   for _ in range(16)]
    pred = serve_predictor(gpt, True)
    gpt_paged = serve_run(pred, gpt_prompts)
    kv["gpt2_small"] = kv_bytes_per_token(pred.engine)
    del pred, gpt
    gc.collect()
    torch.cuda.empty_cache()

    keys = ("tokens_per_s", "tpot_p50_s", "ttft_p50_s", "host_ms_per_round")
    median = {k: statistics.median(r[k] for r in runs if r["graphed"])
              for k in keys}
    emit("serve_llama", model="llama (vocab 32000, 768 wide, 12 layers, "
                              "12 heads over 4 KV heads, SwiGLU 2048)",
         dtype="bfloat16", requests=16, order="paged graphed, eager, "
         "graphed; dense graphed; spec graphed; GPT-2 small paged graphed",
         paged_runs=runs, paged_median_graphed=median,
         paged_replay_alone_ms=paged_alone, paged_wave_profile=wave_profile,
         llama_op_device_ms=named,
         dense={k: dense[k] for k in (
             "tokens_per_s", "ttft_p50_s", "tpot_p50_s", "host_ms_per_round",
             "decode_waves", "admissions", "replays", "k1_launches",
             "replay_alone_ms", "max_memory_allocated")},
         spec={k: spec[k] for k in (
             "draft_layers", "tokens_per_s", "ttft_p50_s", "tpot_p50_s",
             "request_mean_tpot_p50_s", "acceptance_rate",
             "tokens_per_lane_wave", "host_ms_per_round", "decode_waves",
             "prefill_chunks", "k4_launches_by_program", "k4_launches",
             "replay_alone_ms", "max_memory_allocated")},
         gpt2_small_paged_beside={k: gpt_paged[k] for k in (
             "tokens_per_s", "tpot_p50_s", "ttft_p50_s", "host_ms_per_round",
             "decode_waves", "prefill_chunks", "k4_launches")},
         kv_bytes_per_token=kv,
         kv_bytes_ratio_llama_over_gpt=kv["llama"] / kv["gpt2_small"],
         launches=launches, nvidia_smi=smi)
    return launches


# ---------------------------------------------------------------------------
# flash: K1-K3 against their plain versions at the training path's shapes
# ---------------------------------------------------------------------------

def flash_inputs(b, sq, sk, dtype, gen, dev, bshd=True, qkv=True,
                 heads=HEADS):
    """q, k, v as the training path gives them (bshd: strided views of
    one [B, S, 3, H, D] projection when sq == sk and `qkv`; separate
    projections otherwise, as nn.MultiHeadAttention's) and an upstream
    grad dO in q's layout."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)
    if bshd and qkv and sq == sk:
        a = rnd(b, sq, 3, heads, HEAD_DIM)
        q, k, v = a[:, :, 0], a[:, :, 1], a[:, :, 2]
    elif bshd:
        q = rnd(b, sq, heads, HEAD_DIM)
        k, v = rnd(b, sk, heads, HEAD_DIM), rnd(b, sk, heads, HEAD_DIM)
    else:
        q = rnd(b, heads, sq, HEAD_DIM)
        k, v = rnd(b, heads, sk, HEAD_DIM), rnd(b, heads, sk, HEAD_DIM)
    return q, k, v, rnd(*q.shape)


def flash_pairs(b, h, sq, sk, causal, window):
    """(query, key) pairs the band keeps over the whole call."""
    if not causal:
        return b * h * sq * sk
    off, n = sk - sq, 0
    for r in range(sq):
        qa = off + r
        lo = 0 if window is None else max(0, qa - window + 1)
        n += max(0, min(qa, sk - 1) - lo + 1)
    return b * h * n


def flash_flops(kind, q, k, causal, window, bshd):
    """Operations of one K1 / K2 / K3 call: 2 * D multiply-adds per
    attended pair per product (QK^T and PV for K1; QK^T, dO.V^T, P^T.dO
    and dS^T.Q for K2; QK^T, dO.V^T and dS.K for K3)."""
    if bshd:
        b, sq, h, d = q.shape
        sk = k.shape[1]
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
    products = {"fwd": 2, "dkv": 4, "dq": 3}[kind]
    return products * 2 * d * flash_pairs(b, h, sq, sk, causal, window)


def flash_bound(kind, q, k, causal, window, bshd, peaks):
    """Least time of one K1 / K2 / K3 / dd call: bytes (each input read
    once, each output written once: q, k, v, out and lse for K1; q, k,
    v, dO, lse, dd, dK and dV for K2; q, k, v, dO, lse, dd and dQ for
    K3; dO, out and dd for the dd kernel) over the HBM rate, against
    `flash_flops` over the peak for the input type (the dd kernel's
    2 * D operations a row over the f32 peak: it runs on the CUDA
    cores). Returns (ms, "bytes" | "operations")."""
    if bshd:
        b, sq, h, d = q.shape
        sk = k.shape[1]
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
    elt = q.element_size()
    qb, kb, stat = b * sq * h * d * elt, b * sk * h * d * elt, b * h * sq * 4
    nbytes = {"fwd": 2 * qb + 2 * kb + stat,
              "dkv": 2 * qb + 4 * kb + 2 * stat,
              "dq": 3 * qb + 2 * kb + 2 * stat,
              "dd": 2 * qb + stat}[kind]
    if kind == "dd":
        flops, rate = 2 * b * sq * h * d, peaks["f32"]
    else:
        flops = flash_flops(kind, q, k, causal, window, bshd)
        rate = peaks["bf16" if elt == 2 else "f32"]
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_report(kernel, smem_fn):
    """A flash kernel's registers, spill bytes and static shared memory
    as ptxas reported them, and the dynamic shared memory it launches
    with (from the library's entry point `smem_fn`)."""
    import re
    from paddle_tpu_torch import kernels
    lines, keep = [], False
    for ln in kernels.build_info("flash_attention")["ptxas"].splitlines():
        if "Compiling entry function" in ln:
            keep = kernel in ln
        elif keep:
            lines.append(ln.strip())
    text = " ".join(lines)
    regs = re.search(r"Used (\d+) registers", text)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(spills) if spills else None,
            "ptxas": lines,
            "dynamic_smem_bytes":
                getattr(kernels.load("flash_attention"), smem_fn)()}


def flash_run(fa, impl, q, k, v, do, causal, window, bshd):
    """Forward, then dd, dK/dV and dQ from the forward's own out and
    lse."""
    fwd, dkv, dq = fa._IMPLS[impl]
    scale = 1.0 / HEAD_DIM ** 0.5
    out, lse = fwd(q, k, v, causal, scale, bshd, window)
    dd = fa.row_dot(do, out, bshd, impl)
    dk, dv = dkv(q, k, v, do, lse, dd, causal, scale, bshd, window)
    dqv = dq(q, k, v, do, lse, dd, causal, scale, bshd, window)
    return {"out": out, "lse": lse, "dk": dk, "dv": dv, "dq": dqv}


def dd_held(fa, name, do, out, bshd):
    """The dd kernel against `plain_row_dot` on the same dO and O: the
    same non-finite entries, the rest within 1e-4 x max(1, |ref|) for
    f32 and bf16 inputs alike (the sum is f32 in both). Returns (the
    kernel's dd, the max abs error over the finite entries)."""
    import torch
    got = fa.cuda_row_dot(do, out, bshd)
    ref = fa.plain_row_dot(do, out, bshd)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == torch.float32
          and got.is_contiguous(), f"dd {name}: {got.dtype}"
          f"{tuple(got.shape)} against {tuple(ref.shape)}")
    ok = torch.isfinite(ref)
    check(bool((torch.isfinite(got) == ok).all()),
          f"dd {name}: non-finite entries differ from plain's")
    err = torch.where(ok, (got - ref).abs(), 0.0)
    check(bool((err <= 1e-4 * torch.clamp(ref.abs(), min=1.0))[ok].all()),
          f"dd {name}: max abs err {err.max().item()} over tolerance 1e-4")
    return got, err.max().item()


def flash_phase(dev, peaks):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 3)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    # (name, batch, sq, sk, causal, window, bshd, heads)
    cases = [("main", TRAIN_B, TRAIN_S, TRAIN_S, True, None, True, HEADS),
             ("main bhsd", TRAIN_B, TRAIN_S, TRAIN_S, True, None, False,
              HEADS),
             ("window256", 2, TRAIN_S, TRAIN_S, True, 256, True, HEADS),
             ("sq<sk", 2, 512, TRAIN_S, False, None, False, HEADS),
             ("sq<sk causal window", 2, 256, 640, True, 64, False, HEADS),
             ("single tile", 2, 128, 128, True, None, True, HEADS),
             # a window that is no multiple of a tile
             ("window100", 2, TRAIN_S, TRAIN_S, True, 100, True, HEADS),
             # k blocks 0-2 see no query: K2 writes zeros there
             ("sq<sk causal window64", 2, 128, 640, True, 64, False, HEADS),
             # q rows 0-127 see no key
             ("sq>sk causal", 2, 256, 128, True, None, False, HEADS),
             # nn.Transformer's attention (Transformer-base): separate
             # q/k/v projections, BSHD, non-causal, 8 heads; the encoder's
             # self-attention and the decoder's cross-attention
             ("transformer self", TF_B, TF_SRC, TF_SRC, False, None, True,
              TF_HEADS),
             ("transformer cross", TF_B, TF_TGT, TF_SRC, False, None, True,
              TF_HEADS),
             # BERT-base's self-attention: separate q/k/v projections,
             # BSHD, non-causal, 12 heads, at the train batch
             ("bert", BERT_B, BERT_S, BERT_S, False, None, True, HEADS)]
    which = {"out": "fwd", "lse": "fwd", "dk": "dkv", "dv": "dkv",
             "dq": "dq"}
    worst = {}
    for name, b, sq, sk, causal, window, bshd, heads in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(b, sq, sk, dtype, gen, dev, bshd,
                                       qkv=heads == HEADS and name != "bert",
                                       heads=heads)
            got = flash_run(fa, "cuda", q, k, v, do, causal, window, bshd)
            ref = flash_run(fa, "plain", q, k, v, do, causal, window, bshd)
            torch.cuda.synchronize()
            for key, g in got.items():
                r = ref[key].float()
                check(torch.isfinite(g).all().item(),
                      f"flash {name} {dtype} {key}: non-finite values")
                err = (g.float() - r).abs()
                lim = tol[dtype] * torch.clamp(r.abs(), min=1.0)
                check(bool((err <= lim).all()),
                      f"flash {name} {dtype} {key}: max abs err "
                      f"{err.max().item()} over tolerance {tol[dtype]}")
                slot = (which[key], str(dtype).split(".")[-1])
                worst[slot] = max(worst.get(slot, 0.0), err.max().item())
            _, err = dd_held(fa, f"{name} {dtype}", do, got["out"], bshd)
            slot = ("dd", str(dtype).split(".")[-1])
            worst[slot] = max(worst.get(slot, 0.0), err)
            # keys no query attends get exactly 0 in dK and dV; q rows
            # that attend no key exactly 0 in out and dQ (BHSD cases)
            unseen = sk - sq - (window or sk) + 1
            if causal and not bshd and unseen > 0:
                check(bool((got["dk"][:, :, :unseen] == 0).all())
                      and bool((got["dv"][:, :, :unseen] == 0).all()),
                      f"flash {name} {dtype}: dK/dV of keys no query "
                      f"attends are not exactly 0")
            if causal and not bshd and sq > sk:
                check(bool((got["out"][:, :, :sq - sk] == 0).all())
                      and bool((got["dq"][:, :, :sq - sk] == 0).all()),
                      f"flash {name} {dtype}: fully masked rows are not "
                      f"exactly 0")
    # an attended NaN reaches the rows that attend it, and only those
    q, k, v, do = flash_inputs(2, 512, 512, torch.bfloat16, gen, dev)
    k = k.clone()
    k[0, 300, 0, 0] = float("nan")
    out, lse = fa.cuda_fwd(q, k, v, True, 0.125, True)
    check(not torch.isfinite(out[0, 300:, 0]).any().item(),
          "flash fwd: attended NaN did not propagate")
    check(torch.isfinite(out[0, :300, 0]).all().item()
          and torch.isfinite(out[:, :, 1:]).all().item()
          and torch.isfinite(out[1]).all().item(),
          "flash fwd: NaN leaked to rows or heads that do not attend it")
    # ... through the dd kernel to those rows' dd only ...
    dd, _ = dd_held(fa, "attended NaN", do, out, True)
    check(not torch.isfinite(dd[0, 0, 300:]).any().item()
          and torch.isfinite(dd[0, 0, :300]).all().item()
          and torch.isfinite(dd[0, 1:]).all().item()
          and torch.isfinite(dd[1]).all().item(),
          "flash dd: NaN rows of O did not stay in their rows of dd")
    # ... through K2 to the dK/dV entries plain's schedule of 64-row q
    # tiles over 128-key blocks gives, in that head and batch only
    dk, dv = fa.cuda_bwd_dkv(q, k, v, do, lse, dd, True, 0.125, True)
    rk, rv = fa.plain_bwd_dkv(q, k, v, do, lse, dd, True, 0.125, True,
                              bq=64, bk=128)
    for name, g, r in (("dk", dk, rk), ("dv", dv, rv)):
        check(bool((torch.isfinite(g) == torch.isfinite(r)).all())
              and not torch.isfinite(g[0, 300, 0]).all().item()
              and torch.isfinite(g[1]).all().item()
              and torch.isfinite(g[:, :, 1:]).all().item(),
              f"flash dkv: a NaN in key 300 gives non-finite {name} "
              f"entries other than plain's, or in another head/batch")
    # ... and through K3 (dS = 0 times the NaN key) to the dQ entries of
    # plain's schedule of 128-row q blocks over 64-key tiles: rows
    # 256-299 too, in dimension 0, in that head and batch only
    dq = fa.cuda_bwd_dq(q, k, v, do, lse, dd, True, 0.125, True)
    rq = fa.plain_bwd_dq(q, k, v, do, lse, dd, True, 0.125, True, bq=128,
                         bk=64)
    check(bool((torch.isfinite(dq) == torch.isfinite(rq)).all())
          and not torch.isfinite(dq[0, 256:, 0, 0]).any().item()
          and torch.isfinite(dq[0, :256, 0]).all().item()
          and torch.isfinite(dq[1]).all().item()
          and torch.isfinite(dq[:, :, 1:]).all().item(),
          "flash dq: a NaN in key 300 gives non-finite dQ entries other "
          "than plain's, or in another head/batch")
    # a NaN in one element of dO stays in its row of dd
    bad = do.clone()
    bad[1, 5, 3, 7] = float("nan")
    dd, _ = dd_held(fa, "NaN in dO", bad, out, True)
    check(not torch.isfinite(dd[1, 3, 5]).item()
          and int((~torch.isfinite(dd[1])).sum()) == 1,
          "flash dd: a NaN in dO did not stay in its row")
    # q_len > kv_len, causal: the first 128 rows see no key -> exactly 0
    q, k, v, do = flash_inputs(2, 256, 128, torch.float32, gen, dev,
                               bshd=False)
    got = flash_run(fa, "cuda", q, k, v, do, True, None, False)
    check(bool((got["out"][:, :, :128] == 0).all())
          and bool((got["dq"][:, :, :128] == 0).all()),
          "flash: fully masked rows are not exactly 0")
    check(torch.isfinite(got["out"]).all().item()
          and torch.isfinite(got["dk"]).all().item(),
          "flash: fully masked rows leaked non-finite values")

    # bf16 operands must be 16-byte aligned (TMA): a view one element
    # into a flat buffer is refused by name, before any launch
    flat = torch.zeros(2 * 128 * HEADS * HEAD_DIM + 1, dtype=torch.bfloat16,
                       device=dev)
    shifted = flat[1:].view(2, 128, HEADS, HEAD_DIM)
    q, k, v, _ = flash_inputs(2, 128, 128, torch.bfloat16, gen, dev,
                              qkv=False)
    before = dict(fa.launches)
    try:
        fa.cuda_fwd(q, shifted, v, True, 0.125, True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None and "bf16 k " in refused
          and fa.launches == before,
          f"flash fwd: misaligned bf16 k was not refused ({refused})")
    try:
        fa.cuda_row_dot(shifted, q, True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None and "do needs" in refused
          and fa.launches == before,
          f"flash dd: misaligned dO was not refused ({refused})")

    # times at the main path's shapes, one input set per layer
    results = flash_at_shape(fa, peaks, [
        flash_inputs(TRAIN_B, TRAIN_S, TRAIN_S, torch.bfloat16, gen, dev)
        for _ in range(LAYERS)], causal=True)
    for kind in ("fwd", "dkv", "dq", "dd"):
        results[kind]["max_abs_err"] = worst[(kind, "bfloat16")]
        results[kind]["max_abs_err_f32"] = worst[(kind, "float32")]
    # dd: no one PyTorch call computes rowsum(dO * O) in f32 from bf16
    # inputs; cuDNN's dot_do_o inside SDPA's backward is the reference
    # figure, reported beside the row
    lib = results["bwd"]["library"]
    dot_do_o = None
    if lib["bwd_profiler_kernels_ms"]:
        dot_do_o = sum(ms for n, ms in lib["bwd_profiler_kernels_ms"].items()
                       if "dot_do_o" in n) or None
    n_q = 1
    for dim in results["q"]:
        n_q *= dim
    results["dd"]["gbytes_per_s"] = (2 * 2 * n_q + n_q // HEAD_DIM * 4
                                     ) / results["dd"]["kernel_ms"] * 1e-6
    results["dd"]["cudnn_dot_do_o_ms"] = dot_do_o
    for kind, kernel, smem in (
            ("fwd", "flash_fwd_wgmma", "flash_attention_fwd_smem_bytes"),
            ("dkv", "flash_bwd_dkv_wgmma",
             "flash_attention_bwd_dkv_smem_bytes"),
            ("dq", "flash_bwd_dq_wgmma", "flash_attention_bwd_dq_smem_bytes")):
        results[kind]["build"] = build_report(kernel, smem)
    for kind in ("dkv", "dq"):
        check(results[kind]["build"]["spill_bytes"] == 0,
              f"flash {kind}: ptxas reports spills: "
              f"{results[kind]['build']}")
    results["library_covers"] = {
        "fwd": "scaled_dot_product_attention",
        "dkv": "its backward: dQ, dK and dV together, to hold against "
               "K2 + K3 (bwd.bwd_ms); no library call computes dK/dV "
               "alone",
        "dq": "the same backward as the dkv row",
        "dd": "none: no one PyTorch call computes rowsum(dO * O) in f32 "
              "from bf16 inputs; cudnn_dot_do_o_ms is cuDNN's kernel for "
              "it inside SDPA's backward (profiler)"}
    results["fwd_prefill"] = flash_prefill_shape(fa, gen, dev, peaks)
    torch.cuda.empty_cache()
    results["transformer_shapes"] = {
        name: flash_at_shape(fa, peaks, [
            flash_inputs(TF_B, sq, TF_SRC, torch.bfloat16, gen, dev,
                         qkv=False, heads=TF_HEADS)
            for _ in range(TF_LAYERS)], causal=False)
        for name, sq in (("self", TF_SRC), ("cross", TF_TGT))}
    results["bert_shape"] = flash_at_shape(fa, peaks, [
        flash_inputs(BERT_B, BERT_S, BERT_S, torch.bfloat16, gen, dev,
                     qkv=False) for _ in range(LAYERS)], causal=False)
    return results


def flash_at_shape(fa, peaks, sets, causal):
    """K1, dd, K2 and K3 over `sets` (bf16 BSHD (q, k, v, dO) input sets
    of one training shape, one per layer): each kernel timed by graph
    replay (and eagerly) beside its bound and its plain version's time,
    the port's whole backward (dd + K2 + K3, as _FlashCore.backward runs
    it) beside SDPA's forward and backward on [B, H, S, D] views of the
    same tensors (`sdpa_yardstick`)."""
    import torch
    n_sets = len(sets)
    scale = 1.0 / HEAD_DIM ** 0.5
    saved = []
    for q, k, v, do in sets:
        out, lse = fa.cuda_fwd(q, k, v, causal, scale, True)
        saved.append((out, lse, fa.cuda_row_dot(do, out, True)))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % n_sets
        return sets[it["i"]] + saved[it["i"]]

    def call(kind, impl):
        fwd, dkv, dq = fa._IMPLS[impl]

        def run():
            q, k, v, do, out, lse, dd = nxt()
            if kind == "fwd":
                fwd(q, k, v, causal, scale, True)
            elif kind == "dd":
                fa.row_dot(do, out, True, impl)
            elif kind == "dkv":
                dkv(q, k, v, do, lse, dd, causal, scale, True)
            else:
                dq(q, k, v, do, lse, dd, causal, scale, True)
        return run

    def port_bwd():
        q, k, v, do, out, lse, _ = nxt()
        dd = fa.cuda_row_dot(do, out, True)
        fa.cuda_bwd_dkv(q, k, v, do, lse, dd, causal, scale, True)
        fa.cuda_bwd_dq(q, k, v, do, lse, dd, causal, scale, True)

    lib = sdpa_yardstick(sets, causal=causal)
    library = {"fwd": lib["fwd_ms"], "dkv": lib["bwd_ms"],
               "dq": lib["bwd_ms"], "dd": None}
    q0, k0 = sets[0][0], sets[0][1]
    out = {"q": list(q0.shape), "k": list(k0.shape), "dtype": "bfloat16",
           "causal": causal, "layout": "bshd",
           "bwd": {"bwd_ms": graph_ms(port_bwd, n_sets),
                   "library_bwd_ms": lib["bwd_ms"],
                   "what": "bwd_ms: dd + K2 + K3 by graph replay; "
                           "library_bwd_ms: SDPA's backward (dQ, dK "
                           "and dV) on the same inputs",
                   "library": lib}}
    for kind in ("fwd", "dkv", "dq", "dd"):
        bound_ms, bound_by = flash_bound(kind, q0, k0, causal, None, True,
                                         peaks)
        kernel_ms = graph_ms(call(kind, "cuda"), n_sets)
        out[kind] = {"kernel_ms": kernel_ms,
                     "eager_call_ms": time_ms(call(kind, "cuda"), 60),
                     "plain_ms": time_ms(call(kind, "plain"), 3),
                     "library_ms": library[kind],
                     "bound_ms": bound_ms, "bound_by": bound_by}
        if kind != "dd":
            out[kind]["tflops"] = flash_flops(
                kind, q0, k0, causal, None, True) / kernel_ms * 1e-9
    del sets[:], saved
    return out


def flash_prefill_shape(fa, gen, dev, peaks):
    """K1 at the dense prefill's shape, [1, 768, 12, 64] bf16 causal
    BSHD views of one qkv projection (12 input sets, one per layer):
    held against plain_fwd, timed by graph replay against its bound, its
    plain version and SDPA's forward on [B, H, S, D] views of the same
    tensors."""
    import torch
    F = torch.nn.functional
    scale = 1.0 / HEAD_DIM ** 0.5
    sets = [flash_inputs(1, DENSE_BUCKET, DENSE_BUCKET, torch.bfloat16, gen,
                         dev)[:3] for _ in range(LAYERS)]
    q, k, v = sets[0]
    out, lse = fa.cuda_fwd(q, k, v, True, scale, True)
    ref, ref_lse = fa.plain_fwd(q, k, v, True, scale, True)
    # per element, as the flash phase holds K1: 2e-2 x max(1, |ref|)
    errs = {}
    for key, g, r in (("out", out, ref), ("lse", lse, ref_lse)):
        r = r.float()
        e = (g.float() - r).abs()
        errs[key] = e.max().item()
        check(torch.isfinite(g).all().item()
              and bool((e <= 2e-2 * torch.clamp(r.abs(), min=1.0)).all()),
              f"flash fwd at the prefill shape: {key} max abs err "
              f"{errs[key]} over tolerance 2e-2 x max(1, |ref|)")
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % LAYERS
        return sets[it["i"]]

    def kernel():
        fa.cuda_fwd(*nxt(), True, scale, True)

    def plain():
        fa.plain_fwd(*nxt(), True, scale, True)

    def sdpa():
        with torch.no_grad():
            F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in nxt()), is_causal=True)
    kernel_ms = graph_ms(kernel, LAYERS)
    bound_ms, bound_by = flash_bound("fwd", q, k, True, None, True, peaks)
    return {"shape": [1, DENSE_BUCKET, HEADS, HEAD_DIM], "dtype": "bfloat16",
            "causal": True, "max_abs_err": max(errs.values()),
            "max_abs_err_out": errs["out"], "max_abs_err_lse": errs["lse"],
            "tolerance": "2e-2 x max(1, |ref|) per element",
            "kernel_ms": kernel_ms,
            "plain_ms": time_ms(plain, 3), "library_ms": graph_ms(sdpa,
                                                                  LAYERS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flash_flops("fwd", q, k, True, None, True)
            / kernel_ms * 1e-9,
            "blocks_per_launch": HEADS * DENSE_BUCKET // 128}


def sdpa_yardstick(sets, causal=True):
    """SDPA's forward and backward on the training shapes, as [B, H, S,
    D] views of the same tensors, timed as the kernels are: calls
    captured in a CUDA graph and replayed. The backward is graph(forward
    + torch.autograd.grad) minus graph(forward with grad enabled), three
    times; torch.profiler's device time of the same two (the backward's
    kernels summed) cross-checks it. If capture is refused, the refusal
    is named and the profiler sum is the time: never an eager
    difference, which holds autograd's host time."""
    import torch
    F = torch.nn.functional
    lib_sets = [tuple(t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)) + (do.transpose(1, 2),)
                for q, k, v, do in sets]
    n = len(lib_sets)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % n
        return lib_sets[it["i"]]

    def fwd_no_grad():
        q, k, v, _ = nxt()
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def fwd():
        q, k, v, _ = nxt()
        F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def fwd_bwd():
        q, k, v, do = nxt()
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        torch.autograd.grad(out, (q, k, v), do)

    runs, refused = [], None
    try:
        for _ in range(3):
            runs.append(graph_ms(fwd_bwd, n) - graph_ms(fwd, n))
    except RuntimeError as exc:
        refused = f"{type(exc).__name__}: {exc}"[:400]
    torch.cuda.synchronize()
    pf, pfb = profile_calls(fwd, n), profile_calls(fwd_bwd, n)
    prof_ms, bwd_kernels = None, None
    if isinstance(pf, dict) and isinstance(pfb, dict):
        prof_ms = pfb["device_ms_per_call"] - pf["device_ms_per_call"]
        bwd_kernels = {n: ms for n, ms in
                       pfb["device_ms_per_call_by_name"].items()
                       if n not in pf["device_ms_per_call_by_name"]}
    check(not refused or prof_ms is not None,
          f"SDPA backward: graph capture refused ({refused}) and the "
          f"profiler recorded no device time")
    return {"fwd_ms": graph_ms(fwd_no_grad, n),
            "bwd_ms": prof_ms if refused else sorted(runs)[1],
            "bwd_graph_ms_runs": runs,
            "bwd_graph_capture": refused or "captured",
            "bwd_profiler_ms": prof_ms,
            "bwd_profiler_kernels_ms": bwd_kernels}


# ---------------------------------------------------------------------------
# train parity: fp32 training through K1-K3 against the dense reference
# ---------------------------------------------------------------------------

def train_parity_phase(dev):
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.nlp import gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import SGD, AdamW

    b, s = 2, 256
    fused = fused_head_parity(dev, b, s)
    scheduled = scheduled_graph_parity(dev, b, s)
    ids = torch.tensor(np.random.default_rng(SEED + 4).integers(
        0, 512, (b, s)), device=dev)
    report = {}
    for window in (None, 64):
        cfg = dict(vocab_size=512, hidden_size=256, num_layers=2,
                   num_heads=4, max_seq_len=s, dropout=0.0,
                   attn_dropout=0.0, initializer_range=0.1,
                   attn_window=window)

        def model():
            return GPTForPretraining(GPTConfig(**cfg), device=dev,
                                     dtype=torch.float32, seed=SEED)

        grads = {}
        for kernel in ("reference", "cuda"):
            m = model().train()
            with fa.kernel_scope(kernel):
                gpt_pretrain_loss(m(ids), ids).backward()
            grads[kernel] = leaf_grads(m)
        gerr = 0.0
        for n, g in grads["reference"].items():
            err = (grads["cuda"][n] - g).abs().max().item()
            lim = 1e-4 * max(1.0, g.abs().max().item())
            check(err <= lim, f"train parity window={window}: grad {n} "
                              f"differs by {err} > {lim}")
            gerr = max(gerr, err)
        def run(make, kernel, graphed, lr_change=False):
            """Five losses of a TrainStep over a fresh model; with
            lr_change, set_lr(0.3 x lr) before step 4."""
            m = model()
            opt = make(m.parameters())
            step = TrainStep(m, gpt_pretrain_loss, opt, cuda_graph=graphed)
            losses = []
            with fa.kernel_scope(kernel):
                for i in range(5):
                    if lr_change and i == 3:
                        opt.set_lr(0.3 * opt.get_lr())
                    losses.append(float(step(ids, ids)))
            graphs = list(step.graphs.values())
            check(not graphed or (len(graphs) == 1 and graphs[0].replays
                                  == 4), f"train parity: {graphs} replays")
            return losses

        traj = {}
        for opt_name, make, rtol in (
                ("sgd", lambda p: SGD(0.1, parameters=p), 1e-5),
                ("adamw", lambda p: AdamW(1e-3, parameters=p), 1e-3)):
            for kernel in ("reference", "cuda"):
                traj[(opt_name, kernel)] = run(make, kernel, False)
            traj[(opt_name, "graph")] = run(make, "cuda", True)
            traj[(opt_name, "lr")] = run(make, "cuda", False, True)
            traj[(opt_name, "graph lr")] = run(make, "cuda", True, True)
            for a, b in (("cuda", "reference"), ("graph", "cuda"),
                         ("graph lr", "lr")):
                got, ref = traj[(opt_name, a)], traj[(opt_name, b)]
                check(np.allclose(got, ref, rtol=rtol, atol=0),
                      f"train parity window={window} {opt_name}: {a} "
                      f"losses {got} vs {b} {ref} (rtol {rtol})")
            check(traj[(opt_name, "graph lr")][4]
                  != traj[(opt_name, "graph")][4],
                  f"train parity window={window} {opt_name}: set_lr did "
                  f"not reach the graphed step")
        report[f"window={window}"] = {
            "max_grad_err": gerr,
            **{f"{o}{suffix}_losses": traj[(o, k)]
               for o in ("sgd", "adamw")
               for k, suffix in (("cuda", ""), ("reference", "_ref"),
                                 ("graph", "_graph"),
                                 ("lr", "_eager_set_lr"),
                                 ("graph lr", "_graph_set_lr"))}}

    # two replays on one batch at lr 0: equal without dropout, and
    # different with it (the graph draws fresh masks from the framework
    # generator it registers)
    replays = {}
    for p in (0.0, 0.1):
        m = GPTForPretraining(GPTConfig(
            vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
            max_seq_len=s, dropout=p, attn_dropout=p,
            initializer_range=0.1), device=dev, dtype=torch.float32,
            seed=SEED)
        step = TrainStep(m, gpt_pretrain_loss,
                         SGD(0.0, parameters=m.parameters()))
        losses = [step(ids, ids) for _ in range(3)]
        replays[p] = [float(x) for x in losses[1:]]
        same = replays[p][0] == replays[p][1]
        check(same == (p == 0.0) and all(np.isfinite(replays[p])),
              f"train parity: lr 0, dropout {p}: replay losses "
              f"{replays[p]} {'differ' if p == 0.0 else 'are equal'}")
    llama = llama_train_parity(dev, ids)
    emit("train_parity", dtype="float32", layers=2, hidden=256, heads=4,
         vocab=512, batch=b, seq=s, initializer_range=0.1,
         grad_tolerance="1e-4 * max(1, max|g|)", sgd_rtol=1e-5,
         adamw_rtol=1e-3, lr0_replay_losses_dropout0=replays[0.0],
         lr0_replay_losses_dropout01=replays[0.1], **report,
         fused_head=fused, scheduled_graph=scheduled, llama=llama)


def llama_train_parity(dev, ids, steps=5):
    """fp32 LLaMA at 2 layers, 384 wide, 6 heads of 64 over 2 KV heads
    (GQA rep 3), vocab 512, on `ids`: the step-1 gradients through K1-K3
    and dd against the dense reference within 1e-4 x max(1, max|g|),
    window off and 64; the graphed TrainStep against the eager one over
    `steps` AdamW steps (losses within rtol 1e-5)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM, llama_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    def model(window=None):
        return LlamaForCausalLM(llama_config(
            vocab_size=512, hidden_size=384, num_layers=2, num_heads=6,
            num_kv_heads=2, max_seq_len=ids.shape[1], initializer_range=0.1,
            attn_window=window), device=dev, dtype=torch.float32, seed=SEED)

    out = {}
    for window in (None, 64):
        grads = {}
        for kernel in ("reference", "cuda"):
            m = model(window).train()
            fwd = fa.launches["fwd"]
            with fa.kernel_scope(kernel):
                llama_pretrain_loss(m(ids), ids).backward()
            check((fa.launches["fwd"] - fwd == 2) == (kernel == "cuda"),
                  f"llama train parity: {kernel} launched K1 "
                  f"{fa.launches['fwd'] - fwd} times")
            grads[kernel] = leaf_grads(m)
        gerr = 0.0
        for n, g in grads["reference"].items():
            err = (grads["cuda"][n] - g).abs().max().item()
            lim = 1e-4 * max(1.0, g.abs().max().item())
            check(err <= lim, f"llama train parity window={window}: grad "
                              f"{n} differs by {err} > {lim}")
            gerr = max(gerr, err)
        out[f"window={window}_max_grad_err"] = gerr
    losses = {}
    for graphed in (False, True):
        m = model()
        step = TrainStep(m, llama_pretrain_loss,
                         AdamW(1e-3, parameters=m.parameters()),
                         cuda_graph=graphed)
        losses[graphed] = [float(step(ids, ids)) for _ in range(steps)]
        graphs = list(step.graphs.values())
        check(not graphed or (len(graphs) == 1
                              and graphs[0].replays == steps - 1),
              f"llama train parity: {graphs}")
    check(np.allclose(losses[True], losses[False], rtol=1e-5, atol=0),
          f"llama train parity: graphed AdamW losses {losses[True]} "
          f"against eager {losses[False]}")
    out.update(adamw_graphed_losses=losses[True],
               adamw_eager_losses=losses[False], rtol=1e-5,
               config="vocab 512, 384 wide, 2 layers, 6 heads of 64 over "
                      "2 KV heads (rep 3), initializer 0.1")
    return out


# the fused-head checks' model: vocab 5000 > the 4096 chunk, so two
# chunks, the second ragged (904 rows)
FUSED_PARITY = dict(vocab_size=5000, hidden_size=256, num_layers=2,
                    num_heads=4, dropout=0.0, attn_dropout=0.0,
                    initializer_range=0.1)


def fused_head_parity(dev, b, s):
    """fp32: the vocab-chunked fused head (chunked_lm_loss) against the
    dense head on one model: the loss within rtol 1e-5, every gradient,
    the tied embedding's included, within 1e-4 * max(1, max|g|)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.nlp.gpt import FusedHeadLogits, gpt_pretrain_loss
    ids = torch.tensor(np.random.default_rng(SEED + 7).integers(
        0, FUSED_PARITY["vocab_size"], (b, s)), device=dev)
    losses, grads = {}, {}
    for fused in (False, True):
        m = GPTForPretraining(GPTConfig(**FUSED_PARITY, max_seq_len=s,
                                        fused_head_loss=fused),
                              device=dev, dtype=torch.float32,
                              seed=SEED).train()
        logits = m(ids)
        check(isinstance(logits, FusedHeadLogits) == fused,
              f"fused head parity: fused={fused} gave {type(logits)}")
        loss = gpt_pretrain_loss(logits, ids)
        loss.backward()
        losses[fused] = float(loss.detach())
        grads[fused] = leaf_grads(m)
    check(abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False]),
          f"fused head parity: loss {losses[True]} against the dense "
          f"{losses[False]}")
    worst = {}
    for n, g in grads[False].items():
        err = (grads[True][n] - g).abs().max().item()
        lim = 1e-4 * max(1.0, g.abs().max().item())
        check(err <= lim, f"fused head parity: grad {n} differs by {err} "
                          f"> {lim}")
        worst[n] = err
    tied = "gpt.embeddings.word_embeddings.weight"
    return {"loss": losses[True], "dense_loss": losses[False],
            "max_grad_err": max(worst.values()),
            "tied_embedding_grad_err": worst[tied], "vocab": 5000,
            "chunks": 2}


def scheduled_graph_parity(dev, b, s, steps=5):
    """The graphed TrainStep against the eager one, AdamW under
    LinearWarmup over CosineAnnealingDecay, fused head on: losses within
    rtol 1e-5, and after each call the device lr equal to the schedule's
    value for that step (f32)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.nlp import gpt_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW, lr
    ids = torch.tensor(np.random.default_rng(SEED + 8).integers(
        0, FUSED_PARITY["vocab_size"], (b, s)), device=dev)
    runs = {}
    for graphed in (False, True):
        m = GPTForPretraining(GPTConfig(**FUSED_PARITY, max_seq_len=s,
                                        fused_head_loss=True),
                              device=dev, dtype=torch.float32, seed=SEED)
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=4),
                                warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
        opt = AdamW(sched, parameters=m.parameters())
        step = TrainStep(m, gpt_pretrain_loss, opt, cuda_graph=graphed)
        losses, device_lr = [], []
        for _ in range(steps):
            losses.append(float(step(ids, ids)))
            device_lr.append(opt._scalars[0].item())
            check(device_lr[-1] == float(np.float32(sched())),
                  f"scheduled graph parity: device lr {device_lr[-1]} is "
                  f"not the schedule's {sched()}")
            sched.step()
        graphs = list(step.graphs.values())
        check(not graphed or (len(graphs) == 1 and graphs[0].replays
                              == steps - 1),
              f"scheduled graph parity: {graphs}")
        runs[graphed] = {"losses": losses, "device_lr": device_lr}
    check(np.allclose(runs[True]["losses"], runs[False]["losses"],
                      rtol=1e-5, atol=0),
          f"scheduled graph parity: graphed losses "
          f"{runs[True]['losses']} against eager {runs[False]['losses']}")
    check(len(set(runs[True]["device_lr"])) == steps,
          "scheduled graph parity: the lr did not move every step")
    return {"graphed": runs[True], "eager": runs[False], "rtol": 1e-5}


# ---------------------------------------------------------------------------
# eager: the Paddle Tensor surface (to_tensor, the op library, autograd) on
# the card
# ---------------------------------------------------------------------------

# the f32 parity check's batch and sequence: cut from bench.py's 8 x 1024
# to a fast check that still takes the kernel route (a multiple of 128)
EAGER_PARITY_B, EAGER_PARITY_S = 2, 256
EAGER_STEPS = 3
# steps of each contender timed after the checked ones, in turns
TIMED_ROUNDS = 6
# forward tolerance of the CUDA-vs-CPU op sweep by op (relative to
# max(1, |ref|)): elementwise ops 1e-5; reductions, products, scans,
# attention and linalg, whose sums the card orders differently, 1e-4
SWEEP_LOOSE = {
    "sum", "mean", "prod", "nansum", "nanmean", "logsumexp", "std", "var",
    "median", "quantile", "cumsum", "cumprod", "logcumsumexp", "matmul",
    "dot", "bmm", "inner", "outer", "addmm", "kron", "trace", "mv",
    "tensordot", "norm", "dist", "renorm", "trapezoid", "lerp", "polar",
    "flash_attention", "sequence_conv", "sequence_softmax",
    "sequence_topk_avg_pooling", "sequence_pool_sum", "sequence_pool_sqrt",
    "sequence_pool_average", "cholesky", "inverse", "pinv", "det",
    "slogdet", "matrix_power", "svd", "qr", "eigh", "eigvalsh", "solve",
    "triangular_solve", "cholesky_solve", "lstsq", "bincount"}


def tensor_gpt_loss(P, attention, params, ids, num_heads, num_layers):
    """GPT-2's forward and next-token loss written only in the Paddle
    Tensor surface of package `P` (`paddle_tpu_torch`, or the JAX package
    in the CPU tests): `params` maps the state-dict names of
    `GPTForPretraining` (Linear weights [in, out]) to Tensors,
    `attention` is the package's registered flash_attention. Pre-norm
    blocks, LayerNorm eps 1e-5, tanh-GELU, the head tied to the word
    embeddings; the loss is `gpt_pretrain_loss`'s: the mean over B x
    (S - 1) positions of logsumexp - the next token's logit, in f32."""
    w = params
    b, s = ids.shape
    wte = w["gpt.embeddings.word_embeddings.weight"]
    x = P.gather(wte, P.reshape(ids, [-1])).reshape([b, s, -1]) + P.gather(
        w["gpt.embeddings.position_embeddings.weight"], P.arange(s))
    hidden = x.shape[-1]

    def ln(v, name):
        mu = v.mean(axis=-1, keepdim=True)
        var = ((v - mu) * (v - mu)).mean(axis=-1, keepdim=True)
        return (v - mu) / P.sqrt(var + 1e-5) * w[name + ".weight"] + \
            w[name + ".bias"]

    def linear(v, name):
        return P.matmul(v, w[name + ".weight"]) + w[name + ".bias"]

    for i in range(num_layers):
        pre = f"gpt.blocks.{i}."
        qkv = linear(ln(x, pre + "ln_1"), pre + "attn.qkv_proj").reshape(
            [b, s, 3, num_heads, hidden // num_heads])
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True,
                      layout="bshd")
        x = x + linear(o.reshape([b, s, hidden]), pre + "attn.out_proj")
        m = linear(ln(x, pre + "ln_2"), pre + "mlp.fc_in")
        m = 0.5 * m * (1.0 + P.tanh(0.7978845608028654 *
                                    (m + 0.044715 * m * m * m)))
        x = x + linear(m, pre + "mlp.fc_out")
    x = ln(x, "gpt.ln_f")
    logits = P.matmul(x[:, :-1], wte, transpose_y=True).astype("float32")
    picked = P.take_along_axis(logits, P.unsqueeze(ids[:, 1:], -1), axis=-1)
    return (P.logsumexp(logits, axis=-1) - P.squeeze(picked, -1)).mean()


def layer_gpt(P, attention, vocab, hidden, heads, layers, max_seq):
    """GPT-2 built only from the `nn` layers of package `P`
    (`paddle_tpu_torch`, or the JAX package in the CPU tests):
    `Embedding`, `LayerNorm` and `Linear` ([in, out] weights), tanh-GELU
    and the cross entropy from `nn.functional`, and `attention`, the
    package's registered flash_attention, causal in the BSHD layout.
    Pre-norm blocks, LayerNorm eps 1e-5, the head tied to the word
    embeddings. Its sublayers carry `GPTForPretraining`'s names, so its
    state-dict keys are the module's (`layer_gpt_state`); the model
    returns the logits and `layer_gpt_loss` the next-token loss."""
    nn, F = P.nn, P.nn.functional

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv_proj = nn.Linear(hidden, 3 * hidden)
            self.out_proj = nn.Linear(hidden, hidden)

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            qkv = self.qkv_proj(x).reshape([b, s, 3, heads, hidden // heads])
            o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                          causal=True, layout="bshd")
            return self.out_proj(o.reshape([b, s, hidden]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc_in = nn.Linear(hidden, 4 * hidden)
            self.fc_out = nn.Linear(4 * hidden, hidden)

        def forward(self, x):
            return self.fc_out(F.gelu(self.fc_in(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln_1 = nn.LayerNorm(hidden, epsilon=1e-5)
            self.attn = Attention()
            self.ln_2 = nn.LayerNorm(hidden, epsilon=1e-5)
            self.mlp = MLP()

        def forward(self, x):
            x = x + self.attn(self.ln_1(x))
            return x + self.mlp(self.ln_2(x))

    class Embeddings(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(vocab, hidden)
            self.position_embeddings = nn.Embedding(max_seq, hidden)

        def forward(self, ids):
            return self.word_embeddings(ids) + self.position_embeddings(
                P.arange(ids.shape[1]))

    class Model(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embeddings = Embeddings()
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.ln_f = nn.LayerNorm(hidden, epsilon=1e-5)

        def forward(self, ids):
            x = self.embeddings(ids)
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = Model()

        def forward(self, ids):
            return P.matmul(self.gpt(ids),
                            self.gpt.embeddings.word_embeddings.weight,
                            transpose_y=True)

    return GPT()


def layer_gpt_loss(P, logits, ids):
    """`gpt_pretrain_loss` in the Tensor surface: position t scored
    against ids[t + 1], the last position's label -1 and ignored, F's
    cross entropy (a mean over the valid rows)."""
    b, s, v = logits.shape
    labels = P.concat([ids[:, 1:], P.full([b, 1], -1, dtype=ids.dtype)],
                      axis=1)
    return P.nn.functional.cross_entropy(
        logits.reshape([b * s, v]), labels.reshape([b * s]), ignore_index=-1)


def layer_gpt_state(model):
    """The port GPTForPretraining `model`'s state dict for `layer_gpt`
    (the same keys and layout) as torch tensors."""
    return {k: v._data.detach() for k, v in model.state_dict().items()}


def leaf_grads(model):
    """name -> the torch gradient of each of a Layer's parameters."""
    return {n: p._data.grad for n, p in model.named_parameters()}


def layer_transformer(P, vocab, d_model, nhead, layers, d_ff, dropout,
                      tgt_len):
    """The Transformer of Vaswani et al. 2017 built only from the `nn`
    layers of package `P` (`paddle_tpu_torch`, or the JAX package in the
    CPU tests): source and target `Embedding(vocab, d_model)` scaled by
    sqrt(d_model), the legacy `add_position_encoding`,
    `nn.Transformer(d_model, nhead, layers, layers, d_ff,
    dropout=dropout, attn_dropout=0.0)` (attention dropout would send
    every attention to the dense route, in both packages) and a
    `Linear(d_model, vocab)` head. The decoder's causal mask
    (`generate_square_subsequent_mask(tgt_len)`) is built once, a
    non-persistable buffer, so no step builds it. `forward(src, tgt)`
    returns the logits [B, tgt_len, vocab]; `transformer_loss` the cross
    entropy."""
    nn = P.nn
    scale = float(d_model) ** 0.5

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedding = nn.Embedding(vocab, d_model)
            self.tgt_embedding = nn.Embedding(vocab, d_model)
            self.transformer = nn.Transformer(
                d_model, nhead, layers, layers, d_ff, dropout=dropout,
                attn_dropout=0.0)
            self.head = nn.Linear(d_model, vocab)
            self.register_buffer(
                "tgt_mask",
                self.transformer.generate_square_subsequent_mask(tgt_len),
                persistable=False)

        def embed(self, table, ids):
            return P.ops.legacy.add_position_encoding(table(ids) * scale)

        def encode(self, src):
            return self.transformer.encoder(self.embed(self.src_embedding,
                                                       src))

        def forward(self, src, tgt):
            out = self.transformer(self.embed(self.src_embedding, src),
                                   self.embed(self.tgt_embedding, tgt),
                                   tgt_mask=self.tgt_mask)
            return self.head(out)

    return Seq2Seq()


def transformer_loss(P, logits, labels):
    """The mean token cross entropy of `layer_transformer`'s logits."""
    b, s, v = logits.shape
    return P.nn.functional.cross_entropy(logits.reshape([b * s, v]),
                                         labels.reshape([b * s]))


def load_op_cases():
    """tests/torch_op_cases.py (numpy only), by path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_op_cases.py")
    spec = importlib.util.spec_from_file_location("torch_op_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_close(name, got, want, rtol):
    import numpy as np
    check(got.shape == want.shape, f"eager sweep {name}: shape "
                                   f"{got.shape} != {want.shape}")
    if want.dtype.kind in "biu":
        check(np.array_equal(got, want), f"eager sweep {name}: values")
        return 0.0
    check((np.isnan(got) == np.isnan(want)).all(),
          f"eager sweep {name}: NaN positions differ")
    fin = np.isfinite(want)
    check(np.array_equal(got[~fin & ~np.isnan(want)],
                         want[~fin & ~np.isnan(want)]),
          f"eager sweep {name}: infinities differ")
    if not fin.any():
        return 0.0
    rel = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    check(float(rel.max()) <= rtol, f"eager sweep {name}: error "
                                    f"{float(rel.max())} > {rtol}")
    return float(rel.max())


def op_sweep():
    """Every case of tests/torch_op_cases.py (every op in the port's
    OP_REGISTRY, and the data-dependent-shape ops) on seeded CUDA inputs
    against the same op on the CPU: forward values (`SWEEP_LOOSE`'s
    tolerance), gradients through backward() within 1e-4 x max(1,
    max|g|), outputs on the card. The forward runs under
    torch.cuda.set_sync_debug_mode("warn"): the cases that synchronise
    with the host are listed."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import dispatch
    cases = load_op_cases()
    n = cases.port_namespace()
    names = sorted(cases.CASES)
    covered = {cases.op_name(k) for k in names}
    missing = sorted(set(dispatch.OP_REGISTRY) - covered)
    check(not missing, f"eager sweep: registered ops without a case: "
                       f"{missing}")
    syncing, failures, worst_fwd, worst_grad = [], [], 0.0, 0.0
    old = pt.get_device()
    try:
        for name in names:
            # every case runs; the failures are reported together below
            try:
                synced, fwd, grad = sweep_case(cases, n, name)
            except RuntimeError as e:
                failures.append(str(e))
                continue
            if synced:
                syncing.append(name)
            worst_fwd, worst_grad = max(worst_fwd, fwd), max(worst_grad,
                                                             grad)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        pt.set_device(old)
    check(not failures, f"eager sweep: {len(failures)} of {len(names)} "
                        f"cases failed: {failures}")
    return {"cases": len(names), "registered_ops": len(dispatch.OP_REGISTRY),
            "max_rel_err_forward": worst_fwd,
            "max_rel_err_grad": worst_grad, "host_syncing": syncing}


def sweep_case(cases, n, name):
    """One case of `op_sweep`: (whether its forward synchronised with the
    host, its largest relative forward error, gradient error)."""
    import warnings
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    ref_f, ref_g = cases.run(n, name)
    pt.set_device("gpu:0")
    ts = cases.inputs(n, name)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = cases.call(n, name, ts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    synced = any("synchroniz" in str(w.message) for w in caught)
    for o in outs:
        check(o._data.device.type == "cuda", f"eager sweep {name}: an "
                                             f"output left the card "
                                             f"({o._data.device})")
    rtol = 1e-4 if name in SWEEP_LOOSE else 1e-5
    check([d for d, _ in ref_f] == [cases.dtype_name(o) for o in outs],
          f"eager sweep {name}: dtypes differ")
    fwd = max(sweep_close(name, cases.host(o), want, rtol)
              for (_, want), o in zip(ref_f, outs))
    grad = 0.0
    if ref_g is None:
        return synced, fwd, grad
    for want, g in zip(ref_g, cases.grads(n, name, ts, outs)):
        check((want is None) == (g is None),
              f"eager sweep {name}: a gradient is missing")
        if want is None:
            continue
        err = float(np.abs(cases.host(g) - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        check(err <= 1e-4 * scale, f"eager sweep {name}: gradient error "
                                   f"{err} > 1e-4 x {scale}")
        grad = max(grad, err / scale)
    return synced, fwd, grad


def eager_params(model):
    """The model's weights as the Tensor surface's Parameters (copies)."""
    import paddle_tpu_torch as pt
    return {k: pt.Parameter(v) for k, v in model.state_dict().items()}


def eager_gpt_parity(dev):
    """The f32 Tensor-surface GPT-2 small (`tensor_gpt_loss`) against the
    port's GPTForPretraining from the same weights: loss within 1e-5
    relative, every gradient within 1e-4 x max(1, max|g|); K1-K3 and dd
    launch once per layer in its forward and backward."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    model = GPTForPretraining(train_config(), device=dev,
                              dtype=torch.float32, seed=SEED)
    params = eager_params(model)
    ids_np = np.random.RandomState(1).randint(
        0, TRAIN_VOCAB, (EAGER_PARITY_B, EAGER_PARITY_S)).astype("int32")
    ref = gpt_pretrain_loss(model(torch.tensor(ids_np, device=dev)),
                            torch.tensor(ids_np, device=dev))
    ref.backward()
    zero_counts()
    loss = tensor_gpt_loss(pt, fa.flash_attention, params,
                           pt.to_tensor(ids_np), HEADS, LAYERS)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    check(launches == {k: LAYERS for k in ("fwd", "dkv", "dq", "dd")},
          f"eager f32 GPT: flash launches {launches}")
    ref = float(ref.detach())
    rel = abs(float(loss) - ref) / abs(ref)
    check(rel <= 1e-5, f"eager f32 GPT: loss {float(loss)} vs {ref} "
                       f"(rel {rel})")
    worst = 0.0
    named = leaf_grads(model)
    for k, p in params.items():
        want = named[k]
        check(want is not None and p.grad is not None,
              f"eager f32 GPT: no gradient for {k}")
        scale = max(1.0, float(want.abs().max()))
        err = float((p.grad._data - want).abs().max())
        check(err <= 1e-4 * scale, f"eager f32 GPT: {k} gradient error "
                                   f"{err} > 1e-4 x {scale}")
        worst = max(worst, err / scale)
    out = {"batch": EAGER_PARITY_B, "seq": EAGER_PARITY_S,
           "loss": float(loss), "module_loss": ref, "loss_rel": rel,
           "max_grad_err": worst, "params": len(params),
           "launches": launches}
    del model, params
    return out


def gpt_steps(dev, main, steps=EAGER_STEPS):
    """bench.py's shape (batch 8 x seq 1024, bf16): `steps` AdamW steps
    (forward, loss, backward, step, clear_grad) of the nn.Module model,
    of the Tensor-surface GPT (`tensor_gpt_loss`) over pt.Parameters and,
    when `main` is "layer", of `layer_gpt` over `layer.parameters()`, all
    from the same weights; the losses held within 2e-2 relative of the
    module's. The counts are zeroed before the steps of `main` ("tensor"
    or "layer", the path the phase drives) and read after: 12 launches
    each of K1-K3 and dd and 1 Adam launch a step. Then `TIMED_ROUNDS`
    more steps of each contender, in turns, each step's forward, backward
    and optimizer step timed apart by CUDA events (medians); then two
    more steps of each, profiled (`profile_steps`, kernel groups
    `STEP_GROUPS`)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForPretraining(train_config(), device=dev,
                              dtype=torch.bfloat16, seed=SEED)
    params = eager_params(model)
    contenders = {"module": (lambda: gpt_pretrain_loss(model(ids_t), ids_t),
                             model.parameters()),
                  "tensor": (lambda: tensor_gpt_loss(
                      pt, fa.flash_attention, params, ids, HEADS, LAYERS),
                      list(params.values()))}
    if main == "layer":
        layer = layer_gpt(pt, fa.flash_attention, TRAIN_VOCAB, 768, HEADS,
                          LAYERS, TRAIN_S).to(dtype="bfloat16")
        missing, unexpected = layer.set_state_dict(layer_gpt_state(model))
        check(not missing and not unexpected,
              f"layer_gpt state: missing {missing}, unexpected {unexpected}")
        contenders["layer"] = (lambda: layer_gpt_loss(pt, layer(ids), ids),
                               layer.parameters())
    model.train()
    ids_np = np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, (TRAIN_B, TRAIN_S)).astype("int32")
    ids_t = torch.tensor(ids_np.astype("int64"), device=dev)
    ids = pt.to_tensor(ids_np)

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def one_step(fwd, opt):
        """(loss, (forward, backward, optimizer ms)) of one step."""
        e0 = ev()
        loss = fwd()
        e1 = ev()
        loss.backward()
        e2 = ev()
        opt.step()
        opt.clear_grad()
        e3 = ev()
        torch.cuda.synchronize()
        return float(loss.detach()), (e0.elapsed_time(e1),
                                      e1.elapsed_time(e2),
                                      e2.elapsed_time(e3))

    losses, opts = {}, {}
    for label, (fwd, ps) in contenders.items():
        opts[label] = AdamW(learning_rate=1e-4, parameters=ps)
        if label == main:
            # the main path's run: every count is 0 before it, read after
            zero_counts()
        losses[label] = [one_step(fwd, opts[label])[0]
                         for _ in range(steps)]
        if label == main:
            counts = kernels.launch_counts()
    # the timed steps: the contenders in turns, forward and back, after
    # the checked steps (their first step paid for the allocations);
    # medians of each part
    parts = {label: [] for label in contenders}
    labels = list(contenders)
    for r in range(TIMED_ROUNDS):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            parts[label].append(one_step(contenders[label][0],
                                         opts[label])[1])
    ms = {}
    for label, rows in parts.items():
        med = np.median(rows, axis=0)
        ms[label] = {"forward_ms": float(med[0]),
                     "backward_ms": float(med[1]),
                     "optimizer_ms": float(med[2]),
                     "step_ms": float(np.median(np.sum(rows, axis=1))),
                     "steps_timed": len(rows)}
    per_step = {k: counts[f"flash_attention.{k}"] // steps
                for k in ("fwd", "dkv", "dq", "dd")}
    check(all(counts[f"flash_attention.{k}"] == LAYERS * steps
              for k in per_step),
          f"{main} steps: flash launches {counts}, not {LAYERS} a step")
    check(counts["optimizer.adam"] == steps,
          f"{main} steps: {counts['optimizer.adam']} optimizer launches")
    for label in contenders:
        for a, b in zip(losses[label], losses["module"]):
            check(np.isfinite(a) and abs(a - b) <= 2e-2 * abs(b),
                  f"{label} steps: losses {losses[label]} vs module "
                  f"{losses['module']}")
        check(losses[label][-1] < losses[label][0],
              f"{label} steps: the loss did not fall {losses[label]}")

    def whole_step(fwd, step_opt):
        def step(*_):
            loss = fwd()
            loss.backward()
            step_opt.step()
            step_opt.clear_grad()
            return loss.detach()
        return step
    # where each step's device time goes, after the checked steps
    profiles = {}
    for label, (fwd, _) in contenders.items():
        prof = profile_steps(whole_step(fwd, opts[label]), None,
                             ms[label]["step_ms"], categories=STEP_GROUPS,
                             other=STEP_OTHER)
        if isinstance(prof, dict):
            del prof["kernel_calls_per_step"]
            prof["top_kernels"] = prof["top_kernels"][:8]
        profiles[label] = prof
    return {"batch": TRAIN_B, "seq": TRAIN_S, "dtype": "bfloat16",
            "steps": steps, "main": main, "losses": losses, "ms": ms,
            "profile": profiles, "launches_per_step": per_step,
            "launches": {k: counts[f"flash_attention.{k}"]
                         for k in per_step},
            "adam_launches": counts["optimizer.adam"]}


def dispatch_overhead(calls=10_000):
    """Host microseconds per op: `calls` pt.add calls on [8] f32 CUDA
    tensors (stop_gradient True, then False) against raw torch.add, each
    loop closed by a synchronize."""
    import torch
    import paddle_tpu_torch as pt
    out = {}
    a = torch.randn(8, device="cuda")
    b = torch.randn(8, device="cuda")
    for label, fn in (
            ("torch_add", lambda: torch.add(a, b)),
            ("pt_add", lambda x=pt.to_tensor(a), y=pt.to_tensor(b):
             pt.add(x, y)),
            ("pt_add_grad", lambda x=pt.to_tensor(a, stop_gradient=False),
             y=pt.to_tensor(b): pt.add(x, y))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) / calls * 1e6
    out["pt_add_over_torch_us"] = out["pt_add"] - out["torch_add"]
    return out


def eager_phase(dev, smi):
    """The Tensor surface on the card: the op sweep, the f32 GPT-2 small
    parity, bf16 AdamW steps at bench.py's shape, the dispatch overhead.
    Returns the flash kernels' launches in the eager steps."""
    import torch
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device("gpu:0")
    try:
        sweep = op_sweep()
        parity = eager_gpt_parity(dev)
        torch.cuda.empty_cache()
        steps = gpt_steps(dev, "tensor")
        overhead = dispatch_overhead()
    finally:
        pt.set_device(old)
    emit("eager", nvidia_smi=smi, op_sweep=sweep, gpt_f32_parity=parity,
         steps=steps, dispatch_us=overhead)
    return steps["launches"]


# ---------------------------------------------------------------------------
# nn: Layer, nn.functional and the layers on the card
# ---------------------------------------------------------------------------

def layer_gpt_parity(dev):
    """The f32 `layer_gpt` GPT-2 small against the port's
    GPTForPretraining from the same weights (batch 2 x seq 256): loss
    within 1e-5 relative, every gradient within 1e-4 x max(1, max|g|);
    K1-K3 and dd launch once per layer in its forward and backward."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    model = GPTForPretraining(train_config(), device=dev,
                              dtype=torch.float32, seed=SEED)
    layer = layer_gpt(pt, fa.flash_attention, TRAIN_VOCAB, 768, HEADS,
                      LAYERS, TRAIN_S)
    layer.set_state_dict(layer_gpt_state(model))
    ids_np = np.random.RandomState(1).randint(
        0, TRAIN_VOCAB, (EAGER_PARITY_B, EAGER_PARITY_S)).astype("int32")
    ids_t = torch.tensor(ids_np, device=dev)
    ref = gpt_pretrain_loss(model(ids_t), ids_t)
    ref.backward()
    zero_counts()
    ids = pt.to_tensor(ids_np)
    loss = layer_gpt_loss(pt, layer(ids), ids)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    check(launches == {k: LAYERS for k in ("fwd", "dkv", "dq", "dd")},
          f"layer_gpt f32: flash launches {launches}")
    ref = float(ref.detach())
    rel = abs(float(loss) - ref) / abs(ref)
    check(rel <= 1e-5, f"layer_gpt f32: loss {float(loss)} vs {ref} "
                       f"(rel {rel})")
    named = leaf_grads(model)
    worst = 0.0
    for k, p in layer.named_parameters():
        want = named[k]
        check(want is not None and p.grad is not None,
              f"layer_gpt f32: no gradient for {k}")
        scale = max(1.0, float(want.abs().max()))
        err = float((p.grad._data - want).abs().max())
        check(err <= 1e-4 * scale, f"layer_gpt f32: {k} gradient error "
                                   f"{err} > 1e-4 x {scale}")
        worst = max(worst, err / scale)
    out = {"batch": EAGER_PARITY_B, "seq": EAGER_PARITY_S,
           "loss": float(loss), "module_loss": ref, "loss_rel": rel,
           "max_grad_err": worst, "params": len(layer.parameters()),
           "launches": launches}
    del model, layer
    return out


def llama_attention_check(dev):
    """The registered `llama_attention` op at the serving LLaMA's shape
    (12 heads over 4 KV heads of 64, x [8, 1024, 768], wqkv [768, 1280],
    bf16, bshd): forward and backward on the kernel route, counted (K1,
    dd, K2 and K3 once each), held against the op's plain route on the
    same inputs within 2e-2 x max(1, |ref|) (the output elementwise, the
    gradients against max(1, max|g|))."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nlp.llama import rope_tables
    from paddle_tpu_torch.ops import dispatch
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn(TRAIN_B, TRAIN_S, 768, generator=gen,
                     device=dev).bfloat16()
    w0 = (0.03 * torch.randn(768, 1280, generator=gen, device=dev)
          ).bfloat16()
    cot = torch.randn(TRAIN_B, TRAIN_S, 768, generator=gen, device=dev)
    cos, sin = (t.to(dev) for t in rope_tables(TRAIN_S, HEAD_DIM))

    def run(kernel):
        x = pt.to_tensor(x0, stop_gradient=False)
        w = pt.to_tensor(w0, stop_gradient=False)
        with fa.kernel_scope(kernel):
            out = dispatch.apply(
                dispatch.OP_REGISTRY["llama_attention"],
                (x, w, pt.to_tensor(cos), pt.to_tensor(sin)),
                {"num_heads": HEADS, "num_kv_heads": 4,
                 "head_dim": HEAD_DIM, "attn_layout": "bshd"},
                name="llama_attention")
            (out.astype("float32") * pt.to_tensor(cot)).sum().backward()
        return out._data.detach(), x.grad._data, w.grad._data

    zero_counts()
    got = run("auto")
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    check(launches == {k: 1 for k in ("fwd", "dkv", "dq", "dd")},
          f"llama_attention: flash launches {launches}")
    ref = run("plain")
    errs = {}
    for name, g, r, elementwise in zip(("out", "dx", "dwqkv"), got, ref,
                                       (True, False, False)):
        g, r = g.float(), r.float()
        check(bool(torch.isfinite(g).all()), f"llama_attention {name}: "
                                             f"not finite")
        bound = torch.clamp_min(r.abs(), 1.0) if elementwise else \
            max(1.0, float(r.abs().max()))
        rel = float(((g - r).abs() / bound).max())
        check(rel <= 2e-2, f"llama_attention {name}: error {rel} > 2e-2")
        errs[name] = rel
    return {"x": [TRAIN_B, TRAIN_S, 768], "wqkv": [768, 1280],
            "heads": HEADS, "kv_heads": 4, "dtype": "bfloat16",
            "layout": "bshd", "max_rel_err": errs, "launches": launches}


def sparse_embedding_check(dev, steps=3):
    """An `nn.Embedding(sparse=True)` table (32768 x 768, f32) trained by
    `Adam(lazy_mode=True)` for `steps` steps on the card and on the CPU
    from the same weights and ids: each step's gradient a SelectedRows;
    the rows no id touched bitwise unchanged; the touched rows the CPU's
    within 1e-5 x max(1, |ref|)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    from paddle_tpu_torch.optimizer import Adam
    vocab, dim = TRAIN_VOCAB, 768
    w0 = torch.randn(vocab, dim, generator=torch.Generator().manual_seed(
        SEED))
    r = np.random.RandomState(3)
    ids_np = r.randint(0, vocab, (steps, 8, 64)).astype("int32")
    cot = r.randn(8, 64, dim).astype("f4")

    def train(place):
        pt.set_device(place)
        emb = pt.nn.Embedding(vocab, dim, sparse=True)
        emb.set_state_dict({"weight": w0})
        opt = Adam(learning_rate=1e-2, parameters=emb.parameters(),
                   lazy_mode=True)
        c = pt.to_tensor(cot)
        for t in range(steps):
            (emb(pt.to_tensor(ids_np[t])) * c).sum().backward()
            check(isinstance(emb.weight.grad, SelectedRows),
                  f"sparse embedding on {place}: the grad is "
                  f"{type(emb.weight.grad).__name__}")
            opt.step()
            opt.clear_grad()
        return emb.weight._data.detach().cpu()

    gpu = train("gpu:0")
    cpu = train("cpu")
    pt.set_device("gpu:0")
    touched = torch.from_numpy(np.unique(ids_np)).long()
    mask = torch.zeros(vocab, dtype=torch.bool)
    mask[touched] = True
    check(torch.equal(gpu[~mask], w0[~mask]) and
          torch.equal(cpu[~mask], w0[~mask]),
          "sparse embedding: an untouched row changed")
    check(not torch.equal(gpu[mask], w0[mask]),
          "sparse embedding: the touched rows did not move")
    rel = float(((gpu[mask] - cpu[mask]).abs()
                 / cpu[mask].abs().clamp_min(1.0)).max())
    check(rel <= 1e-5, f"sparse embedding: card vs CPU error {rel}")
    return {"table": [vocab, dim], "steps": steps,
            "touched_rows": int(touched.numel()), "max_rel_err": rel}


def conv_net_check(dev):
    """A small conv net (Conv2D -> BatchNorm2D -> ReLU -> MaxPool2D ->
    Flatten -> Linear, batch 64 of 1x28x28, f32, training mode) on the
    card and on the CPU from the same weights: the logits, the cross
    entropy, every gradient and the BatchNorm running statistics within
    1e-4 x max(1, |ref|)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    nn, F = pt.nn, pt.nn.functional
    r = np.random.RandomState(5)
    x_np = r.randn(64, 1, 28, 28).astype("f4")
    y_np = r.randint(0, 10, (64,)).astype("int32")

    def build():
        return nn.Sequential(nn.Conv2D(1, 8, 3, padding=1),
                             nn.BatchNorm2D(8), nn.ReLU(), nn.MaxPool2D(2),
                             nn.Flatten(), nn.Linear(8 * 14 * 14, 10))

    def run(place, state=None):
        pt.set_device(place)
        net = build()
        if state is not None:
            net.set_state_dict(state)
        out = net(pt.to_tensor(x_np))
        loss = F.cross_entropy(out, pt.to_tensor(y_np))
        loss.backward()
        vals = {"logits": out._data, "loss": loss._data}
        vals.update({f"grad {k}": p.grad._data
                     for k, p in net.named_parameters()})
        vals.update({f"buffer {k}": b._data
                     for k, b in net.named_buffers()})
        return net, {k: v.detach().cpu() for k, v in vals.items()}

    cpu_net, ref = run("cpu")
    state = {k: v._data.detach().clone() for k, v in
             cpu_net.state_dict().items()}
    # the CPU net's buffers moved in its forward: the card's start from
    # the same initial values
    state["1._mean"] = torch.zeros(8)
    state["1._variance"] = torch.ones(8)
    _, got = run("gpu:0", state)
    worst = 0.0
    for k, want in ref.items():
        rel = float(((got[k] - want).abs()
                     / want.abs().clamp_min(1.0)).max())
        check(rel <= 1e-4, f"conv net {k}: card vs CPU error {rel}")
        worst = max(worst, rel)
    return {"batch": 64, "compared": len(ref), "max_rel_err": worst,
            "loss": float(ref["loss"])}


def layer_trainstep(dev, steps=5, per_round=5):
    """GPT-2 small built from layers (`layer_gpt`) at bench.py's shape
    (batch 8 x seq 1024, bf16) in a graphed `jit.TrainStep` with AdamW,
    by bench.py's recipe (`graphed_train`: the counts set to 0 before the
    warm-up calls and read after, 12 launches each of K1-K3 and dd and 1
    Adam launch in the graph, `steps` timed replays that launch nothing
    from Python). Its loss after those calls equals that of the eager
    Layer step (the same TrainStep with cuda_graph=False) on a twin from
    the same weights after as many steps, within 1e-6 x max(1, |eager|).
    Then the graphed module (GPTForPretraining in TrainStep), the graphed
    Layer step and the eager Layer step are timed in turns:
    `TIMED_ROUNDS` rounds of `per_round` steps each, host clock to a
    synchronize, medians."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    module = GPTForPretraining(train_config(), device=dev,
                               dtype=torch.bfloat16, seed=SEED)
    state = layer_gpt_state(module)

    def make_layer():
        layer = layer_gpt(pt, fa.flash_attention, TRAIN_VOCAB, 768, HEADS,
                          LAYERS, TRAIN_S).to(dtype="bfloat16")
        check(layer.set_state_dict(state) == ([], []),
              "layer_gpt: state keys differ from the module's")
        return layer

    def loss_fn(logits, ids):
        return layer_gpt_loss(pt, logits, ids)
    ids_np = np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, (TRAIN_B, TRAIN_S)).astype("int32")
    ids = pt.to_tensor(ids_np)
    ids_t = torch.tensor(ids_np.astype("int64"), device=dev)
    layer = make_layer()
    run = graphed_train(layer, loss_fn, AdamW(
        learning_rate=1e-4, parameters=layer.parameters()), ids,
        "nn TrainStep(layer_gpt)", steps)
    calls = 3 + steps
    twin = make_layer()
    eager = TrainStep(twin, loss_fn, AdamW(learning_rate=1e-4,
                                           parameters=twin.parameters()),
                      cuda_graph=False)
    eager_losses = [float(eager(ids, ids)) for _ in range(calls)]
    graphed_loss = run["final"]
    gap = abs(graphed_loss - eager_losses[-1])
    check(gap <= 1e-6 * max(1.0, abs(eager_losses[-1])),
          f"nn TrainStep(layer_gpt): graphed loss {graphed_loss} after "
          f"{calls} steps, eager {eager_losses[-1]}")
    mod_step = TrainStep(module, gpt_pretrain_loss, AdamW(
        learning_rate=1e-4, parameters=module.parameters()))
    for _ in range(3):
        float(mod_step(ids_t, ids_t))
    contenders = {"module_graphed": (mod_step, ids_t),
                  "layer_graphed": (run["step"], ids),
                  "layer_eager": (eager, ids)}
    times = {k: [] for k in contenders}
    labels = list(contenders)
    for r in range(TIMED_ROUNDS):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            step, x = contenders[label]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_round):
                loss = step(x, x)
            float(loss)
            times[label].append((time.perf_counter() - t0) * 1e3
                                / per_round)
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "dtype": "bfloat16",
           "graphed_step_ms": run["dt"] * 1e3,
           "launches_per_step": run["per_step"], "launches": run["launches"],
           "routes": run["routes"], "graphed_loss": graphed_loss,
           "eager_loss": eager_losses[-1], "loss_gap": gap,
           "steps_compared": calls,
           "ms_in_turns": {k: float(np.median(v)) for k, v in times.items()},
           "ms_in_turns_all": times,
           "profile": run["profile"]}
    if isinstance(out["profile"], dict):
        out["profile"]["top_kernels"] = out["profile"]["top_kernels"][:8]
    del run, layer, twin, module, contenders, mod_step, eager
    return out


def nn_phase(dev, smi):
    """The nn slice on the card: `layer_gpt` at f32 against
    GPTForPretraining, its bf16 AdamW steps at bench.py's shape beside
    the module's and the Tensor surface's (the main path's launches),
    `layer_gpt` in a graphed TrainStep (`layer_trainstep`), the
    registered llama_attention, the sparse embedding under lazy Adam, a
    small conv net. Returns the layer steps' launches of K1-K3, dd and
    Adam, the TrainStep's, and llama_attention's."""
    import torch
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device("gpu:0")
    try:
        parity = layer_gpt_parity(dev)
        torch.cuda.empty_cache()
        steps = gpt_steps(dev, "layer")
        torch.cuda.empty_cache()
        trainstep = layer_trainstep(dev)
        torch.cuda.empty_cache()
        llama = llama_attention_check(dev)
        sparse = sparse_embedding_check(dev)
        conv = conv_net_check(dev)
    finally:
        pt.set_device(old)
    emit("nn", nvidia_smi=smi, layer_gpt_f32_parity=parity, steps=steps,
         trainstep=trainstep, llama_attention=llama,
         sparse_embedding=sparse, conv_net=conv)
    return {**steps["launches"], "adam": steps["adam_launches"],
            "trainstep": trainstep["launches"],
            "llama_attention": llama["launches"]}


# ---------------------------------------------------------------------------
# transformer: Transformer-base built from nn layers, through TrainStep
# ---------------------------------------------------------------------------

def transformer_flops(b, s_src, s_tgt, d, ff, layers, vocab):
    """Operations of one training step of `layer_transformer`: 6 per
    multiply-add of the forward (2 for the forward, 4 for the backward)
    over every projection and feed-forward product on the tokens it sees
    (the encoder, and the cross-attention's key and value projections,
    on the source tokens; the rest of the decoder and the head on the
    target tokens) and the attention products QK^T and PV over the
    pairs each attention needs (the decoder's masked self-attention over
    its causal half)."""
    enc = layers * (4 * d * d + 2 * d * ff) * b * s_src
    dec = layers * (6 * d * d + 2 * d * ff) * b * s_tgt + \
        layers * 2 * d * d * b * s_src
    head = d * vocab * b * s_tgt
    pairs = s_src * s_src + s_tgt * s_src + s_tgt * (s_tgt + 1) / 2
    att = layers * 2 * d * b * pairs
    return 6 * (enc + dec + head + att)


def transformer_model(dropout, dtype="float32"):
    """`layer_transformer` at Transformer-base's widths and depth on the
    current place, from the framework seed."""
    import paddle_tpu_torch as pt
    pt.seed(SEED)
    model = layer_transformer(pt, TF_VOCAB, TF_D, TF_HEADS, TF_LAYERS,
                              TF_FF, dropout, TF_TGT)
    return model if dtype == "float32" else model.to(dtype=dtype)


def transformer_batch(b, seed):
    """(src [b, TF_SRC], tgt [b, TF_TGT], labels [b, TF_TGT]) int32
    Tensors on the current place, from `seed`."""
    import numpy as np
    import paddle_tpu_torch as pt
    r = np.random.RandomState(seed)
    return tuple(pt.to_tensor(r.randint(0, TF_VOCAB, (b, n)).astype("int32"))
                 for n in (TF_SRC, TF_TGT, TF_TGT))


def transformer_optimizer(model, lr=None):
    """The paper's optimizer: AdamW(beta1 0.9, beta2 0.98, epsilon 1e-9)
    on NoamDecay(d_model, 4000) (or a constant `lr`). Returns (optimizer,
    schedule or None)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    sched = NoamDecay(TF_D, 4000) if lr is None else None
    opt = AdamW(learning_rate=sched if lr is None else lr, beta1=0.9,
                beta2=0.98, epsilon=1e-9, parameters=model.parameters())
    return opt, sched


def tf_loss(logits, labels):
    import paddle_tpu_torch as pt
    return transformer_loss(pt, logits, labels)


def transformer_parity(dev):
    """f32 at batch 2 (384 source, 256 target tokens), dropout 0, full
    depth and width: the loss and every gradient through the kernels
    (12 launches each of K1, dd, K2 and K3) against `kernel="plain"`,
    the loss within 1e-4 x max(1, |ref|), the gradients within 1e-4 x
    max(1, max|g|); then the graphed TrainStep against the eager one (a
    twin from the same weights) over 3 steps (eager, capture + replay,
    replay) within 1e-6 x max(1, |eager|)."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    model = transformer_model(0.0)
    src, tgt, lab = transformer_batch(2, SEED + 21)
    model.train()

    def loss_and_grads(kernel):
        with fa.kernel_scope(kernel):
            loss = tf_loss(model(src, tgt), lab)
            loss.backward()
        torch.cuda.synchronize()
        grads = {k: p.grad._data.detach().clone()
                 for k, p in model.named_parameters()}
        model.clear_gradients()
        return float(loss), grads
    ref_loss, ref_g = loss_and_grads("plain")
    zero_counts()
    loss, grads = loss_and_grads("cuda")
    launches = dict(fa.launches)
    check(launches == {k: 2 * TF_LAYERS for k in ("fwd", "dkv", "dq", "dd")},
          f"transformer f32: flash launches {launches}")
    loss_err = abs(loss - ref_loss)
    check(loss_err <= 1e-4 * max(1.0, abs(ref_loss)),
          f"transformer f32: loss {loss} against plain {ref_loss}")
    worst = 0.0
    for k, want in ref_g.items():
        scale = max(1.0, float(want.abs().max()))
        err = float((grads[k] - want).abs().max())
        check(err <= 1e-4 * scale, f"transformer f32: {k} gradient error "
                                   f"{err} > 1e-4 x {scale}")
        worst = max(worst, err / scale)
    del ref_g, grads
    twin = transformer_model(0.0)
    check(twin.set_state_dict(model.state_dict()) == ([], []),
          "transformer twin: state keys differ")
    (opt_g, sched_g), (opt_e, sched_e) = (transformer_optimizer(model),
                                          transformer_optimizer(twin))
    graphed = TrainStep(model, tf_loss, opt_g)
    eager = TrainStep(twin, tf_loss, opt_e, cuda_graph=False)
    pairs = []
    for _ in range(3):
        g = float(graphed((src, tgt), lab))
        e = float(eager((src, tgt), lab))
        sched_g.step()
        sched_e.step()
        pairs.append((g, e))
        check(abs(g - e) <= 1e-6 * max(1.0, abs(e)),
              f"transformer f32: graphed losses {pairs} against eager")
    (graph,) = graphed.graphs.values()
    want = {f"flash_attention.{k}": 2 * TF_LAYERS
            for k in ("fwd", "dkv", "dq", "dd")}
    want["optimizer.adam"] = 1
    check(graph is not None and graph.launches == want,
          f"transformer f32: the graph holds {graph and graph.launches}")
    out = {"batch": 2, "src": TF_SRC, "tgt": TF_TGT, "dtype": "float32",
           "loss": loss, "plain_loss": ref_loss, "loss_err": loss_err,
           "max_grad_err_over_scale": worst, "launches": launches,
           "params": sum(p.numel() for p in model.parameters()),
           "param_tensors": len(model.parameters()),
           "graphed_vs_eager_losses": pairs}
    del model, twin, graphed, eager, opt_g, opt_e
    return out


def transformer_dropout(dev):
    """Two replays of the graphed step on identical inputs at lr 0
    (AdamW with a constant learning rate 0: the weights stay) give
    different losses with dropout 0.1 (the framework generator is
    registered with the graph: each replay draws fresh masks) and equal
    losses with dropout 0."""
    from paddle_tpu_torch.jit import TrainStep
    src, tgt, lab = transformer_batch(2, SEED + 22)
    out = {}
    for p in (0.1, 0.0):
        model = transformer_model(p)
        step = TrainStep(model, tf_loss, transformer_optimizer(model,
                                                               0.0)[0])
        losses = [float(step((src, tgt), lab)) for _ in range(4)]
        check(list(step.graphs.values())[0] is not None,
              f"transformer dropout {p}: no graph captured")
        if p:
            check(losses[2] != losses[3], f"transformer dropout {p}: two "
                                          f"replays gave {losses[2:]}")
        else:
            check(losses[2] == losses[3], f"transformer dropout 0: two "
                                          f"replays gave {losses[2:]}")
        out[str(p)] = losses
        del model, step
    return out


def dense_masked_attention_ms(dev, dtype):
    """The decoder's masked self-attention as its layers run it (the
    registered flash_attention op with the additive causal mask: the
    dense route), forward and backward, TF_LAYERS calls at
    [TF_B, TF_HEADS, TF_TGT, 64] captured in a CUDA graph and replayed:
    ms per step."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(SEED + 23)
    mask = pt.triu(pt.full([TF_TGT, TF_TGT], float("-inf")),
                   diagonal=1).astype(str(dtype).split(".")[-1])
    sets = []
    for _ in range(TF_LAYERS):
        q, k, v, do = flash_inputs(TF_B, TF_TGT, TF_TGT, dtype, gen, dev,
                                   bshd=False, heads=TF_HEADS)
        sets.append([pt.Tensor(t, stop_gradient=False) for t in (q, k, v)]
                    + [do])

    def run():
        for q, k, v, do in sets:
            out = fa.flash_attention(q, k, v, attn_mask=mask)
            torch.autograd.grad(out._data, [t._data for t in (q, k, v)],
                                do)
    before = dict(fa.routes)
    run()
    check(fa.routes["dense"] - before["dense"] == TF_LAYERS
          and fa.routes["kernel"] == before["kernel"],
          "dense masked attention: a call left the dense route")
    return graph_ms(run, 1)


def transformer_timed(dev, peaks, steps=10):
    """Transformer-base in bf16 at batch 64 (384 source, 256 target
    tokens), dropout 0.1, in a graphed TrainStep on the paper's
    optimizer, by bench.py's recipe (`graphed_train`: the counts set to
    0, 3 warm-up calls, `steps` timed replays, the schedule stepped after
    each): 12 launches each of K1, dd, K2 and K3 and 1 Adam launch a
    step, 24 kernel-route and 12 dense-route attentions in the eager call
    and the capture. Step ms, target tokens/s, MFU (`transformer_flops`
    over the bf16 peak), peak memory, device time by kernel group beside
    the decoder's dense masked attention timed alone, and the eager
    step's ms. Returns (its fields, the model)."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    model = transformer_model(0.1, "bfloat16")
    opt, sched = transformer_optimizer(model)
    src, tgt, lab = transformer_batch(TF_B, SEED + 24)
    torch.cuda.reset_peak_memory_stats()
    run = graphed_train(model, tf_loss, opt, (src, tgt), "transformer",
                        steps, labels=lab, layers=2 * TF_LAYERS,
                        routes_want={"kernel": 4 * TF_LAYERS,
                                     "dense": 2 * TF_LAYERS},
                        after_step=sched.step, groups=TF_GROUPS)
    dt = run["dt"]
    flops = transformer_flops(TF_B, TF_SRC, TF_TGT, TF_D, TF_FF, TF_LAYERS,
                              TF_VOCAB)
    eager = TrainStep(model, tf_loss, opt, cuda_graph=False)
    for _ in range(2):
        float(eager((src, tgt), lab))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        loss = eager((src, tgt), lab)
    float(loss)
    eager_ms = (time.perf_counter() - t0) * 1e3 / 5
    del eager
    dense_ms = dense_masked_attention_ms(dev, torch.bfloat16)
    profile = run["profile"]
    if isinstance(profile, dict):
        profile["top_kernels"] = profile["top_kernels"][:16]
    n_params = sum(p.numel() for p in model.parameters())
    return {"model": "Transformer-base (6 + 6 layers, d_model 512, 8 "
                     "heads of 64, d_ff 2048, vocab 37000)",
            "dtype": "bfloat16", "batch": TF_B, "src": TF_SRC,
            "tgt": TF_TGT, "dropout": 0.1, "attn_dropout": 0.0,
            "steps": steps, "step": "one CUDA graph replay per call",
            "step_ms": dt * 1e3, "target_tokens_per_s": TF_B * TF_TGT / dt,
            "source_tokens_per_s": TF_B * TF_SRC / dt,
            "flops_per_step": flops, "mfu": flops / dt / peaks["bf16"],
            "mfu_formula": "transformer_flops / step s / bf16 peak",
            "params": n_params, "loss": run["final"],
            "grad_norm": run["grad_norm"],
            "max_memory_allocated": run["peak_mem"],
            "memory_reserved": run["reserved"],
            "launches_per_step": run["per_step"],
            "launches": run["launches"], "routes": run["routes"],
            "eager_step_ms": eager_ms,
            "dense_masked_attention_ms": dense_ms,
            "dense_masked_attention_share": dense_ms / (dt * 1e3),
            "dense_masked_attention_what":
                "the decoder's 6 masked self-attentions (dense route, "
                "mask added to f32 logits), forward and backward, timed "
                "alone by graph replay",
            "profile": profile}, model


def transformer_decode(model, dev, dtype, steps=32):
    """Incremental decoding at full width in eval: the encoder once
    (K1 forward at [B, 384, 8, 64], 6 launches), then `steps` greedy
    steps through TransformerDecoder with gen_cache (each step's input
    embedded at its position); each step's logits against the full
    decoder's at that position over the same tokens, within 2e-2 x
    max(1, |ref|) in bf16 and 1e-4 x max(1, |ref|) in f32."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa
    tol = 1e-4 if dtype == "float32" else 2e-2
    b = TF_B if dtype == "bfloat16" else 2
    src = transformer_batch(b, SEED + 25)[0]
    model.eval()
    dec = model.transformer.decoder
    with torch.no_grad():
        before = dict(fa.launches)
        memory = model.encode(src)
        torch.cuda.synchronize()
        enc_k1 = fa.launches["fwd"] - before["fwd"]
        check(enc_k1 == TF_LAYERS, f"transformer decode: the encoder "
                                   f"launched K1 {enc_k1} times")
        tokens = pt.zeros([b, 1], dtype="int32")
        cache = dec.gen_cache(memory)
        step_logits = []
        t0 = time.perf_counter()
        for t in range(steps):
            x = model.embed(model.tgt_embedding, tokens)[:, t:t + 1]
            out, cache = dec(x, memory, cache=cache)
            logits = model.head(out)[:, 0]
            step_logits.append(logits._data.float())
            nxt = pt.argmax(logits, axis=-1).astype("int32")
            tokens = pt.concat([tokens, nxt.unsqueeze(-1)], axis=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        inp = tokens[:, :steps]
        full = model.head(dec(model.embed(model.tgt_embedding, inp), memory,
                              tgt_mask=pt.triu(pt.full(
                                  [steps, steps], float("-inf")),
                                  diagonal=1)))._data.float()
    model.train()
    got = torch.stack(step_logits, dim=1)
    check(bool(torch.isfinite(got).all()), "transformer decode: non-finite "
                                           "logits")
    err = (got - full).abs()
    bound = tol * torch.clamp(full.abs(), min=1.0)
    check(bool((err <= bound).all()),
          f"transformer decode {dtype}: step logits differ from the full "
          f"decoder's by {err.max().item()} (tolerance {tol} x max(1, "
          f"|ref|))")
    return {"dtype": dtype, "batch": b, "steps": steps,
            "max_abs_err": err.max().item(), "tolerance": tol,
            "encoder_k1_launches": enc_k1, "host_ms_per_step": step_ms}


def beam_cell(P, vocab, emb, hid, seed, eos):
    """A small recurrent cell Layer of package P for beam search: an
    embedding, h' = tanh(x Wx + h Wh), logits = head(h')."""
    import numpy as np
    nn = P.nn

    class Cell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, emb)
            self.wx = nn.Linear(emb, hid)
            self.wh = nn.Linear(hid, hid, bias_attr=False)
            self.head = nn.Linear(hid, vocab)

        def forward(self, x, h):
            h2 = P.tanh(self.wx(x) + self.wh(h))
            return h2, h2

    cell = Cell()
    r = np.random.RandomState(seed)
    # a contracting recurrence (the Wh product's gain about 0.5), so the
    # two devices' rounding does not grow from step to step; logits of
    # a few units, and <eos> raised so that some beams finish
    scale = {"embedding.weight": 1.0, "wx.weight": emb ** -0.5,
             "wx.bias": 0.1, "wh.weight": 0.25 * hid ** -0.5,
             "head.weight": 2.0 * hid ** -0.5, "head.bias": 0.5}
    state = {k: (r.randn(*v.shape) * scale[k]).astype("f4")
             for k, v in cell.state_dict().items()}
    state["head.bias"][eos] += 3.5
    cell.set_state_dict(state)
    return cell


def beam_margins(step_logits, b, k, eos):
    """The beam rules of `dynamic_decode` replayed in f64 over the
    logits one run recorded: per batch row, the smallest gap between
    adjacent candidates among each step's top k + 1 scores and between
    adjacent final length-normalised scores (a gap under the tolerance
    is a near tie, where the two devices may rank differently)."""
    import torch
    neg = -1e9
    log_probs = torch.full((b, k), neg, dtype=torch.float64)
    log_probs[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool)
    lengths = torch.zeros((b, k), dtype=torch.int64)
    margin = torch.full((b,), float("inf"), dtype=torch.float64)
    for logits in step_logits:
        logp = torch.log_softmax(logits.double().reshape(b, k, -1), -1)
        v = logp.shape[-1]
        eos_only = torch.full((v,), neg, dtype=torch.float64)
        eos_only[eos] = 0.0
        logp = torch.where(finished[..., None], eos_only, logp)
        top, idx = torch.topk((log_probs[..., None] + logp).reshape(b, -1),
                              k + 1, dim=1)
        margin = torch.minimum(margin, (top[:, :-1] - top[:, 1:]).min(1)
                               .values)
        parent = torch.div(idx[:, :k], v, rounding_mode="floor")
        token = idx[:, :k] % v
        was_fin = torch.gather(finished, 1, parent)
        prev = torch.gather(lengths, 1, parent)
        finished = was_fin | (token == eos)
        lengths = torch.where(was_fin, prev, prev + 1)
        log_probs = top[:, :k]
    norm = torch.sort(log_probs / torch.clamp(lengths, min=1), 1,
                      descending=True).values
    return torch.minimum(margin, (norm[:, :-1] - norm[:, 1:]).min(1).values)


def beam_decode(pt, cell, embed, head, h0, beam, steps, eos, start,
                recorded=None):
    """BeamSearchDecoder + dynamic_decode over (cell, embed, head) from
    the initial states h0, every step's logits appended to `recorded`
    when it is a list. Returns (ids, lengths, ms)."""
    from paddle_tpu_torch.framework.tensor import unwrap

    def out_fn(out):
        logits = head(out)
        if recorded is not None:
            recorded.append(unwrap(logits).detach().cpu().clone())
        return logits
    decoder = pt.nn.BeamSearchDecoder(cell, start, eos, beam,
                                      embedding_fn=embed, output_fn=out_fn)
    t0 = time.perf_counter()
    ids, lens = pt.nn.dynamic_decode(decoder, inits=h0, max_step_num=steps)
    ids, lens = ids.numpy(), lens.numpy()
    return ids, lens, (time.perf_counter() - t0) * 1e3


def beam_rows_differ(a, b):
    """The batch rows whose ids or lengths differ between two runs'
    (ids, lengths)."""
    import numpy as np
    return [r for r in range(a[0].shape[0])
            if not (np.array_equal(a[0][r], b[0][r])
                    and np.array_equal(a[1][r], b[1][r]))]


def beam_weights_f64(vocab, emb, hid, gain, seed, eos):
    """f64 numpy weights of `beam_cell`'s recurrence, with Wh's entries of
    std gain / (2 sqrt(hid)): a Gaussian matrix's gain is then about
    `gain`."""
    import numpy as np
    r = np.random.RandomState(seed)
    w = {"emb": r.randn(vocab, emb), "wx": r.randn(emb, hid) * emb ** -0.5,
         "bx": r.randn(hid) * 0.1,
         "wh": r.randn(hid, hid) * gain / (2 * hid ** 0.5),
         "head": r.randn(hid, vocab) * 2.0 * hid ** -0.5,
         "hb": r.randn(vocab) * 0.5}
    w["hb"][eos] += 3.5
    return w


def beam_cell_f64(weights, dev):
    """`beam_cell`'s recurrence, h' = tanh(x Wx + b + h Wh) and logits =
    h' W + c, as functions over f64 torch copies of `weights` on `dev`
    (the port's Layers narrow f64 to f32, as the JAX package's do).
    Returns (cell, embedding_fn, output_fn)."""
    import torch
    from paddle_tpu_torch.framework.tensor import unwrap
    w = {k: torch.tensor(v, dtype=torch.float64, device=dev)
         for k, v in weights.items()}

    def cell(x, h):
        h2 = torch.tanh(unwrap(x) @ w["wx"] + w["bx"] + unwrap(h) @ w["wh"])
        return h2, h2
    return (cell, lambda t: w["emb"][unwrap(t).long()],
            lambda out: unwrap(out) @ w["head"] + w["hb"])


def transformer_beam(dev, beam=4, batch=64, steps=64, emb=256, hid=256,
                     tol=1e-3, tol_f64=1e-9):
    """BeamSearchDecoder + dynamic_decode (beam 4, batch 64, 64 steps,
    vocabulary 37000) over a small cell Layer (`beam_cell`), on the card
    and on the CPU from the same weights and initial states: the ids and
    lengths equal, except in rows where the CPU run's scores hold a near
    tie (`beam_margins` under `tol`), as the serving parity allows a
    top-2 margin under its tolerance. `beam_cell` contracts; the same
    recurrence with a gain of about 4 (`beam_cell_f64`, which does not
    contract) is held the same way in f64 (near ties under `tol_f64`).
    Beside them, not a check: at a gain of about 16, the rows of one f64
    CPU run that a 1e-13 relative change of the initial states alters
    (at batch 16), the witness that such a recurrence turns rounding
    into other beams on any one device."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    eos, start = 2, 1
    h0 = np.random.RandomState(SEED + 26).randn(batch, hid).astype("f4")
    res = {}
    for place in ("gpu:0", "cpu"):
        pt.set_device(place)
        cell = beam_cell(pt, TF_VOCAB, emb, hid, SEED + 27, eos)
        rec = [] if place == "cpu" else None
        res[place] = beam_decode(
            pt, lambda x, h, cell=cell: cell(x, h), cell.embedding,
            cell.head, pt.to_tensor(h0), beam, steps, eos, start, rec) \
            + (rec,)
    pt.set_device("gpu:0")
    (gi, gl, g_ms, _), (ci, cl, c_ms, rec) = res["gpu:0"], res["cpu"]
    check(gi.shape == (batch, steps, beam) and gl.shape == (batch, beam),
          f"beam search: shapes {gi.shape} {gl.shape}")
    differ = beam_rows_differ((gi, gl), (ci, cl))
    margins = beam_margins(rec, batch, beam, eos)
    for r in differ:
        check(float(margins[r]) < tol,
              f"beam search: row {r} differs between the card and the CPU "
              f"with no near tie (smallest margin {float(margins[r])})")

    cpu = torch.device("cpu")
    h64 = np.random.RandomState(SEED + 26).randn(batch, hid)
    w4 = beam_weights_f64(TF_VOCAB, emb, hid, 4.0, SEED + 27, eos)
    rec64 = []
    g64 = beam_decode(pt, *beam_cell_f64(w4, dev),
                      torch.tensor(h64, device=dev), beam, steps, eos,
                      start)
    c64 = beam_decode(pt, *beam_cell_f64(w4, cpu), torch.tensor(h64),
                      beam, steps, eos, start, rec64)
    differ64 = beam_rows_differ(g64, c64)
    margins64 = beam_margins(rec64, batch, beam, eos)
    for r in differ64:
        check(float(margins64[r]) < tol_f64,
              f"beam search f64, gain 4: row {r} differs between the card "
              f"and the CPU with no near tie (smallest margin "
              f"{float(margins64[r])})")
    w16 = beam_weights_f64(TF_VOCAB, emb, hid, 16.0, SEED + 27, eos)
    runs16 = [beam_decode(pt, *beam_cell_f64(w16, cpu),
                          torch.tensor(h64[:16] * (1 + eps)), beam, steps,
                          eos, start) for eps in (0.0, 1e-13)]
    return {"beam": beam, "batch": batch, "steps": steps,
            "vocab": TF_VOCAB, "rows_equal": batch - len(differ),
            "rows_near_tie": len(differ), "tolerance": tol,
            "finished_beams": int((gl < steps).sum()),
            "card_ms": g_ms, "cpu_ms": c_ms,
            "f64_gain4": {"rows_equal": batch - len(differ64),
                          "rows_near_tie": len(differ64),
                          "tolerance": tol_f64,
                          "finished_beams": int((g64[1] < steps).sum()),
                          "card_ms": g64[2], "cpu_ms": c64[2]},
            "f64_gain16_cpu_rows_altered_by_1e-13": {
                "rows": 16, "altered": len(beam_rows_differ(*runs16))}}


def transformer_phase(dev, smi, peaks):
    """Transformer-base (`layer_transformer`) on the card: the f32
    parity (`transformer_parity`), dropout drawn afresh on every replay
    (`transformer_dropout`), the timed bf16 step at batch 64 (the main
    path: `transformer_timed`), incremental decoding in bf16 at batch 64
    and in f32 at batch 2 (`transformer_decode`), and beam search on the
    card against the CPU (`transformer_beam`). Returns the timed step's
    launches of K1-K3, dd and Adam."""
    import torch
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device("gpu:0")
    try:
        parity = transformer_parity(dev)
        torch.cuda.empty_cache()
        dropout = transformer_dropout(dev)
        torch.cuda.empty_cache()
        timed, model = transformer_timed(dev, peaks)
        decode_bf16 = transformer_decode(model, dev, "bfloat16")
        del model
        torch.cuda.empty_cache()
        f32 = transformer_model(0.0)
        decode_f32 = transformer_decode(f32, dev, "float32")
        del f32
        torch.cuda.empty_cache()
        beam = transformer_beam(dev)
    finally:
        pt.set_device(old)
    emit("transformer", nvidia_smi=smi, parity=parity, dropout=dropout,
         timed=timed, decode={"bfloat16": decode_bf16,
                              "float32": decode_f32}, beam_search=beam)
    return timed["launches"]


# ---------------------------------------------------------------------------
# train: GPT-2 small at bench.py's GPU shapes, bf16, through TrainStep
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# bert: BERT-base pretraining as one graph a step; amp: auto_cast on GPT
# ---------------------------------------------------------------------------

def bert_batch(cfg, b, s, seed, dev):
    """ids [B, S], 15% MLM labels (-100 elsewhere) and NSP labels, seeded
    numpy draws as `scripts/bench_sweep.py` makes them, int64 on the
    card."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    mlm = np.where(rng.rand(b, s) < 0.15,
                   rng.randint(0, cfg.vocab_size, (b, s)), -100)
    nsp = rng.randint(0, 2, (b,))
    return tuple(torch.tensor(a.astype("int64"), device=dev)
                 for a in (ids, mlm, nsp))


def bert_parity(dev, layers=2, b=2):
    """f32 BERT at full width and `layers` layers (batch 2 x 512) through
    the kernels (2 launches each of K1, dd, K2 and K3) against
    `kernel="plain"`: the loss within 1e-5 relative, every gradient
    within 1e-4 x max(1, max|g|); then the graphed TrainStep (AdamW)
    against the eager one on a twin from the same seed over 3 steps
    (eager, capture + replay, replay), within 1e-6 x max(1, |eager|)."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import (BertForPretraining, bert_base,
                                      bert_pretrain_loss)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base(max_seq_len=BERT_S, dropout=0.0, attn_dropout=0.0)
    cfg.num_layers = layers
    model = BertForPretraining(cfg, device=dev, seed=SEED).train()
    ids, mlm, nsp = bert_batch(cfg, b, BERT_S, SEED + 30, dev)

    def loss_and_grads(kernel):
        with fa.kernel_scope(kernel):
            loss = bert_pretrain_loss(*model(ids), mlm, nsp)
            loss.backward()
        torch.cuda.synchronize()
        grads = {k: g.detach().clone() for k, g in leaf_grads(model).items()}
        model.clear_gradients()
        return float(loss), grads
    ref_loss, ref_g = loss_and_grads("plain")
    zero_counts()
    loss, grads = loss_and_grads("cuda")
    launches = dict(fa.launches)
    check(launches == {k: layers for k in ("fwd", "dkv", "dq", "dd")},
          f"bert f32: flash launches {launches}")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    check(rel <= 1e-5, f"bert f32: loss {loss} against plain {ref_loss}")
    worst = 0.0
    for k, want in ref_g.items():
        scale = max(1.0, float(want.abs().max()))
        err = float((grads[k] - want).abs().max())
        check(err <= 1e-4 * scale, f"bert f32: {k} gradient error {err} "
                                   f"> 1e-4 x {scale}")
        worst = max(worst, err / scale)
    del ref_g, grads
    twin = BertForPretraining(cfg, device=dev, seed=SEED)
    check(all(torch.equal(a._data, b_._data) for a, b_ in zip(
        model.parameters(), twin.parameters())),
        "bert twin: one seed gave two sets of weights")
    graphed = TrainStep(model, bert_pretrain_loss,
                        AdamW(learning_rate=1e-4,
                              parameters=model.parameters()))
    eager = TrainStep(twin, bert_pretrain_loss,
                      AdamW(learning_rate=1e-4,
                            parameters=twin.parameters()),
                      cuda_graph=False)
    pairs = []
    for _ in range(3):
        pairs.append((float(graphed(ids, (mlm, nsp))),
                      float(eager(ids, (mlm, nsp)))))
        g, e = pairs[-1]
        check(abs(g - e) <= 1e-6 * max(1.0, abs(e)),
              f"bert f32: graphed losses {pairs} against eager")
    (graph,) = graphed.graphs.values()
    want = {f"flash_attention.{k}": layers for k in ("fwd", "dkv", "dq",
                                                     "dd")}
    want["optimizer.adam"] = 1
    check(graph is not None and graph.launches == want,
          f"bert f32: the graph holds {graph and graph.launches}")
    out = {"layers": layers, "batch": b, "seq": BERT_S, "dtype": "float32",
           "loss": loss, "plain_loss": ref_loss, "loss_rel": rel,
           "max_grad_err_over_scale": worst, "launches": launches,
           "graphed_vs_eager_losses": pairs}
    del model, twin, graphed, eager
    return out


def bert_timed(dev, peaks, steps=10):
    """BERT-base in bf16 at batch 16 x 512 with AdamW(1e-4), by bench.py's
    recipe (`graphed_train`: the counts set to 0, 3 warm-up calls,
    `steps` timed replays; 12 launches each of K1, dd, K2 and K3 and 1
    Adam launch in the graph, every attention on the kernel route). Step
    ms, samples/s, tokens/s, MFU (6 x params x tokens/s over the bf16
    peak, as `scripts/bench_sweep.py` counts), peak memory, the idle
    share and the device time by kernel group; then the eager step."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import (BertForPretraining, bert_base,
                                      bert_pretrain_loss)
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    cfg = bert_base(max_seq_len=BERT_S, dropout=0.0, attn_dropout=0.0)
    model = BertForPretraining(cfg, device=dev, dtype=torch.bfloat16,
                               seed=SEED)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids, mlm, nsp = bert_batch(cfg, BERT_B, BERT_S, SEED + 31, dev)
    torch.cuda.reset_peak_memory_stats()
    run = graphed_train(model, bert_pretrain_loss, opt, ids, "bert", steps,
                        labels=(mlm, nsp), groups=STEP_GROUPS)
    dt = run["dt"]
    eager = TrainStep(model, bert_pretrain_loss, opt, cuda_graph=False)
    for _ in range(2):
        float(eager(ids, (mlm, nsp)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        loss = eager(ids, (mlm, nsp))
    float(loss)
    eager_ms = (time.perf_counter() - t0) * 1e3 / 5
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = BERT_B * BERT_S / dt
    profile = run["profile"]
    if isinstance(profile, dict):
        profile["top_kernels"] = profile["top_kernels"][:16]
    out = {"model": "BERT-base (12 layers, 768 wide, 12 heads of 64, FFN "
                    "3072, vocab 30522)",
           "dtype": "bfloat16", "batch": BERT_B, "seq": BERT_S,
           "steps": steps, "step": "one CUDA graph replay per call",
           "step_ms": dt * 1e3, "samples_per_s": BERT_B / dt,
           "tokens_per_s": tokens_per_s, "params": n_params,
           "mfu": 6 * n_params * tokens_per_s / peaks["bf16"],
           "mfu_formula": "6 x params x tokens/s / bf16 peak",
           "loss": run["final"], "grad_norm": run["grad_norm"],
           "max_memory_allocated": run["peak_mem"],
           "memory_reserved": run["reserved"],
           "launches_per_step": run["per_step"],
           "launches": run["launches"], "routes": run["routes"],
           "eager_step_ms": eager_ms, "profile": profile}
    del model, opt, run, eager
    return out


def bert_phase(dev, smi, peaks):
    """BERT-base pretraining (`bert_timed`) after the f32 parity of the
    kernels against plain at 2 layers (`bert_parity`). Returns the
    kernels' launches in the timed run."""
    parity = bert_parity(dev)
    timed = bert_timed(dev, peaks)
    emit("bert", parity=parity, **timed, nvidia_smi=smi)
    launches = dict(timed["launches"])
    return launches


def amp_cpu_parity(dev, steps=3, layers=2, b=2):
    """GPT-2 small's width at `layers` layers, f32 weights from one seed,
    `steps` AdamW steps under auto_cast + GradScaler on the card (K1-K3
    in bf16) and on the CPU (the plain kernels): each step's loss within
    2e-2 relative. Returns the losses and the CPU's wall seconds."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW
    ids = np.random.RandomState(SEED + 40).randint(
        0, TRAIN_VOCAB, (b, TRAIN_S)).astype("int64")
    losses, walls = {}, {}
    for where in (dev, "cpu"):
        model = GPTForPretraining(train_config(num_layers=layers),
                                  device=where, seed=SEED).train()
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        scaler = amp.GradScaler()
        x = torch.tensor(ids, device=where)
        t0 = time.perf_counter()
        got = []
        for _ in range(steps):
            with amp.auto_cast():
                loss = gpt_pretrain_loss(model(x), x)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            got.append(float(loss))
        walls[str(where)] = time.perf_counter() - t0
        losses[str(where)] = got
        del model, opt
    card, cpu = losses[str(dev)], losses["cpu"]
    for a, c in zip(card, cpu):
        check(abs(a - c) <= 2e-2 * abs(c),
              f"amp: card losses {card} against the CPU's {cpu}")
    return {"layers": layers, "batch": b, "seq": TRAIN_S, "steps": steps,
            "card_losses": card, "cpu_losses": cpu, "wall_s": walls}


def amp_phase(dev, smi):
    """The f32 GPT-2 small Layer (GPTForPretraining, f32 weights) at 8 x
    1024 under `amp.auto_cast()` (bf16): 3 eager steps with a
    GradScaler, the counts set to 0 before them (12 launches each of K1,
    dd, K2 and K3 a step, every K1 input bf16), timed; then the same
    model in a graphed TrainStep entered under auto_cast (the capture
    keeps the casts; bf16 needs no loss scaling, and the scaler's host
    read of its inf check cannot sit in a graph): 12 launches each and 1
    Adam a step, timed beside the bf16 model's train phase;
    `amp_cpu_parity`; and `auto_cast(dtype="float16")` into attention
    raises the kernel wrapper's TypeError."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForPretraining(train_config(), device=dev, seed=SEED)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler()
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, (TRAIN_B, TRAIN_S)).astype("int64"), device=dev)
    dtypes = []
    core = fa._FlashCore.apply

    def spy(q, *args):
        dtypes.append(q.dtype)
        return core(q, *args)
    fa._FlashCore.apply = spy
    try:
        zero_counts()
        losses, step_ms = [], []
        for _ in range(EAGER_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast():
                loss = gpt_pretrain_loss(model(ids), ids)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        eager_launches = dict(fa.launches)
        check(eager_launches == {k: LAYERS * EAGER_STEPS
                                 for k in ("fwd", "dkv", "dq", "dd")},
              f"amp eager: flash launches {eager_launches}")
        check(dtypes == [torch.bfloat16] * LAYERS * EAGER_STEPS,
              f"amp eager: K1 inputs {set(dtypes)}")
        check(all(np.isfinite(losses)) and scaler.state_dict()["scale"]
              == 2.0 ** 15, f"amp eager: losses {losses}, scaler "
                            f"{scaler.state_dict()}")
        dtypes.clear()
        graph_model = GPTForPretraining(train_config(), device=dev,
                                        seed=SEED)
        graph_opt = AdamW(learning_rate=1e-4,
                          parameters=graph_model.parameters())
        with amp.auto_cast():
            run = graphed_train(graph_model, gpt_pretrain_loss, graph_opt,
                                ids, "amp TrainStep", 10)
        check(dtypes and set(dtypes) == {torch.bfloat16},
              f"amp TrainStep: K1 inputs {set(dtypes)}")
    finally:
        fa._FlashCore.apply = core
    parity = amp_cpu_parity(dev)
    refused = None
    try:
        with torch.no_grad(), amp.auto_cast(dtype="float16"):
            model(ids[:1])
    except TypeError as exc:
        refused = str(exc).split("\n")[0]
    check(refused is not None and "float32 or bfloat16" in refused,
          f"amp float16: attention did not refuse f16 ({refused})")
    profile = run["profile"]
    if isinstance(profile, dict):
        profile["top_kernels"] = profile["top_kernels"][:8]
    tokens_per_s = TRAIN_B * TRAIN_S / run["dt"]
    emit("amp", model="gpt2_small (f32 weights)", autocast="bfloat16",
         batch=TRAIN_B, seq=TRAIN_S, eager_losses=losses,
         eager_step_ms=step_ms, eager_launches=eager_launches,
         scaler=scaler.state_dict(), graphed_step_ms=run["dt"] * 1e3,
         graphed_tokens_per_s=tokens_per_s, graphed_loss=run["final"],
         launches_per_step=run["per_step"], launches=run["launches"],
         max_memory_allocated=run["peak_mem"],
         memory_reserved=run["reserved"], cpu_parity=parity,
         float16_refused=refused, profile=profile, nvidia_smi=smi)
    launches = dict(run["launches"])
    del model, graph_model, opt, graph_opt, run
    return launches


# ---------------------------------------------------------------- hapi
# BASELINE.json configs[0] (.claude/skills/verify/SKILL.md flow 1): LeNet
# on MNIST through hapi, batch 64, 2 epochs (the synthetic MNIST's 4096
# training samples: 64 steps an epoch); the resume cut and the CPU's
# losses
LENET_BATCH, LENET_EPOCHS = 64, 2
RESUME_AT, RESUME_STEPS, CPU_LOSSES = 10, 10, 20
# GPT-2 small through Model.fit: timed fits of this many steps
GPT_FIT_STEPS = 10
# BASELINE.json configs[1] (`scripts/bench_sweep.py:130-155`): ResNet-50,
# 1000 classes, bf16, Momentum(0.1, 0.9), batch 128; the image tree holds
# RN_STEPS batches of uint8 HWC images of 256-384 pixels a side
RN_BATCH, RN_CLASSES, RN_STEPS = 128, 1000, 16
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]
# the ResNet step's device time by group (first match wins): cuDNN's
# layout transposes, BatchNorm (cuDNN's bn_* or torch's batch_norm_*),
# the convolutions' implicit-gemm kernels, the optimizer's foreach
# kernels, pooling, plain gemm kernels (cuDNN runs some 1x1 convolutions
# as gemms; the classifier), and the rest
RN_GROUPS = (
    ("layout transposes (NCHW <-> NHWC)", ("nchwtonhwc", "nhwctonchw")),
    ("BatchNorm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm", "welford")),
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv", "implicit")),
    ("optimizer (Momentum, foreach)", ("multi_tensor", "foreach")),
    ("pooling", ("pool",)),
    ("gemms (1x1 convolutions, the classifier)",
     ("gemm", "nvjet", "cutlass", "xmma")))
RN_OTHER = "elementwise (ReLU, residual adds, casts, loss, copies)"


def place_name(dev):
    """The framework's place name of a torch device."""
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


@contextlib.contextmanager
def on_place(dev):
    """Run a block with the framework's current place on `dev` (the
    default place of a DataLoader and of `to_tensor`), then put the old
    place back."""
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device(place_name(dev))
    try:
        yield
    finally:
        pt.set_device(old)


def lenet_model(dev):
    """A hapi Model of LeNet on `dev`, its weights drawn on the CPU from
    SEED (the same on every device), with Adam, cross entropy and
    Accuracy: SKILL.md flow 1's recipe."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.state import host_init_ctx
    from paddle_tpu_torch.vision.models import LeNet
    with host_init_ctx(SEED):
        net = LeNet()
    net.to(device=place_name(dev))
    model = pt.Model(net)
    model.prepare(pt.optimizer.Adam(parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    return model


def lenet_fit(model, data, dev, **kw):
    """`model.fit` over `data` at batch 64 with the numpy seed set (the
    shuffle order) and the current place on `dev`."""
    import numpy as np
    with on_place(dev):
        np.random.seed(SEED)
        return model.fit(data, batch_size=LENET_BATCH, verbose=0, **kw)


def graph_of(step, name):
    """A TrainStep's one captured graph."""
    graphs = list(step.graphs.values())
    check(len(graphs) == 1 and graphs[0] is not None,
          f"{name}: {len(graphs)} graphs, {graphs}")
    return graphs[0]


def hapi_lenet(dev):
    """SKILL.md flow 1 on the card: LeNet fit on the synthetic MNIST (2
    epochs at batch 64, one graph replay a step after the eager first
    call and the capture), evaluate (test accuracy above 0.7), predict
    (its argmax accuracy equal to evaluate's), a save/load round trip
    whose evaluate is equal, a save at step 10 resumed by load_latest and
    fit(resume=True) against the same steps run without a stop (within
    1e-6 x max(1, |loss|)), and the first 20 losses against the same fit
    on the CPU (1e-4 relative; TF32 is off)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from paddle_tpu_torch.vision.datasets import MNIST
    train, test = MNIST(mode="train"), MNIST(mode="test")
    model = lenet_model(dev)
    t0 = time.perf_counter()
    hist = lenet_fit(model, train, dev, epochs=LENET_EPOCHS)
    fit_s = time.perf_counter() - t0
    losses = hist["loss"]
    steps = LENET_EPOCHS * len(train) // LENET_BATCH
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"lenet: {len(losses)} losses of {steps}, finite: "
          f"{np.isfinite(losses).all()}")
    graph = graph_of(model._train_step, "lenet")
    check(graph.replays == steps - 1,
          f"lenet: {graph.replays} replays in {steps} steps")
    t0 = time.perf_counter()
    ev = model.evaluate(test, batch_size=LENET_BATCH, verbose=0)
    eval_s = time.perf_counter() - t0
    check(ev["acc"] > 0.7, f"lenet: test accuracy {ev['acc']}")
    (pred,) = model.predict(test, batch_size=LENET_BATCH, stack_outputs=True)
    check(pred.shape == (len(test), 10) and np.isfinite(pred).all(),
          f"lenet: predict gave {pred.shape}")
    pred_acc = float((pred.argmax(1) == test.labels).mean())
    check(abs(pred_acc - float(ev["acc"])) <= 1e-6,
          f"lenet: predict's accuracy {pred_acc}, evaluate's {ev['acc']}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    try:
        model.save(os.path.join(tmp, "saved", "lenet"))
        again = lenet_model(dev)
        again.load(os.path.join(tmp, "saved", "lenet"))
        ev2 = again.evaluate(test, batch_size=LENET_BATCH, verbose=0)
        check(ev2 == ev, f"lenet: evaluate after load {ev2}, before {ev}")
        total = RESUME_AT + RESUME_STEPS
        full = lenet_fit(lenet_model(dev), train, dev, epochs=1,
                         num_iters=total)["loss"]
        cut = lenet_fit(lenet_model(dev), train, dev, epochs=1,
                        num_iters=RESUME_AT, save_dir=os.path.join(
                            tmp, "ckpt"), save_steps=RESUME_AT)["loss"]
        # cuDNN's backward may sum in another order from run to run: two
        # fits from one seed agree within the graphed-vs-eager gate
        rerun_err = max(abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(cut, full))
        check(rerun_err <= 1e-6,
              f"lenet: two fits from one seed differ: {cut} {full}")
        resumed = lenet_model(dev)
        prefix = resumed.load_latest(os.path.join(tmp, "ckpt"))
        check(prefix is not None and prefix.endswith(f"step{RESUME_AT}"),
              f"lenet: load_latest gave {prefix}")
        after = lenet_fit(resumed, train, dev, epochs=1,
                          num_iters=RESUME_STEPS, resume=True)["loss"]
        resume_err = max(abs(a - b) / max(1.0, abs(b))
                         for a, b in zip(after, full[RESUME_AT:]))
        check(len(after) == RESUME_STEPS and resume_err <= 1e-6,
              f"lenet: resumed losses {after} against {full[RESUME_AT:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cpu = torch.device("cpu")
    cpu_losses = lenet_fit(lenet_model(cpu), train, cpu, epochs=1,
                           num_iters=CPU_LOSSES)["loss"]
    cpu_err = max(abs(a - b) / abs(b)
                  for a, b in zip(losses[:CPU_LOSSES], cpu_losses))
    check(cpu_err <= 1e-4, f"lenet: card losses {losses[:CPU_LOSSES]} "
                           f"against the CPU's {cpu_losses}")
    return {"model": "LeNet", "data": "synthetic MNIST (4096 train, 4096 "
                                      "test)",
            "batch": LENET_BATCH, "epochs": LENET_EPOCHS, "steps": steps,
            "fit_s": fit_s, "fit_ms_per_step": fit_s * 1e3 / steps,
            "first_loss": losses[0], "last_loss": losses[-1],
            "test": plain_logs(ev), "evaluate_s": eval_s,
            "predict_acc": pred_acc,
            "launches_per_step": dict(graph.launches),
            "resume": {"at": RESUME_AT, "steps": RESUME_STEPS,
                       "max_rel_err": resume_err,
                       "rerun_max_rel_err": rerun_err},
            "cpu_first_losses_max_rel_err": cpu_err,
            "data_wait_s_mean": float(np.mean(hist["data_wait_s"]))}


def hapi_gpt(dev, peaks):
    """GPT-2 small (`nlp.GPTForPretraining`, a Layer) at bench.py's shapes
    (bf16, batch 8 x 1024, vocab 32768, AdamW(1e-4), `gpt_pretrain_loss`)
    through `Model.fit` on a DataLoader over a seeded TensorDataset of
    ids. The counts set to 0 before the first fit: 3 warm-up steps
    (eager, capture, replay), then in turns `fit` over 10 batches and the
    bare graphed TrainStep (`model._train_step`) fed the same batches
    staged on the card, twice each. Every fit step must be one replay of
    the one graph (12 launches each of K1, K2, K3 and dd and 1 Adam
    launch) and launch nothing from Python. The gap between the two is
    hapi's host work (the loss and metric reads, the callbacks) and the
    loader's."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    # the main path's run, from building the model to the last fit:
    # every count is 0 before it and read after
    zero_counts()
    net = GPTForPretraining(train_config(), device=dev, dtype=torch.bfloat16,
                            seed=SEED)
    model = pt.Model(net)
    model.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters()),
                  gpt_pretrain_loss)
    ids = np.random.RandomState(SEED + 50).randint(
        0, TRAIN_VOCAB, (TRAIN_B * GPT_FIT_STEPS, TRAIN_S)).astype("int64")
    loader = DataLoader(TensorDataset([ids, ids]), batch_size=TRAIN_B)
    warm = model.fit(loader, epochs=1, num_iters=3, verbose=0)["loss"]
    step = model._train_step
    graph = graph_of(step, "hapi gpt")
    per_step = dict(graph.launches)
    want = {f"flash_attention.{k}": LAYERS for k in ("fwd", "dkv", "dq",
                                                     "dd")}
    want["optimizer.adam"] = 1
    check(per_step == want, f"hapi gpt: the graph holds {per_step}, not "
                            f"{want}")
    staged = [batch for batch in loader]
    torch.cuda.synchronize()
    counts0, replays0 = kernels.launch_counts(), graph.replays
    fit_ms, bare_ms, losses = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = model.fit(loader, epochs=1, verbose=0)
        fit_ms.append((time.perf_counter() - t0) * 1e3 / GPT_FIT_STEPS)
        losses += hist["loss"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in staged:
            loss = step(x, y)
        losses.append(float(loss))
        bare_ms.append((time.perf_counter() - t0) * 1e3 / GPT_FIT_STEPS)
    timed = graph.replays - replays0
    check(timed == 4 * GPT_FIT_STEPS,
          f"hapi gpt: {timed} replays in {4 * GPT_FIT_STEPS} steps")
    check(kernels.launch_counts() == counts0,
          "hapi gpt: a timed step launched kernels from Python")
    check(np.isfinite(losses).all() and np.isfinite(warm).all(),
          f"hapi gpt: losses {warm} {losses}")
    n_params = sum(p.numel() for p in net.parameters())
    tokens = TRAIN_B * TRAIN_S
    fit, bare = float(np.mean(fit_ms)), float(np.mean(bare_ms))
    out = {"model": "GPT-2 small (GPTForPretraining, an nn.Layer)",
           "dtype": "bfloat16", "batch": TRAIN_B, "seq": TRAIN_S,
           "vocab": TRAIN_VOCAB, "optimizer": "AdamW(1e-4)",
           "steps_timed": timed, "fit_step_ms": fit_ms,
           "bare_step_ms": bare_ms, "fit_vs_bare_ms": fit - bare,
           "fit_tokens_per_s": tokens * 1e3 / fit,
           "bare_tokens_per_s": tokens * 1e3 / bare,
           "fit_mfu": 6 * n_params * tokens * 1e3 / fit / peaks["bf16"],
           "losses": losses, "launches_per_step": per_step,
           "launches": {k.split(".")[1]: n * timed
                        for k, n in per_step.items()}}
    del model, net, step, graph, staged
    return out


def hapi_phase(dev, smi, peaks):
    """hapi on the card: SKILL.md flow 1 (`hapi_lenet`), then GPT-2 small
    through Model.fit (`hapi_gpt`). Returns the kernels' launches in the
    GPT fits."""
    lenet = hapi_lenet(dev)
    gpt = hapi_gpt(dev, peaks)
    emit("hapi", lenet=lenet, gpt=gpt, nvidia_smi=smi)
    return gpt["launches"]


# ---------------------------------------------------------------- resnet


def write_image_tree(root, n):
    """`n` seeded uint8 HWC images of 256-384 pixels a side, as .npy
    files in a class-per-subdirectory tree of RN_CLASSES classes (the
    layout DatasetFolder reads; ImageNet's train split is one)."""
    import numpy as np
    rng = np.random.RandomState(SEED + 60)
    labels = rng.randint(0, RN_CLASSES, n)
    for c in range(RN_CLASSES):
        os.makedirs(os.path.join(root, f"n{c:04d}"))
    for i in range(n):
        h, w = rng.randint(256, 385, 2)
        np.save(os.path.join(root, f"n{labels[i]:04d}", f"{i:05d}.npy"),
                rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


def bf16_input(net):
    """A Layer casting its input to bf16 before `net` (a bf16 model fed
    the loader's f32 images, as the sweep feeds bf16 ones)."""
    from paddle_tpu_torch import nn

    class BF16Input(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.net = inner

        def forward(self, x):
            return self.net(x.astype("bfloat16"))

    return BF16Input(net)


def conv_linear_macs(net, x):
    """Multiply-adds a forward of `x` takes in `net`'s Conv2D and Linear
    layers, counted from their output and weight shapes."""
    import numpy as np
    import paddle_tpu_torch as pt
    nn = pt.nn
    total = [0]

    def hook(layer, inputs, out):
        o, w = out.shape, layer.weight.shape
        if isinstance(layer, nn.Conv2D):    # [out, in / groups, kh, kw]
            total[0] += int(np.prod(o)) * w[1] * w[2] * w[3]
        else:                               # Linear: [in, out]
            total[0] += int(np.prod(o[:-1])) * w[0] * w[1]

    handles = [layer.register_forward_post_hook(hook)
               for layer in net.sublayers()
               if isinstance(layer, (nn.Conv2D, nn.Linear))]
    was_training = net.training
    net.eval()
    with pt.no_grad():
        net(x)
    net.train(was_training)
    for h in handles:
        h.remove()
    return total[0]


def step_clock():
    """A hapi callback stamping the host clock (`.stamps`) when fit
    starts and after every train step."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def on_train_begin(self, logs=None):
            self.stamps = [time.perf_counter()]

        def on_train_batch_end(self, step, logs=None):
            self.stamps.append(time.perf_counter())

    return StepClock()


def plain_logs(logs):
    """hapi logs (numpy scalars, lists of them) as JSON numbers."""
    return {k: [float(x) for x in v] if isinstance(v, (list, tuple))
            else float(v) for k, v in logs.items()}


def transform_ms(ds, images=64):
    """Host ms an image of each step of a DatasetFolder's loading, on one
    intra-op thread as a loader worker runs it: the .npy read, then each
    transform of its Compose on the previous one's output."""
    import numpy as np
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    steps = [("load", ds.loader)] + [(type(t).__name__, t)
                                     for t in ds.transform.transforms]
    spent = dict.fromkeys([name for name, _ in steps], 0.0)
    try:
        np.random.seed(SEED + 11)
        for path, _ in ds.samples[:images]:
            out = path
            for name, fn in steps:
                t0 = time.perf_counter()
                out = fn(out)
                spent[name] += time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    return {name: ms * 1e3 / images for name, ms in spent.items()}


def resnet_train(dev, peaks, root):
    """ResNet-50 bf16 at batch 128 through `Model.fit` on the image tree,
    read by DatasetFolder through the training transforms and a
    DataLoader of forked shared-memory workers (one per core but one),
    with Accuracy(top 1, top 5). 3 warm-up steps (eager, capture,
    replay), then in turns an epoch of `fit` (16 steps) and 16 steps of
    the bare graphed TrainStep on 4 batches staged on the card, twice
    each: images/s, step ms (from the third step of each fit), the
    data-wait share, MFU; the device time by kernel group from
    torch.profiler; peak memory; evaluate over the tree (the eval
    transforms) and the eval forward alone; the host ms an image of each
    loading step (`transform_ms`)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder
    from paddle_tpu_torch.vision.models import resnet50
    gc.collect()
    torch.cuda.empty_cache()
    workers = max(1, (os.cpu_count() or 2) - 1)
    train_ds = DatasetFolder(root, transform=T.Compose([
        T.RandomResizedCrop(224), T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
    loader = DataLoader(train_ds, batch_size=RN_BATCH, shuffle=True,
                        num_workers=workers, use_shared_memory=True,
                        drop_last=True)
    pt.seed(SEED)
    net = resnet50(num_classes=RN_CLASSES)
    net.to(dtype="bfloat16")
    macs = conv_linear_macs(net, pt.randn([1, 3, 224, 224]).astype(
        "bfloat16"))
    model = pt.Model(bf16_input(net))
    model.prepare(pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy(topk=(1, 5)))
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(SEED)
    t0 = time.perf_counter()
    warm = model.fit(loader, epochs=1, num_iters=3, verbose=0)["loss"]
    warm_s = time.perf_counter() - t0
    step = model._train_step
    graph = graph_of(step, "resnet")
    it = iter(loader)
    staged = [next(it) for _ in range(4)]
    it.close()
    flops = 2 * 3 * macs * RN_BATCH
    fits, bare_ms, losses = [], [], []
    for _ in range(2):
        stamps = step_clock()
        torch.cuda.synchronize()
        hist = model.fit(loader, epochs=1, verbose=0, callbacks=[stamps])
        gaps = np.diff(stamps.stamps)
        check(len(gaps) == RN_STEPS, f"resnet: {len(gaps)} fit steps")
        steady, waits = gaps[2:], np.asarray(hist["data_wait_s"][2:])
        fits.append({"epoch_images_per_s": RN_BATCH * RN_STEPS / float(
                         stamps.stamps[-1] - stamps.stamps[0]),
                     "step_ms": float(steady.mean() * 1e3),
                     "images_per_s": RN_BATCH / float(steady.mean()),
                     "data_wait_share": float(waits.sum() / steady.sum()),
                     "data_wait_ms_mean": float(waits.mean() * 1e3),
                     "first_step_ms": float(gaps[0] * 1e3)})
        losses += hist["loss"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RN_STEPS):
            x, y = staged[i % len(staged)]
            loss = step(x, y)[0]
        losses.append(float(loss))
        bare_ms.append((time.perf_counter() - t0) * 1e3 / RN_STEPS)
    peak_mem = torch.cuda.max_memory_allocated()
    check(np.isfinite(losses).all() and np.isfinite(warm).all(),
          f"resnet: losses {warm} {losses}")
    bare = float(np.mean(bare_ms))
    fit_ms = float(np.mean([f["step_ms"] for f in fits]))
    x, y = staged[0]
    profile = profile_steps(lambda a, b: step(a, b)[0], x, bare, labels=y,
                            categories=RN_GROUPS, other=RN_OTHER)
    if isinstance(profile, dict):
        del profile["kernel_calls_per_step"]
    eval_ds = DatasetFolder(root, transform=T.Compose([
        T.Resize(256), T.CenterCrop(224), T.ToTensor(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
    eval_loader = DataLoader(eval_ds, batch_size=RN_BATCH,
                             num_workers=workers, use_shared_memory=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = model.evaluate(eval_loader, verbose=0)
    eval_s = time.perf_counter() - t0
    model.network.eval()
    with pt.no_grad():
        fwd_ms = time_ms(lambda: model.network(x), 10)
    model.network.train()
    n_eval = len(eval_ds)
    host = {"train": transform_ms(train_ds), "eval": transform_ms(eval_ds)}
    return {"model": "ResNet-50 (1000 classes, NCHW)", "dtype": "bfloat16",
            "batch": RN_BATCH, "optimizer": "Momentum(0.1, 0.9)",
            "images": len(train_ds), "workers": workers,
            "host_cores": os.cpu_count(),
            "loader_host_ms_per_image": host,
            "warmup_s": warm_s, "fits": fits, "fit_step_ms": fit_ms,
            "fit_images_per_s": RN_BATCH * 1e3 / fit_ms,
            "bare_step_ms": bare_ms,
            "bare_images_per_s": RN_BATCH * 1e3 / bare,
            "macs_per_image": macs,
            "flops_per_step": flops,
            "flop_count": "conv and linear multiply-adds from their shapes "
                          "(conv_linear_macs) x 2 x 3 (forward and "
                          "backward) x batch",
            "mfu_fit": flops * 1e3 / fit_ms / peaks["bf16"],
            "mfu_bare": flops * 1e3 / bare / peaks["bf16"],
            "max_memory_allocated": peak_mem,
            "memory_reserved": torch.cuda.memory_reserved(),
            "losses": losses, "launches_per_step": dict(graph.launches),
            "evaluate": {**plain_logs(ev),
                         "images": n_eval, "wall_s": eval_s,
                         "images_per_s": n_eval / eval_s,
                         "forward_ms_per_batch": fwd_ms,
                         "host_share": 1 - (-(-n_eval // RN_BATCH)) * fwd_ms
                         / (eval_s * 1e3)},
            "profile": profile}


def resnet_loader_check(root):
    """The forked shared-memory loader's first 3 batches (batch 16,
    shuffled) equal the single-process loader's under the same numpy
    seed, on the eval transforms: the training transforms draw from the
    numpy RNG each worker was forked with, in both packages."""
    import numpy as np
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder
    ds = DatasetFolder(root, transform=T.Compose([
        T.Resize(256), T.CenterCrop(224), T.ToTensor(),
        T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
    got = {}
    for workers in (0, 3):
        np.random.seed(SEED + 7)
        it = iter(DataLoader(ds, batch_size=16, shuffle=True,
                             num_workers=workers,
                             use_shared_memory=workers > 0))
        got[workers] = [[t.numpy() for t in next(it)] for _ in range(3)]
        it.close()
    for a, b in zip(got[0], got[3]):
        check(all(np.array_equal(u, v) for u, v in zip(a, b)),
              "resnet: the forked loader's batches differ from the "
              "single-process loader's")
    return {"batches": 3, "batch": 16, "equal": True}


def resnet_f32(perturb=0.0):
    """An f32 ResNet-50 on the CPU, its weights drawn from one seed, each
    residual block's last BatchNorm scale set to 0 (Goyal et al. 2017,
    "Accurate, Large Minibatch SGD", 5.1) and, with `perturb`, every
    weight scaled by (1 + perturb x N(0, 1))."""
    import torch
    from paddle_tpu_torch.framework.state import host_init_ctx
    from paddle_tpu_torch.vision.models import resnet50
    with host_init_ctx(SEED + 1):
        net = resnet50(num_classes=RN_CLASSES)
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for k, p in net.named_parameters():
            if k.endswith("bn3.weight"):
                p._data.zero_()
            elif perturb:
                p._data.mul_(1 + perturb * torch.randn(
                    p._data.shape, generator=gen))
    return net


def resnet_f32_cpu(dev, steps=2):
    """f32 ResNet-50 at batch 2 x 3 x 224 x 224 (`resnet_f32`): `steps`
    Model.train_batch steps with Momentum(0.1, 0.9) on the card and on
    the CPU from the same weights (TF32 off): each loss within 1e-4
    relative, every parameter and BatchNorm running statistic after them
    within 1e-4 x max(1, max|ref|). From the default init (every
    BatchNorm scale 1) this is no test: at batch 2 the training step is
    chaotic, and two CPU runs whose weights differ by 1e-6 end apart by
    percents. So the blocks' last BatchNorm scales start at 0, and the
    CPU runs once more from weights perturbed by 1e-6 (relative) to show
    the comparison resolves what it checks (`cpu_perturbed_1e-6`)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    r = np.random.RandomState(SEED + 8)
    x = r.randn(2, 3, 224, 224).astype("f4")
    y = r.randint(0, RN_CLASSES, (2, 1)).astype("int64")
    runs = []
    cpu = torch.device("cpu")
    for where, perturb in ((dev, 0.0), (cpu, 0.0), (cpu, 1e-6)):
        with on_place(where):
            net = resnet_f32(perturb)
            net.to(device=place_name(where))
            model = pt.Model(net)
            model.prepare(pt.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                parameters=net.parameters()), pt.nn.CrossEntropyLoss())
            t0 = time.perf_counter()
            losses = [model.train_batch(x, y)[0] for _ in range(steps)]
            runs.append((losses, time.perf_counter() - t0, {
                k: v._data.detach().float().cpu().clone()
                for k, v in net.state_dict().items()}))
        del model, net

    def worst(got, ref):
        return max(float((got[k] - want).abs().max())
                   / max(1.0, float(want.abs().max()))
                   for k, want in ref.items())

    (card, card_s, got), (ref_losses, cpu_s, ref), (_, _, moved) = runs
    for a, b in zip(card, ref_losses):
        check(abs(a - b) <= 1e-4 * abs(b),
              f"resnet f32: card losses {card} against the CPU's "
              f"{ref_losses}")
    err = worst(got, ref)
    check(err <= 1e-4, f"resnet f32: a tensor {err} x max(1, max|ref|) "
                       f"from the CPU's")
    return {"batch": 2, "steps": steps, "card_losses": card,
            "cpu_losses": ref_losses, "tensors": len(ref),
            "max_err_over_scale": err,
            "cpu_perturbed_1e-6_max_err_over_scale": worst(moved, ref),
            "card_wall_s": card_s, "cpu_wall_s": cpu_s}


def resnet_graph_check(dev, b=8, steps=3):
    """f32 ResNet-50 (`resnet_f32`) at batch `b`: a graphed TrainStep
    against an eager one (cuda_graph=False) on a twin from the same
    weights over `steps` Momentum(0.1, 0.9) steps (eager, capture +
    replay, replay), cuDNN held to deterministic algorithms: each loss
    and every BatchNorm running statistic within 1e-6 x max(1, |eager|),
    and the graphed model's running statistics moved by every replay."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    r = np.random.RandomState(SEED + 9)
    x = torch.tensor(r.randn(b, 3, 224, 224).astype("f4"), device=dev)
    y = torch.tensor(r.randint(0, RN_CLASSES, (b,)).astype("int64"),
                     device=dev)
    nets = [resnet_f32().to(device=place_name(dev)) for _ in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graphed, eager = (TrainStep(net, pt.nn.CrossEntropyLoss(),
                                    pt.optimizer.Momentum(
                                        learning_rate=0.1, momentum=0.9,
                                        parameters=net.parameters()),
                                    cuda_graph=graphed_)
                          for net, graphed_ in zip(nets, (True, False)))
        pairs, worst = [], 0.0
        before = None
        for i in range(steps):
            g, e = float(graphed(x, y)), float(eager(x, y))
            pairs.append((g, e))
            check(abs(g - e) <= 1e-6 * max(1.0, abs(e)),
                  f"resnet graphed: losses {pairs}")
            stats = {k: v._data.detach().clone()
                     for k, v in nets[0].named_buffers()}
            for k, v in nets[1].named_buffers():
                scale = max(1.0, float(v._data.abs().max()))
                err = float((stats[k] - v._data).abs().max())
                check(err <= 1e-6 * scale,
                      f"resnet graphed: step {i} {k} error {err}")
                worst = max(worst, err / scale)
            if before is not None:
                still = [k for k in stats if torch.equal(stats[k],
                                                         before[k])]
                check(not still, f"resnet graphed: step {i} left "
                                 f"{len(still)} running statistics, e.g. "
                                 f"{still[:2]}")
            before = stats
        graph_of(graphed, "resnet f32")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"batch": b, "steps": steps, "losses_graphed_eager": pairs,
            "bn_buffers": len(before), "max_buffer_err_over_scale": worst}


def resnet_phase(dev, smi, peaks):
    """ResNet-50 (BASELINE.json configs[1]) on the card: a seeded image
    tree written to a temporary directory, the bf16 training run at batch
    128 through Model.fit and the forked loader (`resnet_train`), the
    loader's order check, the f32 card-against-CPU steps and the graphed
    step against the eager one."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_resnet_")
    try:
        t0 = time.perf_counter()
        write_image_tree(root, RN_BATCH * RN_STEPS)
        tree_s = time.perf_counter() - t0
        train = resnet_train(dev, peaks, root)
        loader = resnet_loader_check(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f32 = resnet_f32_cpu(dev)
    graphed = resnet_graph_check(dev)
    emit("resnet", **train, image_tree_s=tree_s, loader_order=loader,
         f32_cpu=f32, graphed_vs_eager=graphed, nvidia_smi=smi)


def graphed_train(model, loss_fn, opt, ids, name, steps=10, labels=None,
                  layers=LAYERS, routes_want=None, after_step=None,
                  groups=None):
    """bench.py's GPU recipe on `model`: the counts set to 0, a
    TrainStep, 3 warm-up calls (eager, capture, replay), then `steps`
    timed graph replays of `step(ids, labels)` (labels default to ids).
    The graph must hold `layers` launches of each flash kernel (fwd, dkv,
    dq, dd) and 1 of the optimizer kernel, the attention routes of the
    eager call and the capture must be `routes_want` (default: every
    layer on the kernel route), the timed calls must launch nothing from
    Python, and the profiler must see the graph's kernels once each a
    replay. `after_step` runs on the host after every call (a schedule's
    step()); `groups` are the profile's kernel groups (default
    PROFILE_GROUPS). Returns the step and its measurements."""
    import numpy as np
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa

    # the main path's run, from building the step to its last timed
    # call: every count is 0 before it and read after
    labels = ids if labels is None else labels
    after_step = after_step or (lambda: None)
    zero_counts()
    fa.routes["kernel"] = fa.routes["dense"] = 0
    step = TrainStep(model, loss_fn, opt, donate=True)
    # call 1 runs eagerly on a side stream, call 2 captures the step and
    # replays it, call 3 replays
    for _ in range(3):
        float(step(ids, labels))
        after_step()
    graphs = list(step.graphs.values())
    check(len(graphs) == 1 and graphs[0] is not None,
          f"{name}: {len(graphs)} graphs after three calls")
    graph = graphs[0]
    per_step = dict(graph.launches)
    want = {f"flash_attention.{k}": layers for k in ("fwd", "dkv", "dq",
                                                     "dd")}
    want["optimizer.adam"] = 1
    check(per_step == want, f"{name}: the graph holds the launches "
                            f"{per_step}, not {want}")
    routes = dict(fa.routes)
    routes_want = routes_want or {"kernel": 2 * layers, "dense": 0}
    check(routes == routes_want,
          f"{name}: attention routes {routes} in the eager call and the "
          f"capture, not {routes_want}")
    warm = kernels.launch_counts()
    replays0 = graph.replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(ids, labels)
        after_step()
    final = float(loss)                             # one sync at the end
    dt = (time.perf_counter() - t0) / steps
    peak_mem = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    counts = kernels.launch_counts()
    check(counts == warm, f"{name}: a timed call launched kernels from "
                          "Python instead of replaying the graph")
    check(graph.replays - replays0 == steps,
          f"{name}: {graph.replays - replays0} replays in {steps} calls")
    check(np.isfinite(final), f"{name}: non-finite loss {final}")
    check(not step.last_nonfinite(), f"{name}: non-finite grad norm")
    # kernels that ran in the timed calls: the graph's launches times
    # its replays (the profiler's count of each kernel per replay checks
    # it below)
    launches = {k.split(".")[1]: n * steps for k, n in per_step.items()}
    grad_norm = step.last_grad_norm()
    profile = profile_steps(step, ids, dt * 1e3, labels=labels,
                            **({} if groups is None else
                               {"categories": groups, "other": STEP_OTHER}))
    check(isinstance(profile, dict), f"{name}: profile {profile}")
    for key, dev_name in DEVICE_NAMES.items():
        seen = profile["kernel_calls_per_step"][dev_name]
        check(seen == per_step[key],
              f"{name}: the profiler saw {dev_name} {seen} times a step, "
              f"the graph holds {per_step[key]} launches of it")
    return {"step": step, "dt": dt, "final": final, "peak_mem": peak_mem,
            "reserved": reserved, "counts": counts, "per_step": per_step,
            "launches": launches, "grad_norm": grad_norm,
            "profile": profile, "routes": routes}


def train_phase(dev, peaks):
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep, grad_norm_sentinel
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining(train_config(), device=dev,
                              dtype=torch.bfloat16, seed=SEED)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, (TRAIN_B, TRAIN_S)).astype("int64"), device=dev)
    steps = 10
    run = graphed_train(model, gpt_pretrain_loss, opt, ids, "train", steps)
    dt, final, per_step = run["dt"], run["final"], run["per_step"]
    peak_mem, reserved, counts = (run["peak_mem"], run["reserved"],
                                  run["counts"])
    launches, grad_norm, profile, routes = (run["launches"],
                                            run["grad_norm"],
                                            run["profile"], run["routes"])

    # the eager sequence on the same model and optimizer, for comparison
    eager = TrainStep(model, gpt_pretrain_loss, opt, cuda_graph=False)
    for _ in range(2):
        float(eager(ids, ids))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = eager(ids, ids)
    float(loss)
    eager_dt = (time.perf_counter() - t0) / steps
    eager_profile = profile_steps(eager, ids, eager_dt * 1e3)
    if isinstance(eager_profile, dict):
        del eager_profile["top_kernels"]

    # where an eager step's time goes: CUDA events around its parts
    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    parts = {"forward_loss": 0.0, "backward": 0.0, "sentinel": 0.0,
             "optimizer": 0.0}
    reps = 3
    for _ in range(reps):
        e0 = ev()
        lo = gpt_pretrain_loss(model(ids), ids)
        e1 = ev()
        lo.backward()
        e2 = ev()
        grad_norm_sentinel(lo, list(leaf_grads(model).values()))
        e3 = ev()
        opt.step()
        opt.clear_grad()
        e4 = ev()
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, ((e0, e1), (e1, e2), (e2, e3),
                                       (e3, e4))):
            parts[key] += a.elapsed_time(b) / reps
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = TRAIN_B * TRAIN_S / dt
    emit("train", model="gpt2_small", dtype="bfloat16", vocab=TRAIN_VOCAB,
         batch=TRAIN_B, seq=TRAIN_S, steps=steps,
         step="one CUDA graph replay per call", step_ms=dt * 1e3,
         tokens_per_s=tokens_per_s, loss=final, grad_norm=grad_norm,
         params=n_params, mfu=6 * n_params * tokens_per_s / peaks["bf16"],
         max_memory_allocated=peak_mem, memory_reserved=reserved,
         memory_note="a graph's activations sit in its pool, reserved and "
                     "not allocated between replays",
         eager_step_ms=eager_dt * 1e3,
         eager_tokens_per_s=TRAIN_B * TRAIN_S / eager_dt,
         launches_per_step=per_step, launches=launches,
         wrapper_counts={k: n for k, n in counts.items() if n},
         routes=routes, step_parts_ms_eager=parts, profile=profile,
         eager_profile=eager_profile)
    return launches


def train_llama_phase(dev, peaks):
    """bench.py's GPU recipe (`graphed_train`) on the serving LLaMA
    (`llama_config`): batch 8 x seq 1024, bf16, AdamW, 3 warm-up calls
    then 10 timed graph replays holding 12 launches each of K1, K2, K3
    and dd and 1 of the optimizer kernel. Step ms, tokens/s, MFU as the
    train phase computes it, peak memory, the idle share and the device
    time by kernel group."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nlp import LlamaForCausalLM, llama_pretrain_loss
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(llama_config(), device=dev,
                             dtype=torch.bfloat16, seed=SEED)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype("int64"),
        device=dev)
    steps = 10
    run = graphed_train(model, llama_pretrain_loss, opt, ids, "train_llama",
                        steps)
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_s = TRAIN_B * TRAIN_S / run["dt"]
    emit("train_llama", model="llama (vocab 32000, 768 wide, 12 layers, "
                              "12 heads over 4 KV heads, SwiGLU 2048)",
         dtype="bfloat16", batch=TRAIN_B, seq=TRAIN_S, steps=steps,
         step="one CUDA graph replay per call", step_ms=run["dt"] * 1e3,
         tokens_per_s=tokens_per_s, loss=run["final"],
         grad_norm=run["grad_norm"], params=n_params,
         mfu=6 * n_params * tokens_per_s / peaks["bf16"],
         max_memory_allocated=run["peak_mem"],
         memory_reserved=run["reserved"],
         launches_per_step=run["per_step"], launches=run["launches"],
         routes=run["routes"], profile=run["profile"])
    return run["launches"]


# the fused-head run: GPT-2 small's padded vocab at seq 1024 and batch
# 16, whose f32 logits (3.30 GB) pass the 2 GiB auto threshold
FUSED_B, FUSED_VOCAB = 16, 50304


def train_fused_head_phase(dev, peaks, steps=5):
    """GPT-2 small with vocab 50304, batch 16 x seq 1024, bf16, AdamW,
    the head on auto (so fused) in the graphed TrainStep: the counts set
    to 0 before and read after, the graph's launches, the dense head
    never called on the loss path; step ms, tokens/s, MFU, peak memory,
    device time by group with the chunked head timed alone beside it.
    Then the same model with fused_head_loss=False: its step ms and
    peak memory."""
    import numpy as np
    import torch
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import GPTForPretraining, gpt_pretrain_loss
    from paddle_tpu_torch.nlp import gpt as gpt_mod
    from paddle_tpu_torch.nlp.gpt import FusedHeadLogits, _use_fused_head
    from paddle_tpu_torch.ops.chunked_ce import chunked_lm_loss
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()                # the earlier phases' graphs and models
    torch.cuda.empty_cache()
    cfg = train_config(vocab_size=FUSED_VOCAB)
    check(cfg.fused_head_loss is None and _use_fused_head(
        cfg, (FUSED_B, TRAIN_S, FUSED_VOCAB)),
        "train_fused_head: the auto threshold does not pick the fused head")
    model = GPTForPretraining(cfg, device=dev, dtype=torch.bfloat16,
                              seed=SEED)
    # the dense head product: the forward's `matmul` when the head is not
    # fused, `FusedHeadLogits.dense` when something reads fused logits
    head_calls = []
    dense_head = gpt_mod.matmul

    def counted_head(h, w, **kw):
        head_calls.append(tuple(h.shape))
        return dense_head(h, w, **kw)
    gpt_mod.matmul = counted_head
    dense_of_fused = FusedHeadLogits.dense

    def counted_dense(logits):
        if logits._dense is None:
            head_calls.append(tuple(logits.hidden.shape))
        return dense_of_fused(logits)
    FusedHeadLogits.dense = counted_dense
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids = torch.tensor(np.random.RandomState(1).randint(
        0, FUSED_VOCAB, (FUSED_B, TRAIN_S)).astype("int64"), device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    def run(fused):
        """3 warm-up calls (eager, capture, replay) and `steps` timed
        replays; returns the figures and the step."""
        cfg.fused_head_loss = None if fused else False
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = TrainStep(model, gpt_pretrain_loss, opt)
        for _ in range(3):
            float(step(ids, ids))
        peak_warm = torch.cuda.max_memory_allocated()
        (graph,) = step.graphs.values()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(ids, ids)
        final = float(loss)
        dt = (time.perf_counter() - t0) / steps
        check(np.isfinite(final), f"train_fused_head: loss {final}")
        tps = FUSED_B * TRAIN_S / dt
        return step, graph, {
            "step_ms": dt * 1e3, "tokens_per_s": tps,
            "mfu": 6 * n_params * tps / peaks["bf16"], "loss": final,
            "peak_allocated_warmup_and_capture": peak_warm,
            "peak_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved()}

    # the main path's run: every count 0 before it, read after
    zero_counts()
    step, graph, fused = run(True)
    counts = kernels.launch_counts()
    want = {f"flash_attention.{k}": LAYERS for k in ("fwd", "dkv", "dq",
                                                     "dd")}
    want["optimizer.adam"] = 1
    check(dict(graph.launches) == want,
          f"train_fused_head: the graph holds {graph.launches}, not {want}")
    check(head_calls == [], f"train_fused_head: the dense head ran on the "
                            f"loss path {len(head_calls)} times")
    # call 2 captures and replays, call 3 and the timed calls replay
    check(graph.replays == steps + 2,
          f"train_fused_head: {graph.replays} replays, not {steps + 2}")
    # kernels run: the wrappers' counts (the eager call's launches and
    # the capture's, which run only when replayed) less the capture's,
    # plus the graph's launches times its replays
    launches = {k.split(".")[1]: counts[k] - n + n * graph.replays
                for k, n in want.items()}
    check(all(n > 0 for n in launches.values()),
          f"train_fused_head: launches {launches}")
    profile = profile_steps(step, ids, fused["step_ms"])
    check(isinstance(profile, dict), f"train_fused_head: profile {profile}")
    del step, graph
    # the chunked head alone (forward and backward) at the step's shapes,
    # by CUDA-graph replay
    h = (torch.randn(FUSED_B * TRAIN_S, cfg.hidden_size, device=dev)
         .to(torch.bfloat16).requires_grad_())
    w = model.gpt.embeddings.word_embeddings.weight._data
    lab = ids.reshape(-1).roll(-1)

    def head_step():
        torch.autograd.grad(chunked_lm_loss(h, w, lab, -1, 4096), (h, w))
    head_ms = graph_ms(head_step, 1, replays=5)
    # the step's groups with the head's own kernels (the same kernels
    # profiled alone at the same shapes) taken out into a group of its
    # own: its matmuls and its chunk pass
    head_groups = profile_replays(capture(head_step))
    check(head_groups is not None, "train_fused_head: the profiler saw "
                                   "no device time in the chunked head")
    step_groups = profile["ms_per_step_by_group"]
    profile["ms_per_step_by_group_head_apart"] = {
        "chunked head (forward + backward)": sum(head_groups.values()),
        **{k: step_groups[k] - head_groups[k] for k in step_groups}}
    profile["chunked_head_ms_by_group"] = head_groups
    # its four products per chunk alone (forward logits, the backward's
    # recompute, dh and dw), the rest of its time being the chunk pass
    dl = torch.empty(h.shape[0], 4096, dtype=torch.bfloat16, device=dev)

    def head_products():
        for lo in range(0, FUSED_VOCAB, 4096):
            wc = w.detach()[lo:lo + 4096]
            d = dl[:, :wc.shape[0]]
            for _ in range(2):
                torch.mm(h.detach(), wc.t(), out_dtype=torch.float32)
            torch.mm(d, wc, out_dtype=torch.float32)
            torch.mm(d.t(), h.detach(), out_dtype=torch.float32)
    products_ms = graph_ms(head_products, 1, replays=5)
    head_flops = 4 * 2 * h.shape[0] * cfg.hidden_size * FUSED_VOCAB
    del h, dl
    dense_step, dense_graph, dense = run(False)
    check(len(head_calls) == 2 and "optimizer.adam" in dense_graph.launches,
          f"train_fused_head: the dense run called the head "
          f"{len(head_calls)} times, not 2 (the eager call and the "
          f"capture; a replay runs no Python)")
    del dense_step, dense_graph
    gpt_mod.matmul = dense_head
    FusedHeadLogits.dense = dense_of_fused
    torch.cuda.empty_cache()
    return {"model": "gpt2_small", "dtype": "bfloat16", "vocab": FUSED_VOCAB,
            "batch": FUSED_B, "seq": TRAIN_S, "steps": steps,
            "head": "fused (auto: f32 logits 3.30 GB > 2 GiB)",
            "params": n_params, **fused, "launches": launches,
            "dense_head_calls_on_the_loss_path": 0,
            "chunked_head_fwd_bwd_ms_alone": head_ms,
            "chunked_head_products_ms_alone": products_ms,
            "chunked_head_products_tflop": head_flops / 1e12,
            "profile": profile,
            "dense_head": {"fused_head_loss": False, **dense},
            "what": "step_ms: graph replays after 3 warm-up calls, host "
                    "clock, one sync at the end; peak_allocated_warmup_"
                    "and_capture: max_memory_allocated over the eager "
                    "step and the capture (the activations), "
                    "peak_allocated: also over the timed replays; the "
                    "chunked head alone: its forward and backward "
                    "captured and replayed"}


# kernel-name fragments -> category of a training step's device time
# the record_function names of the graphs.Program runs (a replay's range
# is mirrored on the device)
PROGRAM_RANGES = ("jit.TrainStep", "generate.decode_step",
                  "serving.decode_wave", "serving.prefill_chunk")
PROFILE_GROUPS = (("flash attention (K1-K3, dd)", ("flash_", "row_dot")),
                  ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
                  ("optimizer (fused adam, foreach)",
                   ("adam_kernel", "multi_tensor", "foreach")))


OTHER_GROUP = "other (elementwise, norms, loss, copies)"
# the eager and nn phases' steps: the norms, GELU and the softmax/loss
# kernels apart from the other elementwise kernels
STEP_GROUPS = PROFILE_GROUPS + (
    ("layer_norm", ("layer_norm",)), ("gelu", ("gelu",)),
    ("softmax and cross entropy", ("softmax", "nll_loss")))
STEP_OTHER = "other (elementwise, copies)"
# the transformer step's: the dense route's f32 QK^T and PV products
# (the decoder's masked self-attention; every other matmul is bf16),
# the dropout masks, the norms and the softmax/loss kernels apart
TF_GROUPS = (PROFILE_GROUPS[0],
             ("dense attention's f32 gemms", ("gemm_f32f32",))) + \
    PROFILE_GROUPS[1:] + (
    ("layer_norm", ("layer_norm", "gammabeta")),
    ("dropout masks", ("bernoulli",)),
    ("softmax and cross entropy", ("softmax", "nll_loss")))


def device_rows(prof, calls):
    """(ms, launches, name) per call of each device kernel in a profile
    of `calls` calls, largest first. Device activities only: CPU ranges
    (ops, autograd Functions) carry their kernels' time too and would
    count it twice, and so do the ranges mirrored on the device (a
    profiler step, a `graphs.Program`'s record_function around a graph
    replay, such as "jit.TrainStep")."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / 1e3 / calls, e.count / calls, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")
            and e.key not in PROGRAM_RANGES]
    return sorted(rows, reverse=True)


def by_group(rows, categories=PROFILE_GROUPS, other=OTHER_GROUP):
    """Device ms by `categories` ((name, name fragments) pairs; the rest
    in `other`)."""
    groups = {name: 0.0 for name, _ in categories}
    groups[other] = 0.0
    for ms, _, key in rows:
        low = key.lower()
        name = next((n for n, frags in categories
                     if any(f in low for f in frags)), other)
        groups[name] += ms
    return groups


def profile_steps(step, ids, step_ms, steps=2, categories=PROFILE_GROUPS,
                  other=OTHER_GROUP, labels=None):
    """Device time of `steps` training steps by kernel, from
    torch.profiler (CUPTI): per-step ms by category, the device's idle
    share, the calls per step of each kernel in DEVICE_NAMES, and the top
    kernels. The idle share is that of the profiled window; beside it,
    the busy time against the unprofiled step time `step_ms`. The
    profiler warms up on one step of its own (tracing on, events
    dropped) before the recorded window: on an H100 a window opened cold
    once recorded 23 of the 24 flash_fwd_wgmma launches of two replays.
    Each step is `step(ids, labels)` (labels default to ids). Returns
    "not measured: ..." when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    labels = ids if labels is None else labels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        float(step(ids, labels))
        torch.cuda.synchronize()
        prof.step()                     # the warm-up ends: record
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(ids, labels)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3 / steps
        prof.step()                     # the recorded window ends
    rows = device_rows(prof, steps)
    if not rows:
        return "not measured: the profiler recorded no device time"
    busy = sum(r[0] for r in rows)
    return {"steps": steps, "profiled_wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy,
            "kernel_calls_per_step": {
                name: sum(n for _, n, key in rows if name in key)
                for name in DEVICE_NAMES.values()},
            # both from the profiled window (the profiler slows the
            # kernels as well as the host)
            "device_idle_share": 1 - busy / wall,
            # against the unprofiled step: below 0 when the profiler's
            # slowdown of the kernels exceeds the idle time
            "idle_share_vs_unprofiled_step": 1 - busy / step_ms,
            "ms_per_step_by_group": by_group(rows, categories, other),
            "top_kernels": [{"ms": ms, "calls": n, "name": key[:90]}
                            for ms, n, key in rows[:16]]}


def replay_rows(graph, calls=3):
    """`device_rows` of `calls` replays of a CUDA graph, from
    torch.profiler (empty when it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            graph.replay()
        torch.cuda.synchronize()
    return device_rows(prof, calls)


def profile_replays(graph, calls=3):
    """Device ms per replay of a CUDA graph by kernel group; None when
    the profiler records no device time."""
    rows = replay_rows(graph, calls)
    return by_group(rows) if rows else None


def graph_profile(graph, calls=3, top=8, categories=PROFILE_GROUPS,
                  other=OTHER_GROUP):
    """A replay's device ms in all and by kernel group (`by_group`), its
    kernel launches and its `top` kernels; "not measured" when the
    profiler records no device time."""
    rows = replay_rows(graph, calls)
    if not rows:
        return "not measured: the profiler recorded no device time"
    return {"device_ms": sum(r[0] for r in rows),
            "by_group": by_group(rows, categories, other),
            "kernels": sum(r[1] for r in rows),
            "top_kernels": [{"ms": ms, "calls": n, "name": key[:90]}
                            for ms, n, key in rows[:top]]}


def ptxas_entries(ptxas):
    """{entry function: {"registers", "spill_bytes"}} from a library's
    ptxas report (`kernels.build`'s "ptxas"); the split kernel's
    instantiations named by pool type and rows a CUDA block."""
    import re
    out, name = {}, None
    for ln in ptxas.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", ln)
        if hit:
            name = hit.group(1)
            split = re.search(r"paged_attn_split_kernelI(\w+?)Li(\d+)E",
                              name)
            if split:
                dtype = "bf16" if "bfloat16" in split.group(1) else "f32"
                name = f"paged_attn_split_kernel<{dtype}, {split.group(2)}>"
            elif "paged_attn_combine" in name:
                name = ("paged_attn_combine<"
                        f"{'bf16' if 'bfloat16' in name else 'f32'}>")
            elif "paged_attn_chunk_mma" in name:
                name = "paged_attn_chunk_mma"
            out[name] = {"registers": None, "spill_bytes": 0}
        elif name is not None:
            spill = re.findall(r"(\d+) bytes spill", ln)
            if spill:
                out[name]["spill_bytes"] += sum(int(n) for n in spill)
            regs = re.search(r"Used (\d+) registers", ln)
            if regs:
                out[name]["registers"] = int(regs.group(1))
    return out


def k4_build_check(entries):
    """Every paged_attention.cu instantiation (`ptxas_entries`) built
    with 0 spill bytes and at most 255 registers (the split kernel's
    8-row bf16 tile spilled 1080 bytes before it took one register tile
    a warp)."""
    check(len(entries) >= 9, f"K4's ptxas report lists {sorted(entries)}")
    for name, e in entries.items():
        check(e["spill_bytes"] == 0 and e["registers"] is not None
              and e["registers"] <= 255,
              f"{name}: {e['registers']} registers, {e['spill_bytes']} "
              f"spill bytes")
    return entries


def build_all():
    """Build every kernel library at once: one nvcc per source, started
    together."""
    from paddle_tpu_torch import kernels
    names = sorted(kernels.SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(kernels.build, names)))
    for name in names:
        kernels.load(name)
    return infos


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
    only = PHASES
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--only":
            print("usage: chip_smoke.py [--only PHASE[,PHASE...]]",
                  file=sys.stderr)
            return 2
        only = tuple(sys.argv[2].split(","))
        check(set(only) <= set(PHASES), f"phases are {PHASES}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    peaks = PEAKS["pcie" if "pcie" in smi.lower() else "sxm"]
    t0 = time.perf_counter()
    infos = build_all()
    k4_entries = ptxas_entries(infos["paged_attention"]["ptxas"])
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         peaks=peaks, build_wall_s=time.perf_counter() - t0,
         kernel_build_s={n: i["seconds"] for n, i in infos.items()},
         kernel_built={n: i["built"] for n, i in infos.items()},
         ptxas={n: [ln for ln in i["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "warning" in ln]
                for n, i in infos.items()},
         paged_attention_entries=k4_entries)
    k4_build_check(k4_entries)
    timings = {}

    def run(name, fn, *args):
        if name not in only:
            return None
        t = time.perf_counter()
        out = fn(*args)
        timings[name] = time.perf_counter() - t
        return out

    k = run("kernels", kernels_phase, dev, peaks)
    if k is not None:
        emit("kernels", **k)
    fl = run("flash", flash_phase, dev, peaks)
    if fl is not None:
        emit("flash", **fl)
    op = run("optimizer", optimizer_phase, dev, peaks)
    if op is not None:
        emit("optimizer", **op)
    run("parity", parity_phase, dev, smi)
    run("train_parity", train_parity_phase, dev)
    serve_launches = run("serve", serve_phase, dev, smi)
    dense_launches = run("serve_dense", serve_dense_phase, dev, smi)
    spec_launches = run("serve_spec", serve_spec_phase, dev, smi)
    disagg_launches = run("serve_disagg", serve_disagg_phase, dev, smi)
    llama_launches = run("serve_llama", serve_llama_phase, dev, smi)
    train_launches = run("train", train_phase, dev, peaks)
    train_llama_launches = run("train_llama", train_llama_phase, dev, peaks)
    fh = run("train_fused_head", train_fused_head_phase, dev, peaks)
    if fh is not None:
        emit("train_fused_head", **fh)
    eager_launches = run("eager", eager_phase, dev, smi)
    nn_launches = run("nn", nn_phase, dev, smi)
    tf_launches = run("transformer", transformer_phase, dev, smi, peaks)
    bert_launches = run("bert", bert_phase, dev, smi, peaks)
    amp_launches = run("amp", amp_phase, dev, smi)
    hapi_launches = run("hapi", hapi_phase, dev, smi, peaks)
    run("resnet", resnet_phase, dev, smi, peaks)
    emit("phase_seconds", **timings)
    if only != PHASES:
        return 0
    rows = []
    for form in ("decode", "chunk"):
        row = dict(k[form])
        rows.append({"name": f"paged_attention_{form}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES,
                     "launches": serve_launches[form],
                     "ms": row.pop("kernel_ms"), **row})
    # serve_spec: the draft wave's decode form, the spec prefill chunk's
    # chunk form, and the verify (its own row, at its own shape)
    rows[0]["launches_serve_spec"] = spec_launches["draft"]
    rows[1]["launches_serve_spec"] = spec_launches["prefill"]
    # serve_disagg: the decode role's waves, the prefill role's chunks
    rows[0]["launches_serve_disagg"] = disagg_launches["decode_role_decode"]
    rows[1]["launches_serve_disagg"] = disagg_launches["prefill_role_chunk"]
    # serve_llama (GQA rep 3): the paged engine's waves and chunks, the
    # spec engine's draft waves and chunks
    for i, form, prog in ((0, "decode", "draft"), (1, "chunk", "prefill")):
        rows[i]["launches_serve_llama"] = {
            "paged": llama_launches["paged"][form],
            "spec": llama_launches["spec"][prog]}
    row = dict(k["verify"])
    rows.append({"name": "paged_attention_verify", "route": "cuda",
                 "source": SOURCE, "replaces": REPLACES,
                 "launches": spec_launches["verify"],
                 "launches_serve_llama": {
                     "spec": llama_launches["spec"]["verify"]},
                 "ms": row.pop("kernel_ms"), **row})
    for kind in ("fwd", "dkv", "dq", "dd"):
        row = dict(fl[kind])
        rows.append({"name": FLASH_NAMES[kind], "route": "cuda",
                     "source": FLASH_SOURCE,
                     "replaces": FLASH_REPLACES[kind],
                     "launches": train_launches[kind],
                     "launches_train_fused_head": fh["launches"][kind],
                     "launches_train_llama": train_llama_launches[kind],
                     "launches_eager": eager_launches[kind],
                     "launches_nn": nn_launches[kind],
                     "launches_nn_trainstep": nn_launches["trainstep"][kind],
                     "launches_nn_llama_attention":
                         nn_launches["llama_attention"][kind],
                     "launches_transformer": tf_launches[kind],
                     "launches_bert": bert_launches[kind],
                     "launches_amp": amp_launches[kind],
                     "launches_hapi": hapi_launches[kind],
                     "bert_shape": dict(fl["bert_shape"][kind]),
                     "transformer_shapes": {
                         name: shape[kind] for name, shape in
                         fl["transformer_shapes"].items()},
                     "ms": row.pop("kernel_ms"), **row})
        if kind == "fwd":
            prefill = dict(fl["fwd_prefill"])
            rows[-1]["launches_serve_dense"] = dense_launches
            rows[-1]["launches_serve_llama"] = {
                "dense": llama_launches["dense_k1"]}
            rows[-1]["prefill_shape"] = {
                "ms": prefill.pop("kernel_ms"), **prefill}
    row = {k: op[k] for k in ("max_abs_err", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
    rows.append({"name": "fused_adam", "route": "cuda",
                 "source": OPT_SOURCE, "replaces": OPT_REPLACES,
                 "launches": train_launches["adam"],
                 "launches_train_fused_head": fh["launches"]["adam"],
                 "launches_train_llama": train_llama_launches["adam"],
                 "launches_nn": nn_launches["adam"],
                 "launches_nn_trainstep": nn_launches["trainstep"]["adam"],
                 "launches_transformer": tf_launches["adam"],
                 "launches_bert": bert_launches["adam"],
                 "launches_amp": amp_launches["adam"],
                 "launches_hapi": hapi_launches["adam"],
                 "ms": op["kernel_ms"], **row})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
