"""The serving engine's static-buffer programs (paddle_tpu_torch.serving)
against the JAX paged engine.

On the card the decode wave and the prefill chunk are CUDA graphs that
replay on the addresses they captured; here, on the CPU, the same
program functions run eagerly over the same static buffers. These tests
hold what the graphs rely on: every static input keeps its storage for
the engine's life, the 0-d tensor chunk offsets give the JAX model's
logits and pools, greedy streams equal the JAX engine's with
`switch_ir_optim` on and off, the CPU engine compiles nothing, and
sampled streams replay from the seed.

Model: the SMALL model of tests/test_torch_serving.py (bench.py's CPU
smoke size, initializer_range 0.2). Logits and pools within
tests/test_torch_gpt.py's ATOL = 1e-4 (f32, different summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nn import paged_attention as jpa
from paddle_tpu.serving import PagedServingEngine as JEngine
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import engine as jengine
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.serving import PagedServingEngine, Scheduler
from paddle_tpu_torch.serving import engine as tengine

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ATOL = 1e-4
VOCAB = 512
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=128, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)
ENGINE = dict(num_slots=4, max_len=64, block_size=8, prefill_chunk_len=16)


def _pair(**over):
    cfg = dict(SMALL, **over)
    pt.seed(5)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _jobs(seed, n=8):
    """Mixed lengths, some spanning 2-3 prefill chunks; the last two
    share a 20-token prefix (prefix-cache hits on full blocks)."""
    rng = np.random.RandomState(seed)
    jobs = [(rng.randint(0, VOCAB, (int(rng.randint(2, 40)),)).tolist(),
             int(rng.randint(2, 12))) for _ in range(n)]
    shared = rng.randint(0, VOCAB, (20,)).tolist()
    jobs[-2] = (shared + [1, 2], 6)
    jobs[-1] = (shared + [3], 5)
    return jobs


def _stream(sched, jobs, **kw):
    reqs = [sched.submit(prompt=p, max_tokens=m, **kw) for p, m in jobs]
    sched.run()
    return [(r.output_tokens, r.finish_reason) for r in reqs]


def _addresses(eng):
    return {(prog, name): (t.data_ptr(), tuple(t.shape), t.dtype)
            for prog, inputs in (("wave", eng.wave_inputs),
                                 ("prefill", eng.prefill_inputs))
            for name, t in inputs.tensors.items()}


# ---------------------------------------------------------------------------
# (a) the static buffers keep their storage
# ---------------------------------------------------------------------------

def test_static_buffers_keep_their_addresses_over_a_stream(models):
    """Admissions, multi-chunk prefills, retirements, a logit-bias row
    set and cleared, and preemption by recompute under pool pressure:
    every input buffer of the wave and of the chunk keeps its data_ptr,
    shape and dtype from construction to the end, which is what a CUDA
    graph replaying on captured addresses needs. The staged bias row is
    the request's while it runs and zero once it has retired."""
    _, tm = models
    eng = PagedServingEngine(tm, paged_kernel="plain", device="cpu",
                             num_blocks=9, **ENGINE)
    want = _addresses(eng)
    assert {name for prog, name in want if prog == "wave"} == {
        "tok", "pos", "top_k", "temps", "top_p", "active", "sample",
        "tables", "bias", "gumbel"}
    assert {name for prog, name in want if prog == "prefill"} == {
        "chunk", "table", "chunk_start", "valid_len", "frontier", "sample",
        "temp", "top_k", "top_p", "bias", "gumbel"}
    sched = Scheduler(eng)
    rng = np.random.RandomState(3)
    reqs = [sched.submit(prompt=rng.randint(0, VOCAB, (n,)).tolist(),
                         max_tokens=30,
                         logit_bias={7: 2.5} if i == 1 else None)
            for i, n in enumerate((10, 10, 20, 10, 10))]
    biased_rows = []
    while sched.step():
        assert _addresses(eng) == want
        slot = reqs[1].slot
        if slot is not None and eng.slot_active[slot]:
            row = eng.wave_inputs.tensors["bias"][slot]
            biased_rows.append(float(row[7]) == 2.5
                               and int(torch.count_nonzero(row)) == 1)
    assert _addresses(eng) == want
    assert biased_rows and all(biased_rows)
    assert all(r.finish_reason == "max_tokens" for r in reqs)
    assert sched.metrics.snapshot()["faults"].get("preempted", 0) > 0
    # retirement cleared the row, and the clear reached the device
    assert int(torch.count_nonzero(eng.wave_inputs.tensors["bias"])) == 0
    assert eng.block_pool.outstanding() == {}


def test_static_inputs_stage_and_upload():
    """Typed views of one byte buffer: what the host stages is what the
    device buffers hold after one upload, and no buffer moves."""
    dev = torch.device("cpu")
    inputs = tengine.StaticInputs(
        [("a", torch.int64, (3,)), ("b", torch.bool, (2,)),
         ("c", torch.float32, ()), ("d", torch.int32, (2, 3))], dev)
    ptrs = {k: t.data_ptr() for k, t in inputs.tensors.items()}
    assert all(p % 16 == 0 for p in ptrs.values())
    for step in range(2):
        host = inputs.stage()
        host["a"][:] = [step, 5, -7]
        host["b"][:] = [True, bool(step)]
        host["c"][...] = 0.25 + step
        host["d"][...] = np.arange(6, dtype=np.int32).reshape(2, 3) * step
        inputs.upload()
        t = inputs.tensors
        assert t["a"].tolist() == [step, 5, -7]
        assert t["b"].tolist() == [True, bool(step)]
        assert t["c"].shape == () and float(t["c"]) == 0.25 + step
        assert t["d"].tolist() == (np.arange(6).reshape(2, 3)
                                   * step).tolist()
        assert {k: x.data_ptr() for k, x in t.items()} == ptrs


# ---------------------------------------------------------------------------
# (b) 0-d device tensors through the prefill chunk
# ---------------------------------------------------------------------------

NB, BS, MAX_LEN = 13, 8, 48


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _jax_prefill(jm, caches, tokens, table, start, valid, frontier=None):
    with jpa.kernel_scope("lax"):
        return jm.prefill_chunk(Tensor(jnp.asarray(tokens)), caches,
                                jnp.asarray(table), jnp.int32(start),
                                jnp.int32(valid), frontier=frontier)


def _scalar(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_chunk_with_tensor_offsets_matches_jax(window):
    """The cases of test_torch_gpt's prefill/decode parity test with the
    chunk start, valid length and frontier handed over as 0-d tensors,
    as the engine's program passes them: two chunks (the second partial,
    with a frontier) and then a decode wave with a parked lane give the
    JAX model's logits and pools."""
    jm, tm = _pair(attn_window=window)
    rng = np.random.default_rng(11)
    jc = jm.init_paged_cache(NB, BS, MAX_LEN)
    tc = tm.init_paged_cache(NB, BS, MAX_LEN)
    table = np.array([[1, 2, 3, 0, 0, 0]], np.int32)
    toks = rng.integers(0, VOCAB, (1, 16)).astype(np.int32)
    jl, jc = _jax_prefill(jm, jc, toks, table, 0, 16)
    tl, tc = tm.prefill_chunk(torch.from_numpy(toks).long(), tc,
                              torch.from_numpy(table), _scalar(0),
                              _scalar(16))
    assert tl.shape == (1, 16, VOCAB)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)
    toks2 = rng.integers(0, VOCAB, (1, 16)).astype(np.int32)
    jl, jc = _jax_prefill(jm, jc, toks2, table, 16, 5, frontier=4)
    tl, tc = tm.prefill_chunk(torch.from_numpy(toks2).long(), tc,
                              torch.from_numpy(table), _scalar(16),
                              _scalar(5), frontier=_scalar(4))
    assert tl.shape == (1, 1, VOCAB)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)

    tables = np.array([[1, 2, 3, 0, 0, 0],
                       [4, 5, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    tok = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
    pos = np.array([21, 9, MAX_LEN], np.int32)
    with jpa.kernel_scope("lax"):
        jl, jc = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                                jnp.asarray(pos),
                                block_tables=jnp.asarray(tables))
    tl, tc = tm.decode_step(torch.from_numpy(tok).long(), tc,
                            torch.from_numpy(pos).long(),
                            block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(tl.numpy()[:2], _np(jl)[:2], atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jk)[1:],
                                   atol=ATOL)
        np.testing.assert_allclose(tv.numpy()[1:], np.asarray(jv)[1:],
                                   atol=ATOL)


def test_frontier_tensor_equals_frontier_int(models):
    """A 0-d frontier picks the same row as the int frontier, at the
    first, a middle and the last position of the chunk."""
    _, tm = models
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, VOCAB, (1, 16))).long()
    table = torch.tensor([[1, 2, 0, 0, 0, 0]], dtype=torch.int32)
    for f in (0, 7, 15):
        got = [tm.prefill_chunk(toks, tm.init_paged_cache(NB, BS, MAX_LEN),
                                table, 0, 16, frontier=fr)[0]
               for fr in (f, _scalar(f))]
        torch.testing.assert_close(got[1], got[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (c) and (d) greedy streams through the front door; no graphs on the CPU
# ---------------------------------------------------------------------------

_JAX_STREAMS = {}


def _jax_stream(jm, seed):
    if seed not in _JAX_STREAMS:
        eng = JEngine(jm, paged_kernel="lax", **ENGINE)
        _JAX_STREAMS[seed] = _stream(JScheduler(eng), _jobs(seed))
    return _JAX_STREAMS[seed]


@pytest.mark.parametrize("ir_optim", [True, False])
def test_front_door_stream_token_exact_vs_jax_either_ir_optim(models,
                                                              ir_optim):
    """switch_ir_optim(True) (graphs on the card) and (False) (eager)
    both serve the JAX paged engine's greedy streams token for token; on
    the CPU both run the eager static-buffer programs and capture no
    graph, so both compile counters stay 0, as on the JAX eager path."""
    jm, tm = models
    cfg = inference.Config()
    assert cfg.ir_optim() is True                 # the default is on
    cfg.switch_ir_optim(ir_optim)
    assert cfg.ir_optim() is ir_optim
    cfg.enable_llm_engine(paged=True, num_slots=4, max_len=64, block_size=8,
                          prefill_len=16, paged_kernel="plain", device="cpu")
    pred = inference.create_llm_predictor(cfg, model=tm)
    eng = pred.engine
    assert eng.cuda_graph is ir_optim
    assert _stream(pred.scheduler, _jobs(1)) == _jax_stream(jm, 1)
    for prog in (eng.wave_program, eng.prefill_program):
        assert prog.graphed is False and prog.graphs == {}
        assert prog.compiles == 0 and prog.replays == 0
    assert eng.decode_compiles == 0 and eng.prefill_compiles == 0
    assert eng.decode_waves_run > 0 and eng.prefill_chunks_run > 0


def test_wave_logits_are_the_programs_output(models):
    """The engine exposes the latest wave's and chunk's f32 logits (the
    programs' outputs, which chip_smoke.py's parity recorder reads under
    graph replay): they are the model's logits for those inputs."""
    _, tm = models
    eng = PagedServingEngine(tm, paged_kernel="plain", device="cpu",
                             **ENGINE)
    sched = Scheduler(eng)
    prompt = list(range(3, 24))                   # two chunks of 16
    req = sched.submit(prompt=prompt, max_tokens=3)
    sched.step()
    assert eng.prefill_chunks_run == 1 and eng.last_wave_logits is None
    sched.step()
    slot = req.slot
    lo = eng.last_prefill_logits
    assert lo.shape == (VOCAB,) and lo.dtype == torch.float32
    assert req.output_tokens[0] == int(torch.argmax(lo))
    wave = eng.last_wave_logits
    assert wave.shape == (4, VOCAB) and wave.dtype == torch.float32
    assert req.output_tokens[1] == int(torch.argmax(wave[slot]))
    # the wave's row is the model's decode step for the lane's inputs
    fresh = tm.init_paged_cache(eng.block_pool.num_blocks, 8, 64)
    table = torch.from_numpy(eng._tables[slot:slot + 1].copy())
    tm.prefill_chunk(torch.tensor([prompt[:16]]), fresh, table, 0, 16)
    tm.prefill_chunk(torch.tensor([prompt[16:] + [0] * 11]), fresh, table,
                     16, 5, frontier=4)
    want, _ = tm.decode_step(torch.tensor([[req.output_tokens[0]]]), fresh,
                             torch.tensor([len(prompt)]),
                             block_tables=table)
    np.testing.assert_allclose(wave[slot].numpy(), want[0, 0].numpy(),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# (e) sampling through the static-buffer programs
# ---------------------------------------------------------------------------

def _sampled(tm, seed, jobs):
    eng = PagedServingEngine(tm, paged_kernel="plain", device="cpu",
                             seed=seed, **ENGINE)
    sched = Scheduler(eng)
    reqs = [sched.submit(prompt=p, max_tokens=m, do_sample=True,
                         temperature=0.8, top_k=50, top_p=0.9,
                         logit_bias={5: 1.5} if i == 0 else None)
            for i, (p, m) in enumerate(jobs)]
    noise = []
    while sched.step():
        noise.append(eng.wave_inputs.tensors["gumbel"].clone())
    return [r.output_tokens for r in reqs], noise


def test_sampled_streams_replay_from_the_seed_through_static_buffers(models):
    """The programs draw their Gumbel noise in place into the static
    buffers from the engine's generator: a fresh engine with the same
    seed replays the sampled streams exactly, every wave draws fresh
    noise, and another seed draws other streams."""
    _, tm = models
    jobs = _jobs(6, n=4)
    toks, noise = _sampled(tm, 7, jobs)
    again, noise_again = _sampled(tm, 7, jobs)
    assert toks == again
    assert len(noise) == len(noise_again) and all(
        torch.equal(a, b) for a, b in zip(noise, noise_again))
    drawn = [g for g in noise if bool(torch.any(g != 0))]
    assert len(drawn) >= 2
    assert all(not torch.equal(a, b) for a, b in zip(drawn, drawn[1:]))
    other, _ = _sampled(tm, 8, jobs)
    assert other != toks


def test_first_token_with_device_knobs_matches_jax():
    """The prefill program's selection with 0-d tensor knobs (sample on
    and off) picks JAX's token from the same logits, bias and Gumbel
    draw; without noise it is the greedy pick."""
    rng = np.random.default_rng(9)
    lo = rng.standard_normal(64).astype(np.float32) * 3
    bias = np.zeros(64, np.float32)
    bias[11] = 4.0
    key = jax.random.PRNGKey(8)
    g = np.asarray(jax.random.gumbel(key, (64,), jnp.float32))
    for sample, temp, top_k, top_p in ((True, 0.7, 5, 1.0),
                                       (True, 1.3, 0, 0.8),
                                       (False, 0.7, 5, 0.9)):
        want = jengine._select_first_token(
            jnp.asarray(lo), jnp.asarray(sample), jnp.float32(temp),
            jnp.int32(top_k), jnp.float32(top_p), jnp.asarray(bias), key)
        got = tengine._select_first_token(
            torch.from_numpy(lo), torch.tensor(sample),
            torch.tensor(temp, dtype=torch.float32), _scalar(top_k),
            torch.tensor(top_p, dtype=torch.float32),
            torch.from_numpy(bias), torch.tensor(g))
        assert got.shape == () and int(got) == int(want)
    greedy = tengine._select_first_token(
        torch.from_numpy(lo), torch.tensor(True),
        torch.tensor(0.7), _scalar(5), torch.tensor(0.9),
        torch.from_numpy(bias), None)
    assert int(greedy) == int(np.argmax(lo + bias))
