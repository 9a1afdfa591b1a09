"""The port's dense serving path against paddle_tpu's: GPT `prefill` and
the dense `decode_step`, the dense ServingEngine under the Scheduler,
and the `create_llm_predictor` front door with a Config left at its
defaults.

Small GPT (2 layers, hidden 64, 4 heads, vocab 128, max_seq_len 256,
dropout 0, initializer_range 0.2 so the logits distinguish tokens), both
packages built from the same numpy weights (`load_jax_state`), inputs
from numpy seeds. Tolerance on logits and cache rows: f32, within
1e-4 x max(1, |ref|). The JAX prefill runs its Pallas K1 in interpret
mode at a 128 bucket and XLA's dense softmax at a 16 bucket; the port
runs the plain flash path wherever it takes the kernel route.
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
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.serving import (PagedServingEngine, Scheduler,
                                      ServingEngine)
from paddle_tpu_torch.serving import engine as tengine

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB = 128
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=256, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)
RTOL = 1e-4
ENGINE = dict(num_slots=4, max_len=48, prefill_len=32)


def _pair(**over):
    cfg = dict(SMALL, **over)
    pt.seed(7)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    lim = RTOL * np.maximum(1.0, np.abs(want))
    err = np.abs(got - want)
    assert (err <= lim).all(), f"{what}: max err {err.max()}"


# ---------------------------------------------------------------------------
# prefill and the dense decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 16, 127, 128, 129, 768])
def test_kernel_len_is_the_dispatchers_rule(n):
    """The prefill pads to `kernel_len(n)`, a length flash attention's
    dispatcher sends to the kernel route; n itself goes there only when
    it equals its own `kernel_len`."""
    def eligible(s):
        q = torch.zeros(1, s, 2, 16)
        return tfa._kernel_eligible(q, q, None, 0.0, True)
    c = tfa.kernel_len(n)
    assert c % 128 == 0 and n <= c < n + 128 and eligible(c)
    assert eligible(n) == (n == c)


@pytest.mark.parametrize("bucket,max_seq_len,window,route", [
    (128, 256, None, "k1"),     # JAX K1 (interpret) / the port's plain
    (128, 256, 40, "k1"),
    (16, 256, None, "k1"),      # the port pads 16 -> 128
    (16, 64, None, "dense"),    # 128 > max_seq_len: both dense
])
def test_prefill_matches_jax(bucket, max_seq_len, window, route):
    """Frontier logits and the cache rows [0, P) against JAX prefill, on
    the route the port's shape rule picks."""
    jm, tm = _pair(max_seq_len=max_seq_len, attn_window=window)
    assert tm.prefill_route(bucket) == route
    rng = np.random.default_rng(bucket + max_seq_len)
    ids = rng.integers(0, VOCAB, (1, bucket)).astype(np.int32)
    frontier = bucket - 3
    max_len = min(max_seq_len, 160)
    jl, jc = jm.prefill(Tensor(jnp.asarray(ids)), max_len,
                        dtype=jnp.float32, frontier=jnp.int32(frontier))
    before = dict(tfa.routes)
    tl, tc = tm.prefill(torch.from_numpy(ids).long(), max_len,
                        frontier=torch.tensor(frontier))
    went = {k: tfa.routes[k] - before[k] for k in before}
    assert went == ({"kernel": 2, "dense": 0} if route == "k1"
                    else {"kernel": 0, "dense": 2})
    assert tl.shape == (1, 1, VOCAB)
    _close(tl.numpy(), _np(jl), "frontier logits")
    for (jk, jv), (tk, tv) in zip(jc, tc):
        assert tk.shape == (1, 4, max_len, 16)
        _close(tk.numpy()[:, :, :bucket], np.asarray(jk)[:, :, :bucket],
               "K rows")
        _close(tv.numpy()[:, :, :bucket], np.asarray(jv)[:, :, :bucket],
               "V rows")
        assert not tk[:, :, bucket:].any() and not tv[:, :, bucket:].any()


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_step_matches_jax(vector, window):
    """Eight dense decode steps over three rows, lockstep (scalar pos)
    or each row at its own depth ([B] pos, one row parked at the
    horizon), give the JAX logits and caches."""
    jm, tm = _pair(attn_window=window)
    L = 24
    rng = np.random.default_rng(3 + vector)
    jc = jm.init_cache(3, L)
    tc = tm.init_cache(3, L)
    start = np.array([0, 4, L] if vector else [2, 2, 2], np.int32)
    for t in range(8):
        tok = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
        pos = np.minimum(start + t, L) if vector else int(start[0] + t)
        jl, jc = jm.decode_step(Tensor(jnp.asarray(tok)), jc,
                                jnp.asarray(pos) if vector
                                else jnp.int32(pos))
        tl, tc = tm.decode_step(torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long() if vector
                                else pos)
        live = slice(0, 2) if vector else slice(0, 3)
        _close(tl.numpy()[live], _np(jl)[live], f"step {t} logits")
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk.numpy(), np.asarray(jk), "K cache")
        _close(tv.numpy(), np.asarray(jv), "V cache")


def test_cache_horizon_is_checked(models):
    _, tm = models
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.init_cache(2, SMALL["max_seq_len"] + 1)
    with pytest.raises(ValueError, match="bucket"):
        tm.prefill(torch.zeros((1, 40), dtype=torch.long), 32)


# ---------------------------------------------------------------------------
# the dense engine under the scheduler
# ---------------------------------------------------------------------------

def _jobs(seed, n=10):
    """Mixed lengths over 4 slots: retire and refill mid-stream, some
    requests running into the 48-token horizon."""
    rng = np.random.RandomState(seed)
    jobs = [(rng.randint(0, VOCAB, (int(rng.randint(1, 33)),)).tolist(),
             int(rng.randint(2, 24))) for _ in range(n)]
    jobs[n // 2] = (rng.randint(0, VOCAB, (30,)).tolist(), 25)
    return jobs


def _stream(sched, jobs, eos=None, **kw):
    reqs = [sched.submit(prompt=p, max_tokens=m, eos_token_id=eos, **kw)
            for p, m in jobs]
    sched.run()
    return [(r.output_tokens, r.finish_reason) for r in reqs]


_JAX_STREAMS = {}


def _jax_stream(jm, seed, eos=None):
    key = (seed, eos)
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _stream(JScheduler(JEngine(jm, **ENGINE)),
                                    _jobs(seed), eos)
    return _JAX_STREAMS[key]


def test_dense_stream_token_exact_vs_jax_and_paged(models):
    """Greedy streams of the dense engine equal the JAX dense engine's
    token for token (eos, max_tokens and the horizon among the finish
    reasons) and the port's paged engine's; a prompt over the bucket is
    rejected by both; a greedy stream runs one prefill per admission."""
    jm, tm = models
    want = _jax_stream(jm, 1)
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    assert eng.prefill_route == "k1"
    assert eng.describe() == {"engine": "dense", "num_slots": 4,
                              "max_len": 48, "prefill_len": 32, "seed": 0,
                              "cache_dtype": "float32"}
    got = _stream(Scheduler(eng), _jobs(1))
    assert got == want
    assert {r for _, r in got} == {"max_tokens", "length"}
    assert eng.prefill_chunks_run == len(_jobs(1))
    assert eng.last_starved_slots == []
    assert (eng.decode_compiles, eng.prefill_compiles) == (0, 0)
    paged = PagedServingEngine(tm, num_slots=4, max_len=48, block_size=8,
                               prefill_chunk_len=16, device="cpu")
    assert _stream(Scheduler(paged), _jobs(1)) == want
    # eos: a token the first stream emits mid-way
    eos = want[0][0][2]
    got = _stream(Scheduler(ServingEngine(tm, device="cpu", **ENGINE)),
                  _jobs(1), eos)
    assert got == _jax_stream(jm, 1, eos)
    assert "eos" in {r for _, r in got}
    for sched in (Scheduler(ServingEngine(tm, device="cpu", **ENGINE)),
                  JScheduler(JEngine(jm, **ENGINE))):
        with pytest.raises(ValueError, match="prefill bucket"):
            sched.submit(prompt=list(range(33)), max_tokens=2)


def test_retired_rows_are_rewritten_by_the_next_prefill(models):
    """A slot refilled after a long request holds the new prompt's rows
    (and zeros past them), whatever the old request left there."""
    _, tm = models
    eng = ServingEngine(tm, num_slots=1, max_len=48, prefill_len=32,
                        device="cpu")
    sched = Scheduler(eng)
    sched.generate(list(range(1, 31)), max_tokens=17)
    eng2 = ServingEngine(tm, num_slots=1, max_len=48, prefill_len=32,
                         device="cpu")
    prompt = [5, 6, 7]
    first = sched.generate(prompt, max_tokens=1)
    assert first == Scheduler(eng2).generate(prompt, max_tokens=1)
    for (k1, v1), (k2, v2) in zip(eng._caches, eng2._caches):
        assert torch.equal(k1[:, :, :32], k2[:, :, :32])
        assert not k1[:, :, 32:47].any() and not v1[:, :, 32:47].any()


def test_sampled_streams_match_jax_with_the_same_gumbel(models,
                                                        monkeypatch):
    """Every request samples, so the JAX engine splits one key per
    program run and the port draws noise once per run: fed the Gumbel
    noise of JAX's key chain, the port's sampled first tokens and waves
    pick JAX's tokens."""
    jm, tm = models
    jobs = _jobs(4, n=6)
    knobs = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    want = _stream(JScheduler(JEngine(jm, seed=3, **ENGINE)), jobs,
                   **knobs)
    chain = {"key": jax.random.PRNGKey(3)}

    def gumbel_(buf, gen):
        chain["key"], sub = jax.random.split(chain["key"])
        buf.copy_(torch.tensor(np.asarray(
            jax.random.gumbel(sub, tuple(buf.shape), jnp.float32))))
        return buf
    monkeypatch.setattr(tengine, "gumbel_", gumbel_)
    eng = ServingEngine(tm, seed=3, device="cpu", **ENGINE)
    assert _stream(Scheduler(eng), jobs, **knobs) == want


def test_front_door_with_default_config_serves_dense(models):
    """create_llm_predictor(Config(), model) arms the Config's defaults
    (the dense engine, on the model's device) and serves JAX's streams;
    an armed Config serves dense unless paged=True."""
    jm, tm = models
    pred = inference.create_llm_predictor(inference.Config(), model=tm)
    assert type(pred.engine) is ServingEngine
    assert (pred.engine.num_slots, pred.engine.max_len,
            pred.engine.prefill_len) == (4, 256, 256)
    prompt = _jobs(2)[0][0]
    assert pred.generate(prompt, max_tokens=6) == JScheduler(
        JEngine(jm, num_slots=4, max_len=256)).generate(prompt,
                                                         max_tokens=6)
    cfg = inference.Config().enable_llm_engine(device="cpu", **ENGINE)
    pred = inference.create_llm_predictor(cfg, model=tm)
    assert type(pred.engine) is ServingEngine
    assert pred.engine.describe()["prefill_len"] == 32
    assert _stream(pred.scheduler, _jobs(1)) == _jax_stream(jm, 1)
    # speculative=True arms the paged speculative engine, which needs a
    # draft (tests/test_torch_spec.py serves it)
    spec = inference.Config().enable_llm_engine(speculative=True,
                                                device="cpu")
    assert spec._llm_opts["paged"] and spec._llm_opts["spec_k"] == 4
    with pytest.raises(ValueError, match="draft"):
        inference.create_llm_predictor(spec, model=tm)
