"""The port's `generate` against paddle_tpu's, both `use_cache` paths, on
GPT and on a GQA LLaMA.

Small GPT (2 layers, hidden 64, 4 heads, vocab 128, max_seq_len 256,
dropout 0, initializer_range 0.2), both packages built from the same
numpy weights (`load_jax_state`), prompts from a numpy seed. Greedy ids
must be equal; sampling draws from the port's own seeded generator, so
it is held to greedy at top_k=1 and to itself under one seed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.nlp.gpt import GPTConfig as JConfig
from paddle_tpu.nlp.gpt import GPTForPretraining as JGPT
from paddle_tpu.nlp.gpt import generate as jgenerate
from paddle_tpu.nn.decode import top_k_top_p_filtering as jfilter
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.nlp import llama as tllama
from paddle_tpu_torch.nn.decode import top_k_top_p_filtering
from paddle_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

VOCAB = 128
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=256, dropout=0.0, attn_dropout=0.0,
             initializer_range=0.2)


@pytest.fixture(scope="module")
def models():
    pt.seed(9)
    jm = JGPT(JConfig(**SMALL))
    jm.eval()
    tm = tgpt.GPTForPretraining(tgpt.GPTConfig(**SMALL), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _prompt(b=2, n=5, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, n)).astype(
        np.int32)


def _jax_ids(jm, ids, **kw):
    out = jgenerate(jm, ids, **kw)
    return np.asarray(out._data if isinstance(out, Tensor) else out)


@pytest.mark.parametrize("use_cache", [False, True])
def test_greedy_ids_equal_jax(models, use_cache):
    jm, tm = models
    ids = _prompt()
    want = _jax_ids(jm, ids, max_new_tokens=12, use_cache=use_cache)
    got = tgpt.generate(tm, ids, max_new_tokens=12, use_cache=use_cache)
    assert got.dtype == torch.long and got.shape == (2, 17)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_cache", [False, True])
def test_eos_pads_after_finish_like_jax(models, use_cache):
    """eos: a token the greedy stream emits mid-way; every later id of
    that row is eos, as in JAX."""
    jm, tm = models
    ids = _prompt(seed=1)
    free = tgpt.generate(tm, ids, max_new_tokens=10, use_cache=use_cache)
    eos = int(free[0, 8])
    want = _jax_ids(jm, ids, max_new_tokens=10, use_cache=use_cache,
                    eos_token_id=eos)
    got = tgpt.generate(tm, ids, max_new_tokens=10, use_cache=use_cache,
                        eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    first = int(np.argmax(got[0, 5:].numpy() == eos)) + 5
    assert (got[0, first:] == eos).all()


@pytest.mark.parametrize("use_cache", [False, True])
def test_sampling_top_k_1_is_greedy_and_a_seed_replays(models, use_cache):
    _, tm = models
    ids = _prompt(seed=2)
    greedy = tgpt.generate(tm, ids, max_new_tokens=8, use_cache=use_cache)
    one = tgpt.generate(tm, ids, max_new_tokens=8, do_sample=True, top_k=1,
                        seed=5, use_cache=use_cache)
    assert torch.equal(one, greedy)
    kw = dict(max_new_tokens=8, do_sample=True, top_k=20, top_p=0.9,
              temperature=0.8, use_cache=use_cache)
    a = tgpt.generate(tm, ids, seed=11, **kw)
    assert torch.equal(a, tgpt.generate(tm, ids, seed=11, **kw))
    assert ((a >= 0) & (a < VOCAB)).all()


def test_cached_and_full_forward_agree_on_the_kernel_route(models):
    """A 128-token buffer sends the full forward through flash
    attention's kernel route (the plain path here); both paths give the
    same greedy ids, and the model's training mode comes back."""
    _, tm = models
    ids = _prompt(b=1, n=122, seed=3)
    tm.train()
    before = tfa.routes["kernel"]
    full = tgpt.generate(tm, ids, max_new_tokens=6)
    assert tfa.routes["kernel"] - before == 6 * SMALL["num_layers"]
    assert tm.training
    tm.eval()
    assert torch.equal(full, tgpt.generate(tm, ids, max_new_tokens=6,
                                           use_cache=True))
    assert not tm.training
    with pytest.raises(ValueError, match="max_seq_len"):
        tgpt.generate(tm, ids, max_new_tokens=200)


# LLaMA: the JAX package's generate tests' GQA model (tests/test_llama.py)
LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=32, initializer_range=0.2)


@pytest.fixture(scope="module")
def llamas():
    pt.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**LLAMA))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**LLAMA), device="cpu")
    tgpt.load_jax_state(tm, {k: v.numpy()
                             for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("use_cache", [False, True])
def test_llama_greedy_ids_equal_jax(llamas, use_cache):
    """generate works on any causal LM of the port: a GQA LLaMA's greedy
    ids equal JAX's on both paths, the prompt kept."""
    jm, tm = llamas
    ids = np.random.RandomState(0).randint(0, 64, (2, 4)).astype(np.int32)
    want = _jax_ids(jm, ids, max_new_tokens=10, use_cache=use_cache)
    got = tgpt.generate(tm, ids, max_new_tokens=10, use_cache=use_cache)
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :4].numpy(), ids)
    assert len(set(got[:, 4:].flatten().tolist())) >= 3


@pytest.mark.parametrize("use_cache", [False, True])
def test_llama_overlong_decode_rejected(llamas, use_cache):
    """A decode past the rope table raises, as JAX's does."""
    jm, tm = llamas
    prompt = np.zeros((1, 30), np.int32)
    with pytest.raises(ValueError, match="RoPE"):
        _jax_ids(jm, prompt, max_new_tokens=8, use_cache=use_cache)
    with pytest.raises(ValueError, match="RoPE"):
        tgpt.generate(tm, prompt, max_new_tokens=8, use_cache=use_cache)


def test_top_k_top_p_filtering_matches_jax():
    rng = np.random.default_rng(4)
    lo = rng.standard_normal((3, 50)).astype(np.float32) * 3
    for k, p in ((0, 1.0), (5, 1.0), (0, 0.7), (10, 0.5)):
        want = np.asarray(jfilter(lo, top_k=k, top_p=p)._data)
        got = top_k_top_p_filtering(torch.from_numpy(lo), top_k=k,
                                    top_p=p).numpy()
        np.testing.assert_array_equal(got, want)
