"""The port's GPT and LLaMA as `nn.Layer`s, against the JAX package's
models: state-dict keys, shapes and layout; a JAX `state_dict()` carried
across by `set_state_dict` and by `load_jax_state` (loss and every
gradient, through the Paddle surface with Tensor inputs); 3 AdamW steps
over `model.parameters()` against the JAX eager optimizer; the port's
`save` read by `paddle_tpu.load` into a JAX model; greedy `generate`
token for token, and its program kept across calls; forward pre/post
hooks, `train()`/`eval()` and `functional_call`.

Models: 2 layers, 64 wide, 4 heads (LLaMA over 2 KV heads), vocab 256,
seq 128 (the flash kernels' route: JAX's Pallas K1-K3 in interpret
mode, the port's plain blocks), initializer_range 0.2 so the logits are
O(1..10). Weights and ids are numpy arrays from seeds handed to both
packages.

Tolerances (f32, the two sum in different orders): the loss within
1e-5 relative; every gradient within 1e-4 x max(1, max|ref|); logits
atol 1e-4; AdamW losses rtol 1e-3 (a gradient near 0 whose sign differs
between summation orders moves one weight by 2 lr); greedy ids equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.nlp import llama as jllama
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nlp import gpt as tgpt
from paddle_tpu_torch.nlp import llama as tllama

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

GPT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0, attn_dropout=0.0,
           initializer_range=0.2)
LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=128, initializer_range=0.2)
IDS = np.random.RandomState(0).randint(0, 256, (2, 128)).astype("int32")
FAMILIES = {
    "gpt": (jgpt.GPTForPretraining, jgpt.GPTConfig, jgpt.gpt_pretrain_loss,
            tgpt.GPTForPretraining, tgpt.GPTConfig, tgpt.gpt_pretrain_loss,
            GPT),
    "llama": (jllama.LlamaForCausalLM, jllama.LlamaConfig,
              jllama.llama_pretrain_loss, tllama.LlamaForCausalLM,
              tllama.LlamaConfig, tllama.llama_pretrain_loss, LLAMA)}


def _jax(family, seed=3, **over):
    jcls, jcfg, *_, cfg = FAMILIES[family]
    pj.seed(seed)
    return jcls(jcfg(**dict(cfg, **over)))


def _port(family, seed=0, **over):
    *_, tcls, tcfg, _, cfg = FAMILIES[family]
    return tcls(tcfg(**dict(cfg, **over)), device="cpu", seed=seed)


def _jstate(jm):
    return {k: v.numpy() for k, v in jm.state_dict().items()}


def _loss_and_grads(family, jm, tm):
    """(JAX loss, port loss, JAX grads, port grads) of one forward and
    backward, the port in the Paddle surface (Tensors in and out)."""
    jloss, tloss = FAMILIES[family][2], FAMILIES[family][5]
    ji = JTensor(jnp.asarray(IDS))
    jl = jloss(jm(ji), ji)
    jl.backward()
    ti = pt.to_tensor(IDS, place="cpu")
    logits = tm(ti)
    assert isinstance(logits, pt.Tensor)
    tl = tloss(logits, ti)
    assert isinstance(tl, pt.Tensor)
    tl.backward()
    return (float(jl.numpy()), float(tl),
            {n: p.grad.numpy() for n, p in jm.named_parameters()},
            {n: p.grad.numpy() for n, p in tm.named_parameters()})


def _held(family, jm, tm):
    jv, tv, jg, tg = _loss_and_grads(family, jm, tm)
    assert tv == pytest.approx(jv, rel=1e-5)
    assert list(tg) == list(jg)
    for n, want in jg.items():
        lim = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tg[n], want, atol=lim, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_state_dict_keys_shapes_and_layout_equal_jax(family):
    jm, tm = _jax(family), _port(family)
    assert isinstance(tm, tnn.Layer)
    assert isinstance(tm.gpt if family == "gpt" else tm.model, tnn.Layer)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd)
    for k, v in jsd.items():
        assert tuple(tsd[k].shape) == tuple(v.shape), k
    qkv = ("gpt.blocks.0.attn.qkv_proj.weight" if family == "gpt"
           else "model.layers.0.self_attn.qkv_proj.weight")
    assert tsd[qkv].shape[0] == 64          # [in, out], as Paddle's
    assert all(isinstance(p, pt.Parameter) for p in tm.parameters())
    assert len(tm.parameters()) == len(jm.parameters())
    # one seed gives one set of weights
    again = _port(family)
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tsd[k].numpy(), err_msg=k)


@pytest.mark.parametrize("carry", ["set_state_dict", "load_jax_state"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_jax_weights_give_the_jax_loss_and_gradients(family, carry):
    jm, tm = _jax(family), _port(family, seed=5)
    tm.train()
    if carry == "set_state_dict":
        assert tm.set_state_dict(_jstate(jm)) == ([], [])
    else:
        tgpt.load_jax_state(tm, _jstate(jm))
    _held(family, jm, tm)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_three_adamw_steps_over_parameters_match_jax_eager(family):
    jm, tm = _jax(family), _port(family)
    tm.set_state_dict(_jstate(jm))
    tm.train()
    jloss, tloss = FAMILIES[family][2], FAMILIES[family][5]
    jopt = pj.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters())
    topt_ = topt.AdamW(1e-3, parameters=tm.parameters())
    ji, ti = JTensor(jnp.asarray(IDS)), pt.to_tensor(IDS, place="cpu")
    jl, tl = [], []
    for _ in range(3):
        loss = jloss(jm(ji), ji)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = tloss(tm(ti), ti)
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_port_save_is_read_by_the_jax_package(family, tmp_path):
    """A port model with its own weights, trained one SGD step, saved by
    the port's `save` and loaded by `paddle_tpu.load` into a fresh JAX
    model: the JAX logits equal the port's."""
    tm = _port(family, seed=7).train()
    opt = topt.SGD(0.1, parameters=tm.parameters())
    ti = pt.to_tensor(IDS, place="cpu")
    FAMILIES[family][5](tm(ti), ti).backward()
    opt.step()
    path = str(tmp_path / "model.pdparams")
    pt.save(tm.state_dict(), path)
    jm = _jax(family, seed=11)
    assert jm.set_state_dict(pj.load(path)) == ([], [])
    jm.eval()
    tm.eval()
    want = jm(JTensor(jnp.asarray(IDS))).numpy()
    got = tm(ti).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_greedy_generate_equals_jax_and_keeps_one_program(family,
                                                          use_cache):
    jgen = jgpt.generate
    jm, tm = _jax(family), _port(family)
    tm.set_state_dict(_jstate(jm))
    jm.eval()
    ids = np.random.default_rng(1).integers(0, 256, (2, 6)).astype("int32")
    out = jgen(jm, ids, max_new_tokens=10, use_cache=use_cache)
    want = np.asarray(out._data if isinstance(out, JTensor) else out)
    got = tgpt.generate(tm, ids, max_new_tokens=10, use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), want)
    if use_cache:
        (run,) = tgpt._gen_programs(tm).values()
        again = tgpt.generate(tm, ids, max_new_tokens=10, use_cache=True)
        np.testing.assert_array_equal(again.numpy(), want)
        assert list(tgpt._gen_programs(tm).values()) == [run]


def test_generate_keeps_at_most_eight_programs():
    tm = _port("gpt")
    ids = np.zeros((1, 4), "int32")
    for n in range(1, 11):
        tgpt.generate(tm, ids, max_new_tokens=n, use_cache=True)
    kept = [spec[1] for spec in tgpt._gen_programs(tm)]
    assert kept == [4 + n for n in range(3, 11)]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_forward_hooks_match_jax(family):
    """A pre-hook on the second block shifting its input and a post-hook
    on the final norm scaling its output act alike in both packages;
    removing them restores the plain logits."""
    jm, tm = _jax(family), _port(family)
    tm.set_state_dict(_jstate(jm))
    jm.eval()

    def parts(m):
        body = m.gpt if family == "gpt" else m.model
        blocks = body.blocks if family == "gpt" else body.layers
        return blocks[1], (body.ln_f if family == "gpt" else body.norm)

    handles = []
    for m in (jm, tm):
        blk, norm = parts(m)
        handles.append(blk.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] + 0.5,)))
        handles.append(norm.register_forward_post_hook(
            lambda layer, inputs, out: out * 2.0))
    ti = pt.to_tensor(IDS, place="cpu")
    want = jm(JTensor(jnp.asarray(IDS))).numpy()
    np.testing.assert_allclose(tm(ti).numpy(), want, atol=2e-4)
    for h in handles:
        h.remove()
    plain = jm(JTensor(jnp.asarray(IDS))).numpy()
    assert float(np.abs(plain - want).max()) > 1.0
    np.testing.assert_allclose(tm(ti).numpy(), plain, atol=1e-4)


def test_train_and_eval_reach_every_sublayer_and_dropout():
    tm = _port("gpt", dropout=0.2, attn_dropout=0.2)
    assert not any(layer.training for layer in tm.sublayers(True))
    ti = pt.to_tensor(IDS, place="cpu")
    np.testing.assert_array_equal(tm(ti).numpy(), tm(ti).numpy())
    tm.train()
    assert all(layer.training for layer in tm.sublayers(True))
    assert not np.array_equal(tm(ti).numpy(), tm(ti).numpy())
    tm.eval()
    assert not any(layer.training for layer in tm.sublayers(True))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_functional_call_runs_other_weights_and_keeps_its_own(family):
    """functional_call over a JAX model's weights gives the JAX logits
    and the gradient of the tensors it was given; the model's own
    weights stay as they were."""
    jm, tm = _jax(family), _port(family, seed=4)
    jm.eval()
    own = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in _jstate(jm).items()}
    out, new_buffers = tm.functional_call(params, {}, torch.tensor(IDS))
    assert new_buffers == {}
    want = jm(JTensor(jnp.asarray(IDS))).numpy()
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    out._data.float().sum().backward()
    assert all(p.grad is not None for p in params.values())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), own[k], err_msg=k)
        assert v.grad is None
