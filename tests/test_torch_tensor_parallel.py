"""The port's tensor parallelism (paddle_tpu_torch.distributed
.parallel_layers, GPT's and LLaMA's Megatron split, ShardedTrainStep
over 'mp') against the JAX package's on the same weights and batches.

The port's side runs in one world of 4 gloo ranks on the CPU
(`tests/torch_dist_ranks.py`), each rank holding its shard of every
split weight; this process runs the JAX side over its 8-device virtual
mesh, where GSPMD splits the full weights by the same hints.

- The four parallel layers and `split`: outputs and every gradient (the
  rank's shards gathered) within 1e-5 of the JAX layers', for
  sum(out * cot) with a seeded cot.
- GPT (4 layers, hidden 64, 4 heads, vocab 128, sequence 16) and LLaMA
  (the same with 2 KV heads) through ShardedTrainStep over {'mp': 2}
  and {'dp': 2, 'mp': 2} (ZeRO-1), AdamW 1e-3 with a global-norm clip
  at 1.0, 2 steps, against the JAX ShardedTrainStep on {'dp': 2, 'mp':
  2} with ZeRO-1 (its results do not depend on the mesh: GSPMD computes
  the same function on any layout, so one JAX run a model serves both
  port meshes): losses within 1e-4 relative, the first step's gradients
  within 1e-4 x max(1, max|g|) of the serial JAX gradients, the synced
  parameters within 2e-4 (tests/test_pipeline.py:96-97), the step
  count.
- Lamb, and SGD under per-tensor clipping, over {'mp': 2} land where one
  rank's plain TrainStep does (whole-tensor norms).
- The port's models carry the JAX models' sharding hints (copies too).
- LLaMA over {'mp': 4} with 2 KV heads raises ValueError.
- With dropout > 0 the replicated parameters stay equal on both ranks of
  every mp slice, and each rank's sharded regions draw from a generator
  of its own.
- The fused head over a vocabulary split on 'mp'
  (`vocab_parallel_chunked_lm_loss`, each rank streaming its rows of the
  table) against the JAX `chunked_lm_loss` over the whole vocabulary:
  the loss within 1e-6 relative, dh and dw within 1e-5 x max(1,
  max|g|); GPT with `fused_head_loss=True` over {'mp': 2} and, at
  ZeRO-3, over {'dp': 2, 'mp': 2}, against the JAX step as above.
- A rank holds its shards alone: the model's full weight of every split
  parameter is released (ZeRO-3: of every parameter), and the bytes it
  holds are its shards' (ZeRO-3: its chunks of them).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pj
import torch_dist_ranks as ranks
from paddle_tpu.distributed import parallel_layers as jtp
from paddle_tpu.distributed.mesh import make_mesh
from paddle_tpu.distributed.sharded import ShardedTrainStep as JSharded
from paddle_tpu.nlp import gpt as jgpt, llama as jllama

N = 4
RNG = np.random.RandomState(0)
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
               max_seq_len=16, dropout=0.0, attn_dropout=0.0)
LLAMA_CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
                 num_kv_heads=2, intermediate_size=128, max_seq_len=16)
IDS = RNG.randint(0, 128, (8, 16)).astype("int32")
X16 = RNG.randn(4, 5, 16).astype("f4")
X32 = RNG.randn(4, 5, 32).astype("f4")
LAYER_IDS = RNG.randint(0, 64, (4, 5)).astype("int64")
LOGITS = RNG.randn(6, 64).astype("f4")
LABELS = RNG.randint(0, 64, (6,)).astype("int64")
FH_H = RNG.randn(24, 16).astype("f4")
FH_W = (RNG.randn(64, 16) * 0.5).astype("f4")
FH_LAB = np.where(RNG.rand(24) < 0.2, -1,
                  RNG.randint(0, 64, (24,))).astype("int64")
LAYERS = {"col_gather": (lambda: jtp.ColumnParallelLinear(16, 32), X16, 32),
          "col_local": (lambda: jtp.ColumnParallelLinear(
              16, 32, gather_output=False), X16, 32),
          "row": (lambda: jtp.RowParallelLinear(32, 16), X32, 16),
          "row_parallel_in": (lambda: jtp.RowParallelLinear(
              32, 16, input_is_parallel=True), X32, 16),
          "emb": (lambda: jtp.VocabParallelEmbedding(64, 16), LAYER_IDS,
                  16)}
COTS = {k: RNG.randn(4, 5, d).astype("f4") for k, (_, _, d) in
        LAYERS.items()}


@pytest.fixture(autouse=True)
def reset_mesh():
    yield
    import paddle_tpu.distributed.mesh as mesh_mod
    mesh_mod._current_mesh = None


def _state(m):
    return {k: np.asarray(v.numpy(), "f4") for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def jax_layers():
    out = {}
    for name, (make, _, _) in LAYERS.items():
        pj.seed(3)
        out[name] = make()
    return out


@pytest.fixture(scope="module")
def jax_models():
    pj.seed(7)
    g = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    pj.seed(8)
    ll = jllama.LlamaForCausalLM(jllama.LlamaConfig(**LLAMA_CFG))
    return {"gpt": g, "llama": ll}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_layers, jax_models):
    inputs = {"tpl_x": X16, "tpl_x32": X32, "tpl_ids": LAYER_IDS,
              "tpl_logits": LOGITS, "tpl_lab": LABELS, "tp_ids": IDS,
              "fh_h": FH_H, "fh_w": FH_W, "fh_lab": FH_LAB,
              "gpt_cfg": np.array(json.dumps(GPT_CFG)),
              "llama_cfg": np.array(json.dumps(LLAMA_CFG))}
    for name, layer in jax_layers.items():
        inputs.update({f"tpl:{name}.{k}": v
                       for k, v in _state(layer).items()})
        inputs[f"tpl_cot_{name}"] = COTS[name]
    for kind, m in jax_models.items():
        inputs.update({f"{kind}:{k}": v for k, v in _state(m).items()})
    return ranks.World(tmp_path_factory.mktemp("tp"), N,
                       ("tp_layers", "tp_steps", "tp_dropout",
                        "tp_fused_head"), inputs)


def _jax_layer(layer, x, cot):
    """The JAX layer's output and the gradients of sum(out * cot)."""
    params, buffers = layer.functional_state()
    is_ids = x.dtype.kind == "i"

    def f(p, xx):
        out, _ = layer.functional_call(p, buffers, pj.Tensor(xx))
        return jnp.sum(out._data * cot), out._data

    argnums = (0,) if is_ids else (0, 1)
    grads, out = jax.grad(f, argnums=argnums, has_aux=True)(
        params, jnp.asarray(x))
    return (np.asarray(out), {k: np.asarray(v) for k, v in grads[0].items()},
            None if is_ids else np.asarray(grads[1]))


@pytest.mark.parametrize("name", list(LAYERS))
def test_parallel_layers_match_jax(world, jax_layers, name):
    _, x, _ = LAYERS[name]
    out, gp, gx = _jax_layer(jax_layers[name], x, COTS[name])
    for r, res in enumerate(world.job("tp_layers")):
        want = out if name != "col_local" else np.split(out, N, -1)[r]
        np.testing.assert_allclose(res[f"{name}_out"], want, rtol=1e-5,
                                   atol=1e-5)
        if gx is not None:
            want = gx if name != "row_parallel_in" else \
                np.split(gx, N, -1)[r]
            np.testing.assert_allclose(res[f"{name}_dx"], want, rtol=1e-5,
                                       atol=1e-5)
        for k, g in gp.items():
            np.testing.assert_allclose(res[f"{name}_d:{k}"], g, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_parallel_cross_entropy_matches_jax(world):
    z, y = jnp.asarray(LOGITS), jnp.asarray(LABELS)

    def f(zz):
        return jtp.ParallelCrossEntropy()(pj.Tensor(zz), pj.Tensor(y))._data

    loss, dz = jax.value_and_grad(f)(z)
    for res in world.job("tp_layers"):
        np.testing.assert_allclose(res["pce_loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(res["pce_dz"], np.asarray(dz), rtol=1e-5,
                                   atol=1e-6)


def test_split_builds_the_parallel_layers(world):
    """`split` over the world's 'mp' slice equals the unsplit layer drawn
    from the same seed (linear gathered, embedding summed)."""
    for res in world.job("tp_layers"):
        for k in ("split_linear", "split_emb"):
            np.testing.assert_allclose(res[k], res[k + "_ref"], rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def jax_refs(jax_models):
    """Per model: the serial gradients at the initial weights, and the
    JAX ShardedTrainStep's losses and synced parameters after 2 clipped
    AdamW steps."""
    out = {}
    for kind, base in jax_models.items():
        cls, cfg = (jgpt.GPTForPretraining, jgpt.GPTConfig(**GPT_CFG)) \
            if kind == "gpt" else (jllama.LlamaForCausalLM,
                                   jllama.LlamaConfig(**LLAMA_CFG))
        m = cls(cfg)
        m.set_state_dict({k: v.numpy() for k, v in base.state_dict().items()})
        params, buffers = m.functional_state()

        def f(p, m=m, buffers=buffers):
            o, _ = m.functional_call(p, buffers, pj.Tensor(IDS))
            return jgpt.gpt_pretrain_loss(o, pj.Tensor(IDS))._data

        grads = {k: np.asarray(v) for k, v in jax.grad(f)(params).items()}
        m = cls(cfg)
        m.set_state_dict({k: v.numpy() for k, v in base.state_dict().items()})
        make_mesh({"dp": 2, "mp": 2})
        step = JSharded(m, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters(),
            grad_clip=pj.nn.ClipGradByGlobalNorm(1.0)), zero_stage=1)
        losses = [float(step(IDS, IDS).numpy()) for _ in range(2)]
        step.sync()
        out[kind] = (losses, grads, _state(m))
    return out


@pytest.mark.parametrize("case", ["gpt_mp2", "gpt_dp2mp2", "llama_mp2",
                                  "llama_dp2mp2", "gpt_fused_mp2",
                                  "gpt_z3fused_dp2mp2"])
def test_sharded_step_over_mp_matches_jax(world, jax_refs, case):
    losses, grads, params = jax_refs[case.split("_")[0]]
    res = world.job("tp_steps")
    n_ranks = 2 if case.endswith("_mp2") else N
    for r in range(n_ranks):
        np.testing.assert_allclose(res[r][f"{case}/losses"], losses,
                                   rtol=1e-4)
        assert int(res[r][f"{case}/step"]) == 2
    got = res[0]
    for k, g in grads.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[f"{case}/g:{k}"], g, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    for k, p in params.items():
        np.testing.assert_allclose(got[f"{case}/p:{k}"], p, rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", ["lamb", "clipnorm"])
def test_whole_tensor_norms_over_mp(world, name):
    """Over {'mp': 2}, Lamb's trust ratios and per-tensor clipping (SGD
    under ClipGradByNorm) sum a split parameter's squares over the
    slice: 2 steps land where one rank's plain TrainStep does. (Lamb's
    ratio of two norms barely moves when both are a shard's; the clip's
    absolute norm is what tells whole from shard.)"""
    for res in world.job("tp_steps")[:2]:
        np.testing.assert_allclose(res[f"{name}_sharded/losses"],
                                   res[f"{name}_plain/losses"], rtol=1e-5)
        keys = [k.split("/", 1)[1] for k in res
                if k.startswith(f"{name}_plain/p:")]
        assert len(keys) > 40
        for k in keys:
            np.testing.assert_allclose(res[f"{name}_sharded/{k}"],
                                       res[f"{name}_plain/{k}"], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _hints(model):
    return {n: tuple(p.sharding) for n, p in model.named_parameters()
            if getattr(p, "sharding", None) is not None}


def test_sharding_hints_are_the_jax_models(jax_models):
    """The port's GPT, LLaMA (tied and untied) and BERT mark the
    parameters the JAX models mark, with the same PartitionSpecs, and a
    copy of a model keeps them (a spec copies by its parts)."""
    import copy
    from paddle_tpu.nlp import bert as jbert
    from paddle_tpu_torch.nlp import bert as tbert, gpt as tgpt
    from paddle_tpu_torch.nlp import llama as tllama
    bert_cfg = dict(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, max_seq_len=16)
    pairs = [(jax_models["gpt"], tgpt.GPTForPretraining(
                 tgpt.GPTConfig(**GPT_CFG), device="cpu")),
             (jax_models["llama"], tllama.LlamaForCausalLM(
                 tllama.LlamaConfig(**LLAMA_CFG), device="cpu")),
             (jllama.LlamaForCausalLM(jllama.LlamaConfig(
                 tie_embeddings=False, **LLAMA_CFG)),
              tllama.LlamaForCausalLM(tllama.LlamaConfig(
                  tie_embeddings=False, **LLAMA_CFG), device="cpu")),
             (jbert.BertForPretraining(jbert.BertConfig(**bert_cfg)),
              tbert.BertForPretraining(tbert.BertConfig(**bert_cfg),
                                       device="cpu"))]
    for jm, tm in pairs:
        want = _hints(jm)
        assert want and _hints(tm) == want
        assert _hints(copy.deepcopy(tm)) == want


def test_llama_kv_heads_must_divide_over_mp(world):
    for res in world.job("tp_steps"):
        assert "do not divide over mp = 4" in str(res["llama_mp4"]), \
            res["llama_mp4"]


def test_mp_replicas_stay_equal_with_dropout(world):
    res = world.job("tp_dropout")
    for r in range(N):
        assert np.all(np.isfinite(res[r]["losses"]))
    rep = [k for k in res[0] if k.startswith("rep:")]
    assert any("ln_1" in k for k in rep) and \
        not any("qkv_proj" in k for k in rep)
    # ranks 2i and 2i + 1 form an mp slice: their replicated state and
    # losses are the same, their sharded regions' generators differ
    for a, b in ((0, 1), (2, 3)):
        assert int(res[a]["mp_rank"]) == 0 and int(res[b]["mp_rank"]) == 1
        np.testing.assert_array_equal(res[a]["losses"], res[b]["losses"])
        for k in rep:
            np.testing.assert_array_equal(res[a][k], res[b][k], err_msg=k)
        assert int(res[a]["sharded_seed"]) != int(res[b]["sharded_seed"])


def test_fused_head_over_mp_matches_jax_chunked_lm_loss(world):
    """Each rank of an 'mp' slice of 2 streams its half of the table's
    rows in chunks of 16 (2 a rank), the max and the sums taken over the
    slice: the loss, dh and the table's dw against the JAX
    `chunked_lm_loss` over the whole vocabulary (ignored rows
    included)."""
    from paddle_tpu.ops.chunked_ce import chunked_lm_loss as jchunked

    def f(h, w):
        return jchunked(h, w, jnp.asarray(FH_LAB), -1, 16)

    loss, (dh, dw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(FH_H), jnp.asarray(FH_W))
    for res in world.job("tp_fused_head"):
        np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-6)
        for key, want in (("dh", dh), ("dw", dw)):
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(res[key], want, rtol=0,
                                       atol=1e-5 * scale, err_msg=key)


@pytest.mark.parametrize("case", ["gpt_fused_mp2", "gpt_z3fused_dp2mp2"])
def test_a_rank_holds_its_shards_alone_over_mp(world, jax_models, case):
    """After a step over 'mp' the model's full weight of every split
    parameter (ZeRO-3: of every parameter) is released on the rank, and
    the parameter bytes it holds are its shards and the replicated
    weights (ZeRO-3: its chunks over 'dp' of those, 16-element
    aligned)."""
    hints = _hints(jax_models["gpt"])
    split = {k for k, spec in hints.items() if "mp" in spec}
    params = _state(jax_models["gpt"])
    assert split and len(split) < len(params)
    z3 = "z3" in case

    def local(k):
        return params[k].size // 2 if k in split else params[k].size
    if z3:
        want = 4 * sum(-(-(-(-local(k) // 2)) // 16) * 16 for k in params)
    else:
        want = 4 * sum(local(k) for k in params)
    res = world.job("tp_steps")
    for r in range(2 if case.endswith("_mp2") else N):
        released = set(params) - set(res[r][f"{case}/resident"])
        assert released == (set(params) if z3 else split), sorted(released)
        assert int(res[r][f"{case}/param_nbytes"]) == want
