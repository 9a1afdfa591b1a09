"""The port's sequence parallelism (paddle_tpu_torch.distributed
.ring_attention and .ulysses, GPT's `sequence_parallel`) against the JAX
package's on the same meshes.

The port's side runs in one world of 4 gloo ranks on the CPU
(`tests/torch_dist_ranks.py`), each rank holding its (batch, sequence)
shard; this process runs the JAX side on the global arrays over its
8-device virtual mesh. Ring and Ulysses attention over {'dp': 2, 'sp':
2} and {'sp': 4}, causal and not, q, k, v [2, 4, 512, 64] f32 (shards of
128 or 256 positions, the kernels' lengths; the port's blocks are the
plain twins of K1-K3 here): each rank's output within 1e-5 of the JAX
output's shard, and the gradients of sum(out ** 2) within 1e-4 x max(1,
max|g|). The JAX Ulysses reference runs the Pallas K1-K3 in interpret
mode, and what it computes does not depend on the mesh (each device
attends over the whole sequence of its heads): it runs once a causal
mode, on {'sp': 4}, and serves both meshes. Then the tiny GPT with
sequence_parallel "ring" and "ulysses" (2 layers, 128 wide, 2 heads of
64, vocab 256, 2 x 256 tokens) through ShardedTrainStep over {'dp': 2,
'sp': 2}, 3 AdamW steps against the JAX ShardedTrainStep's losses
within rtol 2e-4 (tests/test_ring_attention.py:75,
tests/test_ulysses.py:60 train the same model).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import torch_dist_ranks as ranks
from paddle_tpu.distributed.mesh import make_mesh
from paddle_tpu.distributed.ring_attention import ring_attention
from paddle_tpu.distributed.sharded import ShardedTrainStep as JSharded
from paddle_tpu.distributed.ulysses import ulysses_attention
from paddle_tpu.nlp import gpt as jgpt

torch.set_num_threads(1)

N = 4
RNG = np.random.RandomState(0)
Q, K, V = (RNG.randn(2, 4, 512, 64).astype("f4") for _ in range(3))
SP_CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=256, dropout=0.0, attn_dropout=0.0)
SP_IDS = RNG.randint(0, 256, (2, 256)).astype("int32")
MESHES = {"dp2sp": {"dp": 2, "sp": 2}, "sp": {"sp": 4}}
# Ulysses first: the rank world runs while its slow JAX reference does
FNS = {"ulysses": ulysses_attention, "ring": ring_attention}


@pytest.fixture(autouse=True)
def reset_mesh():
    yield
    import paddle_tpu.distributed.mesh as mesh_mod
    mesh_mod._current_mesh = None


@pytest.fixture(scope="module")
def jax_gpt():
    pj.seed(9)
    return jgpt.GPTForPretraining(jgpt.GPTConfig(**SP_CFG))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_gpt):
    inputs = {"q": Q, "k": K, "v": V,
              "sp_cfg": np.array(json.dumps(SP_CFG)), "sp_ids": SP_IDS}
    inputs.update({f"sp:{k}": np.asarray(v.numpy(), "f4")
                   for k, v in jax_gpt.state_dict().items()})
    return ranks.World(tmp_path_factory.mktemp("sp"), N,
                       ("attention", "gpt_sp"), inputs)


@functools.lru_cache(maxsize=None)
def _jax_reference(fn, mesh, causal):
    """The JAX function's output on the global q, k, v over `mesh`, and
    the gradients of sum(out ** 2): the vjp of 2 * out, from one
    forward."""
    make_mesh(MESHES[mesh])
    args = tuple(jnp.asarray(a) for a in (Q, K, V))
    out, vjp = jax.vjp(lambda *a: FNS[fn](*a, causal=causal), *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(2 * out)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fn", list(FNS))
def test_attention_matches_jax_forward_and_backward(world, fn, mesh, causal):
    out, grads = _jax_reference(fn, "sp" if fn == "ulysses" else mesh,
                                causal)
    key = f"{mesh}_{fn}_{int(causal)}"
    for res in world.job("attention"):
        b0, bn, s0, sn = (int(x) for x in res[f"{mesh}_slice"])
        sl = (slice(b0, b0 + bn), slice(None), slice(s0, s0 + sn))
        np.testing.assert_allclose(res[key + "_out"], out[sl], rtol=1e-5,
                                   atol=1e-5)
        for name, g in zip("qkv", grads):
            scale = max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(res[f"{key}_d{name}"], g[sl],
                                       rtol=0, atol=1e-4 * scale,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gpt_sequence_parallel_step_matches_jax(world, jax_gpt, mode):
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(
        sequence_parallel=True if mode == "ring" else mode, **SP_CFG))
    jm.set_state_dict({k: v.numpy() for k, v in jax_gpt.state_dict().items()})
    make_mesh({"dp": 2, "sp": 2})
    step = JSharded(jm, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    want = [float(step(SP_IDS, SP_IDS).numpy()) for _ in range(3)]
    for res in world.job("gpt_sp"):
        np.testing.assert_allclose(res[mode], want, rtol=2e-4)
