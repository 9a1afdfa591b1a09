"""The port's pipeline parallelism (paddle_tpu_torch.distributed.pipeline
and .pipeline_1f1b: one process a stage) against the JAX package's
(one SPMD program) on the same weights and batches.

The port's side runs in one world of 4 gloo ranks on the CPU
(`tests/torch_dist_ranks.py`); this process runs the JAX side over its
8-device virtual mesh. The JAX steps' results do not depend on the mesh
they are given (GSPMD computes the same function on any layout: the JAX
package's own tests hold them to the serial model), so each JAX schedule
runs once, GPipe on {'dp': 2, 'pp': 2} and 1F1B on {'pp': 2, 'mp': 2}
(BASELINE configs[3]'s shape), and serves every port mesh of its
schedule.

- The tiny GPT (4 layers, hidden 64, 4 heads, vocab 128, sequence 16,
  batch 8 in 4 microbatches) through PipelineTrainStep (GPipe,
  recompute) and OneF1BTrainStep over {'pp': 2}, {'pp': 4}, {'dp': 2,
  'pp': 2} and {'pp': 2, 'mp': 2}, AdamW 1e-3, 2 steps: losses within
  1e-4 relative of the JAX step's, the first step's gradients within
  1e-4 x max(1, max|g|) of the serial model's, the synced parameters
  within 2e-4 (tests/test_pipeline.py:96-97), the step count.
- With a global-norm clip (AdamW's `grad_clip`, ClipGradByGlobalNorm at
  CLIP, under the step-1 norm), both schedules over {'pp': 2} and
  {'pp': 2, 'mp': 2} against one JAX PipelineTrainStep with the clip:
  the norm is the whole model's (every stage, the tied embedding once),
  as `last_grad_norm()` reports it on every rank.
- The non-GPT PipelineParts model of tests/test_pipeline_1f1b.py:103-153
  through both schedules over {'pp': 2} and {'pp': 4}, SGD, 3 steps,
  against the JAX OneF1BTrainStep and PipelineTrainStep.
- `simulate_1f1b`'s tables equal the JAX package's for (S, M) in {(2,
  4), (4, 8)}; `pipeline_apply` equals the serial composition and
  `pipeline_1f1b` autodiff's (the JAX test's toy).
- hapi.Model over fleet's pipeline step fits and saves the whole model.
- The twin of examples/pipeline_mnist.py through fleet on {'dp': 2,
  'pp': 2}, from the JAX example's initial weights, converges as
  tests/test_examples.py asks of the JAX example.
"""
import json

import jax
import numpy as np
import pytest

import paddle_tpu as pj
import torch_dist_ranks as ranks
from paddle_tpu.distributed.mesh import make_mesh
from paddle_tpu.distributed.pipeline import PipelineParts, PipelineTrainStep
from paddle_tpu.distributed.pipeline_1f1b import (OneF1BTrainStep,
                                                  simulate_1f1b)
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import pipeline_1f1b as t1f1b

N = 4
RNG = np.random.RandomState(0)
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
               max_seq_len=16, dropout=0.0, attn_dropout=0.0)
IDS = RNG.randint(0, 128, (8, 16)).astype("int32")
MLP_X = RNG.randn(32, 8).astype("f4")
MLP_Y = (MLP_X.sum(-1, keepdims=True) > 0).astype("f4")
PPA_W = (RNG.randn(N, 1, 8, 8) * 0.3).astype("f4")
PPA_X = RNG.randn(3, 2, 8).astype("f4")
F1_W = (RNG.randn(N, 16, 16) * 0.3).astype("f4")
F1_HEAD = RNG.randn(16, 1).astype("f4")
F1_X = RNG.randn(6, 4, 16).astype("f4")
F1_LAB = RNG.randn(6, 4, 1).astype("f4")
MESHES = ("pp2", "pp4", "dp2pp2", "pp2mp2")
CLIP = 0.5
JOBS = ("pp_steps", "pp_parts", "pp_apply", "pp_mnist", "pp_hapi")


@pytest.fixture(autouse=True)
def reset_mesh():
    yield
    import paddle_tpu.distributed.mesh as mesh_mod
    mesh_mod._current_mesh = None


def _state(m):
    return {k: np.asarray(v.numpy(), "f4") for k, v in m.state_dict().items()}


class _Fc(pj.nn.Layer):
    def __init__(self, a, b):
        super().__init__()
        self.fc = pj.nn.Linear(a, b)

    def forward(self, x):
        return self.fc(x)


class _Block(pj.nn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc = pj.nn.Linear(h, h)

    def forward(self, x):
        return pj.nn.functional.tanh(self.fc(x))


class _MLPRegressor(pj.nn.Layer):
    """tests/test_pipeline_1f1b.py's non-GPT model."""

    def __init__(self, d_in=8, h=16, depth=4):
        super().__init__()
        self.embed = _Fc(d_in, h)
        self.trunk = pj.nn.LayerList([_Block(h) for _ in range(depth)])
        self.head = _Fc(h, 1)

    def pipeline_parts(self, loss_fn):
        head = self.head

        def head_call(post_p, pre_p, h, labels):
            out, _ = head.functional_call(post_p, {}, pj.Tensor(h))
            return loss_fn(out, pj.Tensor(labels))._data

        return PipelineParts(self.embed, list(self.trunk), self.head,
                             head_call)


class _MnistMLP(pj.nn.Layer):
    """examples/pipeline_mnist.py's PipelinedMLP (its weights only)."""

    def __init__(self, depth=4):
        super().__init__()
        self.stem = _Fc(784, 128)
        self.trunk = pj.nn.LayerList([_Fc(128, 128) for _ in range(depth)])
        self.head = _Fc(128, 10)


@pytest.fixture(scope="module")
def jax_models():
    pj.seed(7)
    g = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    pj.seed(0)
    mlp = _MLPRegressor()
    pj.seed(1)          # the example's seed, before it builds the model
    return {"gpt": g, "mlp": mlp, "mnist": _MnistMLP()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_models):
    inputs = {"tp_ids": IDS, "gpt_cfg": np.array(json.dumps(GPT_CFG)),
              "mlp_x": MLP_X, "mlp_y": MLP_Y, "ppa_w": PPA_W,
              "ppa_x": PPA_X, "f1_w": F1_W, "f1_head": F1_HEAD,
              "f1_x": F1_X, "f1_lab": F1_LAB, "pp_clip": np.array(CLIP)}
    inputs.update({f"gpt:{k}": v
                   for k, v in _state(jax_models["gpt"]).items()})
    inputs.update({f"mlp:{k}": v
                   for k, v in _state(jax_models["mlp"]).items()})
    inputs.update({f"mnist:{k}": v
                   for k, v in _state(jax_models["mnist"]).items()})
    tmp = tmp_path_factory.mktemp("pp")
    inputs["ckpt_dir"] = np.array(str(tmp / "ckpt"))
    return ranks.World(tmp, N, JOBS, inputs)


def _copy(base, make):
    m = make()
    m.set_state_dict({k: v.numpy() for k, v in base.state_dict().items()})
    return m


@pytest.fixture(scope="module")
def jax_refs(jax_models):
    base = jax_models["gpt"]
    make = lambda: jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    m = _copy(base, make)
    params, buffers = m.functional_state()

    def f(p):
        o, _ = m.functional_call(p, buffers, pj.Tensor(IDS))
        return jgpt.gpt_pretrain_loss(o, pj.Tensor(IDS))._data

    grads = {k: np.asarray(v) for k, v in jax.grad(f)(params).items()}
    out = {"grads": grads}
    for sched, cls, shape in (("gpipe", PipelineTrainStep,
                               {"dp": 2, "pp": 2}),
                              ("1f1b", OneF1BTrainStep, {"pp": 2, "mp": 2}),
                              ("clip", PipelineTrainStep,
                               {"pp": 2, "mp": 2})):
        m = _copy(base, make)
        make_mesh(shape)
        clip = {"grad_clip": pj.nn.ClipGradByGlobalNorm(CLIP)} \
            if sched == "clip" else {}
        step = cls(m, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters(), **clip),
            num_micro=4)
        losses = [float(step(IDS, IDS).numpy()) for _ in range(2)]
        step.sync()
        out[sched] = (losses, _state(m))
    return out


def _check_gpt_case(res, case, n_ranks, losses, grads, params):
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


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh", MESHES)
def test_gpt_pipeline_matches_jax(world, jax_refs, mesh, sched):
    losses, params = jax_refs[sched]
    _check_gpt_case(world.job("pp_steps"), f"{sched}_{mesh}",
                    2 if mesh == "pp2" else N, losses, jax_refs["grads"],
                    params)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh", ["pp2", "pp2mp2"])
def test_gpt_pipeline_global_norm_clip_matches_jax(world, jax_refs, mesh,
                                                   sched):
    """Each stage scales its gradients by the whole model's norm: the
    step-1 norm every rank reports is the serial model's (the tied
    embedding counted once), and the clipped trajectory the JAX
    step's."""
    losses, params = jax_refs["clip"]
    grads = jax_refs["grads"]
    norm = float(np.sqrt(sum(np.sum(np.square(g.astype("f8")))
                             for g in grads.values())))
    assert norm > 2 * CLIP
    res = world.job("pp_steps")
    case = f"{sched}_{mesh}_clip"
    n_ranks = 2 if mesh == "pp2" else N
    for r in range(n_ranks):
        np.testing.assert_allclose(res[r][f"{case}/grad_norms"][0], norm,
                                   rtol=1e-4)
    _check_gpt_case(res, case, n_ranks, losses, grads, params)


@pytest.fixture(scope="module")
def jax_mlp(jax_models):
    base = jax_models["mlp"]
    out = {}
    for sched, cls, shape in (("gpipe", PipelineTrainStep, {"pp": 2}),
                              ("1f1b", OneF1BTrainStep, {"pp": 4})):
        m = _copy(base, _MLPRegressor)
        make_mesh(shape)
        step = cls(m, pj.nn.MSELoss(), pj.optimizer.SGD(
            learning_rate=0.05, parameters=m.parameters()), num_micro=8)
        losses = [float(step(MLP_X, MLP_Y).numpy()) for _ in range(3)]
        step.sync()
        out[sched] = (losses, _state(m))
    return out


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh", ["pp2", "pp4"])
def test_parts_model_pipeline_matches_jax(world, jax_mlp, mesh, sched):
    losses, params = jax_mlp[sched]
    res = world.job("pp_parts")
    case = f"{sched}_{mesh}"
    for r in range(2 if mesh == "pp2" else N):
        np.testing.assert_allclose(res[r][f"{case}/losses"], losses,
                                   rtol=1e-4)
        assert int(res[r][f"{case}/step"]) == 3
    for k, p in params.items():
        np.testing.assert_allclose(res[0][f"{case}/p:{k}"], p, rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8)])
def test_simulate_1f1b_tables_equal_jax(S, M):
    want, got = simulate_1f1b(S, M), t1f1b.simulate_1f1b(S, M)
    for k in ("DO_F", "F_M", "DO_B", "B_M", "RECV_F", "F_RM", "RECV_B",
              "B_RM"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["T"] == want["T"]
    assert got["max_inflight"] == want["max_inflight"]
    assert got["bubble_fraction"] == want["bubble_fraction"]


def test_gpipe_table_orders_every_transfer():
    """The GPipe table: every microbatch forward on every stage, then
    every backward; each arrival lands on the tick its consumer runs."""
    for S, M in ((2, 4), (4, 8)):
        t = tpipe.simulate_gpipe(S, M)
        assert t["DO_F"].sum() == S * M and t["DO_B"].sum() == S * M
        last_f = max(tk for tk in range(t["T"]) if t["DO_F"][tk].any())
        first_b = min(tk for tk in range(t["T"]) if t["DO_B"][tk].any())
        assert last_f < first_b
        for tk in range(t["T"]):
            for r in range(S):
                if t["RECV_F"][tk, r]:
                    assert t["DO_F"][tk, r] and \
                        t["F_M"][tk, r] == t["F_RM"][tk, r]
                if t["RECV_B"][tk, r]:
                    assert t["DO_B"][tk, r] and \
                        t["B_M"][tk, r] == t["B_RM"][tk, r]


def test_pipeline_apply_matches_serial_stack(world):
    want = PPA_X.copy()
    for s in range(N):
        want = np.tanh(want @ PPA_W[s, 0])
    for res in world.job("pp_apply"):
        np.testing.assert_allclose(res["out"], want, rtol=2e-5, atol=2e-5)


def test_pipeline_1f1b_matches_autodiff(world):
    """`pipeline_1f1b` (4 stages, 6 microbatches) on the JAX test's toy:
    the mean loss, each stage's weight grad, the head's and the first
    stage's input cotangents equal autodiff of the serial composition
    (tests/test_pipeline_1f1b.py:60-100's tolerances)."""
    for res in world.job("pp_apply"):
        got, want = res["f1_loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for key in ("f1_gw", "f1_ghead", "f1_dx"):
            np.testing.assert_allclose(res[key][0], res[key][1], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_hapi_model_fits_and_saves_through_a_pipeline_step(world,
                                                          jax_models):
    """hapi.Model over fleet's pipeline strategy on {'dp': 2, 'pp': 2}:
    the step is the pipeline's, the losses fall, and `save` writes the
    whole model as every rank holds it after the step's `sync` (the
    first stage's parameters included on the last stage's ranks)."""
    init = _state(jax_models["mlp"])
    for res in world.job("pp_hapi"):
        assert str(res["step"]) == "PipelineTrainStep"
        assert int(res["global_step"]) == 4
        losses = res["losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        for k, v in init.items():
            np.testing.assert_array_equal(res[f"saved:{k}"],
                                          res[f"model:{k}"], err_msg=k)
            assert not np.array_equal(res[f"saved:{k}"], v), k


def test_pipeline_mnist_twin_converges(world):
    """tests/test_examples.py:43-47's bar for the JAX example: converged,
    the last five losses' mean under 0.6 x the first five's."""
    for res in world.job("pp_mnist"):
        losses = res["losses"]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        assert str(res["step"]) == "PipelineTrainStep"
        assert json.loads(str(res["mesh"])) == {"dp": 2, "pp": 2}
        assert last < first * 0.6, (first, last)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
@pytest.mark.parametrize("mesh", MESHES)
def test_a_stage_holds_its_blocks_alone(world, jax_models, mesh, sched):
    """After a step, a stage's rank keeps the weights of its own blocks
    and no other stage's: the embeddings on the first stage, the final
    norm and the tied word embedding on the last; over 'mp' not even
    those whole, only its shards of the split ones. The parameter bytes
    it holds are those."""
    params = _state(jax_models["gpt"])
    split = {n for n, p in jax_models["gpt"].named_parameters()
             if "mp" in tuple(getattr(p, "sharding", None) or ())} \
        if mesh.endswith("mp2") else set()
    L = GPT_CFG["num_layers"]
    res = world.job("pp_steps")
    case = f"{sched}_{mesh}"
    for r in range(2 if mesh == "pp2" else N):
        got = res[r]
        s = int(got[f"{case}/stage"])
        S = 4 if mesh == "pp4" else 2
        lps = L // S
        own = {n for n in params
               if any(n.startswith(f"gpt.blocks.{i}.")
                      for i in range(s * lps, (s + 1) * lps))}
        if s == 0:
            own |= {n for n in params if n.startswith("gpt.embeddings.")}
        if s == S - 1:
            own |= {n for n in params if n.startswith("gpt.ln_f.")}
            own.add("gpt.embeddings.word_embeddings.weight")
        assert set(got[f"{case}/resident"]) == own - split, (r, s)
        want = 4 * sum(params[n].size // (2 if n in split else 1)
                       for n in own)
        assert int(got[f"{case}/param_nbytes"]) == want, (r, s)
