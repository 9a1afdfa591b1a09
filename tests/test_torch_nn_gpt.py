"""The slice's path on the CPU, against the JAX package: `layer_gpt`
(chip_smoke.py's GPT-2 built only from `nn.Embedding`, `nn.LayerNorm`,
`nn.Linear` and `nn.functional`, written once for either package) at 2
layers, 64 wide, seq 128 (the flash kernels' route: JAX's Pallas K1-K3 in
interpret mode, the port's plain blocks), loaded from the port
GPTForPretraining's state dict: loss and every gradient on both
packages and the module's loss, then 3 AdamW steps over
`layer.parameters()` against the JAX eager optimizer. And a sparse
embedding (`sparse=True`, a row-sparse SelectedRows gradient) trained by
Adam with and without `lazy_mode` and by SGD, against the JAX eager
`step()`.

Tolerances: the loss within 1e-5 relative; gradients and weights within
1e-4 x max(1, max|ref|).
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import optimizer as j_opt
from paddle_tpu_torch import optimizer as t_opt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_nn_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gclose(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


def test_layer_gpt_on_both_packages_and_adamw_steps():
    cs = _chip_smoke()
    from paddle_tpu_torch.nlp import (GPTConfig, GPTForPretraining,
                                      gpt_pretrain_loss)
    from paddle_tpu_torch.ops import flash_attention as t_fa
    j_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2, num_heads=1,
                    max_seq_len=128, dropout=0.0, attn_dropout=0.0)
    model = GPTForPretraining(cfg, device="cpu", seed=3)
    state = {k: v.numpy() for k, v in cs.layer_gpt_state(model).items()}
    ids = np.random.RandomState(2).randint(0, 96, (2, 128)).astype("int32")
    res = {}
    for P, fa, opt_mod in ((pt, t_fa, t_opt), (pj, j_fa, j_opt)):
        layer = cs.layer_gpt(P, fa.flash_attention, 96, 64, 1, 2, 128)
        assert layer.set_state_dict(state) == ([], [])
        assert list(layer.state_dict()) == list(state)
        opt = opt_mod.AdamW(learning_rate=1e-3,
                            parameters=layer.parameters())
        losses, grads = [], None
        for step in range(3):
            x = P.to_tensor(ids)
            loss = cs.layer_gpt_loss(P, layer(x), x)
            loss.backward()
            if step == 0:
                grads = {k: p.grad.numpy().copy()
                         for k, p in layer.named_parameters()}
            losses.append(float(loss))
            opt.step()
            opt.clear_grad()
        res[P] = (losses, grads, {k: v.numpy().copy() for k, v in
                                  layer.state_dict().items()})
    ref = float(gpt_pretrain_loss(model(torch.from_numpy(ids)),
                                  torch.from_numpy(ids)).detach())
    for P in (pt, pj):
        assert abs(res[P][0][0] - ref) <= FWD_RTOL * abs(ref)
    for a, b in zip(res[pt][0], res[pj][0]):
        assert abs(a - b) <= FWD_RTOL * abs(b), (res[pt][0], res[pj][0])
    assert res[pt][0][-1] < res[pt][0][0]
    for k, want in res[pj][1].items():
        gclose(res[pt][1][k], want)
    for k, want in res[pj][2].items():
        gclose(res[pt][2][k], want)


def _sparse_run(P, opt_mod, make_opt, table, ids, cots):
    emb = P.nn.Embedding(table.shape[0], table.shape[1], sparse=True)
    emb.set_state_dict({"weight": table})
    opt = make_opt(opt_mod, emb.parameters())
    out = []
    for t in range(len(ids)):
        loss = (emb(P.to_tensor(ids[t])) * P.to_tensor(cots[t])).sum()
        loss.backward()
        g = emb.weight.grad
        assert type(g).__name__ == "SelectedRows", type(g)
        opt.step()
        opt.clear_grad()
        out.append(emb.weight.numpy().copy())
    return out


@pytest.mark.parametrize("name,make_opt", [
    ("adam_lazy", lambda m, ps: m.Adam(learning_rate=0.1, parameters=ps,
                                       lazy_mode=True)),
    ("adamw_lazy", lambda m, ps: m.AdamW(learning_rate=0.1, parameters=ps,
                                         lazy_mode=True)),
    ("adam_dense", lambda m, ps: m.Adam(learning_rate=0.1, parameters=ps)),
    ("sgd", lambda m, ps: m.SGD(learning_rate=0.5, parameters=ps)),
])
def test_sparse_embedding_trajectories_match_jax(name, make_opt):
    r = np.random.RandomState(4)
    table = r.randn(12, 4).astype("f4")
    ids = [np.array([[1, 5, 1], [7, 5, 3]], "int32"),
           np.array([[0, 1, 2], [2, 2, 9]], "int32"),
           np.array([[5, 5, 5], [11, 1, 6]], "int32")]
    cots = [r.randn(2, 3, 4).astype("f4") for _ in ids]
    got = _sparse_run(pt, t_opt, make_opt, table, ids, cots)
    want = _sparse_run(pj, j_opt, make_opt, table, ids, cots)
    for g, w in zip(got, want):
        gclose(g, w)
    touched = np.unique(np.concatenate([i.ravel() for i in ids]))
    untouched = np.setdiff1d(np.arange(12), touched)
    if name != "adam_dense":
        # row-sparse updates leave the rows no id read alone
        np.testing.assert_array_equal(got[-1][untouched], table[untouched])
    else:
        # without lazy_mode the moments decay on every row: the rows
        # touched earlier keep moving after their last id
        assert not np.array_equal(got[-1][3], got[0][3])
