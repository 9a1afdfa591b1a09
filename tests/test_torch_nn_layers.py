"""Each `nn` layer class of the port against its JAX twin from the same
weights: both built the same way (the same state-dict keys and shapes),
the JAX layer's `state_dict()` arrays loaded into the port's by
`set_state_dict`, then the same seeded inputs through both in training
mode (dropouts in eval mode): the outputs, the buffers after the call,
and the gradients of a fixed random projection of the outputs for every
float input and every parameter. `nn.utils`' weight_norm, spectral_norm
and the parameter/vector converters the same way.

Tolerances: f32 outputs within 1e-5 x max(1, |ref|); gradients within
1e-4 x max(1, max|g|).
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def u(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("f4")


def ii(shape, hi, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype("int32")


X4 = u((2, 3, 5, 5))
SIGN = np.where(u((3, 4), 9) > 0, 1.0, -1.0).astype("f4")
PROBS = u((3, 4), 3, 0.1, 0.9)


def L(ctor, *inputs, eval_mode=False, labels=()):
    """A layer's constructor (over a package's `nn`) and its inputs;
    float inputs are differentiated unless listed in `labels`."""
    return dict(ctor=ctor, inputs=inputs, eval=eval_mode, labels=labels)


LAYERS = {
    "Linear": L(lambda nn: nn.Linear(4, 3), u((2, 4))),
    "Embedding": L(lambda nn: nn.Embedding(7, 3, padding_idx=-1),
                   ii((2, 5), 7)),
    "Dropout": L(lambda nn: nn.Dropout(0.3), u((3, 4)), eval_mode=True),
    "Dropout2D": L(lambda nn: nn.Dropout2D(0.3), X4, eval_mode=True),
    "Dropout3D": L(lambda nn: nn.Dropout3D(0.3), u((1, 2, 2, 2, 2)),
                   eval_mode=True),
    "AlphaDropout": L(lambda nn: nn.AlphaDropout(0.3), u((3, 4)),
                      eval_mode=True),
    "Flatten": L(lambda nn: nn.Flatten(), X4),
    "Identity": L(lambda nn: nn.Identity(), u((3, 4))),
    "Pad1D": L(lambda nn: nn.Pad1D([1, 2], mode="reflect"), u((2, 3, 5))),
    "Pad2D": L(lambda nn: nn.Pad2D([1, 0, 2, 1], mode="replicate"), X4),
    "Pad3D": L(lambda nn: nn.Pad3D([1, 0, 0, 1, 1, 1], value=0.5),
               u((1, 2, 2, 2, 2))),
    "Upsample": L(lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"),
                  X4),
    "UpsamplingBilinear2D": L(lambda nn: nn.UpsamplingBilinear2D(
        size=[7, 4]), X4),
    "UpsamplingNearest2D": L(lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), X4),
    "PixelShuffle": L(lambda nn: nn.PixelShuffle(2), u((1, 8, 2, 3))),
    "Bilinear": L(lambda nn: nn.Bilinear(2, 3, 4), u((5, 2)), u((5, 3), 1)),
    "CosineSimilarity": L(lambda nn: nn.CosineSimilarity(axis=0),
                          u((3, 4)), u((3, 4), 1)),
    "PairwiseDistance": L(lambda nn: nn.PairwiseDistance(keepdim=True),
                          u((3, 4)), u((3, 4), 1)),
    "Unfold": L(lambda nn: nn.Unfold(3, strides=2, paddings=1), X4),
    "Conv1D": L(lambda nn: nn.Conv1D(3, 4, 3, stride=2, padding=1),
                u((2, 3, 7))),
    "Conv2D": L(lambda nn: nn.Conv2D(3, 4, 3, padding="SAME", groups=1),
                X4),
    "Conv3D": L(lambda nn: nn.Conv3D(2, 3, 2), u((1, 2, 3, 3, 3))),
    "Conv1DTranspose": L(lambda nn: nn.Conv1DTranspose(3, 2, 3, stride=2),
                         u((2, 3, 4))),
    "Conv2DTranspose": L(lambda nn: nn.Conv2DTranspose(
        3, 4, 3, stride=2, padding=1, output_padding=1), X4),
    "Conv3DTranspose": L(lambda nn: nn.Conv3DTranspose(2, 2, 2, stride=2),
                         u((1, 2, 2, 2, 2))),
    "BatchNorm": L(lambda nn: nn.BatchNorm(3, act="relu", momentum=0.7),
                   X4),
    "BatchNorm1D": L(lambda nn: nn.BatchNorm1D(4), u((6, 4))),
    "BatchNorm2D": L(lambda nn: nn.BatchNorm2D(3, data_format="NHWC"),
                     u((2, 4, 4, 3))),
    "BatchNorm3D": L(lambda nn: nn.BatchNorm3D(2), u((2, 2, 2, 2, 2))),
    "SyncBatchNorm": L(lambda nn: nn.SyncBatchNorm(3), X4),
    "LayerNorm": L(lambda nn: nn.LayerNorm([5, 5]), X4),
    "GroupNorm": L(lambda nn: nn.GroupNorm(2, 4), u((2, 4, 3, 3))),
    "InstanceNorm1D": L(lambda nn: nn.InstanceNorm1D(3), u((2, 3, 6))),
    "InstanceNorm2D": L(lambda nn: nn.InstanceNorm2D(3), X4),
    "InstanceNorm3D": L(lambda nn: nn.InstanceNorm3D(2),
                        u((1, 2, 3, 3, 3))),
    "LocalResponseNorm": L(lambda nn: nn.LocalResponseNorm(3),
                           u((2, 5, 3, 3))),
    "SpectralNorm": L(lambda nn: nn.SpectralNorm([4, 6], power_iters=2),
                      u((4, 6))),
    "MaxPool1D": L(lambda nn: nn.MaxPool1D(3, 2, 1), u((2, 3, 9))),
    "MaxPool2D": L(lambda nn: nn.MaxPool2D(2, ceil_mode=True), X4),
    "MaxPool3D": L(lambda nn: nn.MaxPool3D(2), u((1, 2, 4, 4, 4))),
    "AvgPool1D": L(lambda nn: nn.AvgPool1D(3, 2, 1), u((2, 3, 9))),
    "AvgPool2D": L(lambda nn: nn.AvgPool2D(3, 2, 1, count_include_pad=False),
                   X4),
    "AvgPool3D": L(lambda nn: nn.AvgPool3D(2), u((1, 2, 4, 4, 4))),
    "AdaptiveAvgPool1D": L(lambda nn: nn.AdaptiveAvgPool1D(3),
                           u((2, 3, 9))),
    "AdaptiveAvgPool2D": L(lambda nn: nn.AdaptiveAvgPool2D([2, 3]), X4),
    "AdaptiveAvgPool3D": L(lambda nn: nn.AdaptiveAvgPool3D(2),
                           u((1, 2, 4, 4, 4))),
    "AdaptiveMaxPool1D": L(lambda nn: nn.AdaptiveMaxPool1D(3),
                           u((2, 3, 9))),
    "AdaptiveMaxPool2D": L(lambda nn: nn.AdaptiveMaxPool2D([2, 3]), X4),
    "AdaptiveMaxPool3D": L(lambda nn: nn.AdaptiveMaxPool3D(2),
                           u((1, 2, 4, 4, 4))),
    **{name: L(lambda nn, name=name: getattr(nn, name)(), 3 * u((3, 4)))
       for name in ("ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish",
                    "Mish", "Hardswish", "Hardsigmoid", "Softsign",
                    "Tanhshrink", "GELU", "LeakyReLU", "ELU", "CELU", "SELU",
                    "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
                    "Softmax", "LogSoftmax", "LogSigmoid",
                    "ThresholdedReLU")},
    "PReLU": L(lambda nn: nn.PReLU(3, init=0.1), X4),
    "Maxout": L(lambda nn: nn.Maxout(2, axis=1), u((2, 4, 3))),
    "CrossEntropyLoss": L(lambda nn: nn.CrossEntropyLoss(ignore_index=2),
                          u((4, 5)), ii((4,), 5)),
    "MSELoss": L(lambda nn: nn.MSELoss(), u((3, 4)), u((3, 4), 1)),
    "L1Loss": L(lambda nn: nn.L1Loss("sum"), u((3, 4)), u((3, 4), 1)),
    "SmoothL1Loss": L(lambda nn: nn.SmoothL1Loss(delta=0.5), 2 * u((3, 4)),
                      u((3, 4), 1)),
    "NLLLoss": L(lambda nn: nn.NLLLoss(), np.log(PROBS), ii((3,), 4)),
    "BCELoss": L(lambda nn: nn.BCELoss(), PROBS,
                 (u((3, 4), 4) > 0).astype("f4")),
    "BCEWithLogitsLoss": L(lambda nn: nn.BCEWithLogitsLoss(), u((3, 4)),
                           (u((3, 4), 4) > 0).astype("f4")),
    "KLDivLoss": L(lambda nn: nn.KLDivLoss("batchmean"), np.log(PROBS),
                   u((3, 4), 5, 0.1, 0.9)),
    "MarginRankingLoss": L(lambda nn: nn.MarginRankingLoss(0.2), u((3, 4)),
                           u((3, 4), 1), SIGN),
    "HingeEmbeddingLoss": L(lambda nn: nn.HingeEmbeddingLoss(), u((3, 4)),
                            SIGN, labels=(1,)),
    "CTCLoss": L(lambda nn: nn.CTCLoss(), u((5, 2, 4)),
                 np.array([[1, 2], [3, 0]], "int32"),
                 np.array([5, 4], "int32"), np.array([2, 1], "int32")),
    "HSigmoidLoss": L(lambda nn: nn.HSigmoidLoss(3, 6), u((4, 3)),
                      ii((4,), 6)),
}


def cotangent(name, i, shape):
    r = np.random.RandomState(zlib.crc32(f"{name}/{i}".encode()))
    return r.uniform(-1, 1, shape).astype("f4")


def run(P, layer, name, spec):
    """The layer's outputs, buffers, input and parameter gradients."""
    if spec["eval"]:
        layer.eval()
    ins = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f"
                       or i in spec["labels"])
           for i, a in enumerate(spec["inputs"])]
    out = layer(*ins)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    loss = None
    for i, o in enumerate(outs):
        term = (o * P.to_tensor(cotangent(name, i, o.shape))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    host = {f"out {i}": o.numpy() for i, o in enumerate(outs)}
    host.update({f"buffer {k}": b.numpy()
                 for k, b in layer.named_buffers()})
    grads = {f"input {i}": t.grad for i, t in enumerate(ins)
             if not t.stop_gradient}
    grads.update({f"param {k}": p.grad for k, p in layer.named_parameters()
                  if not p.stop_gradient})
    return host, {k: None if g is None else g.numpy()
                  for k, g in grads.items()}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_its_jax_twin(name):
    spec = LAYERS[name]
    jl, tl = spec["ctor"](pj.nn), spec["ctor"](pt.nn)
    assert type(tl).__name__ == type(jl).__name__
    jsd, tsd = jl.state_dict(), tl.state_dict()
    assert list(jsd) == list(tsd)
    assert [v.shape for v in jsd.values()] == [v.shape for v in tsd.values()]
    assert tl.set_state_dict({k: v.numpy() for k, v in jsd.items()}) == \
        ([], [])
    jf, jg = run(pj, jl, name, spec)
    tf, tg = run(pt, tl, name, spec)
    assert jf.keys() == tf.keys() and jg.keys() == tg.keys()
    for k in jf:
        want, got = np.asarray(jf[k], "f8"), np.asarray(tf[k], "f8")
        assert got.shape == want.shape, (k, got.shape, want.shape)
        err = np.abs(got - want)
        assert (err <= FWD_RTOL * np.maximum(1, np.abs(want))).all(), \
            (k, err.max())
    for k in jg:
        assert (jg[k] is None) == (tg[k] is None), k
        if jg[k] is None:
            continue
        scale = max(1.0, float(np.abs(jg[k]).max()))
        err = float(np.abs(np.asarray(tg[k]) - jg[k]).max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)


def test_nn_exports_every_name_of_the_jax_package():
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "paddle_tpu" / "nn" /
           "__init__.py").read_text()
    # the imports up to `.clip`'s, and `utils`: the transformer layers,
    # decode and rnn that follow belong to later items
    names = {"utils"}
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
            if node.module == "clip":
                break
    missing = sorted(n for n in names if not hasattr(pt.nn, n))
    assert not missing, missing


def test_weight_norm_spectral_norm_and_vectors_match_jax():
    x = u((5, 4), 7)
    res = {}
    for P in (pj, pt):
        lin = P.nn.Linear(4, 3)
        if P is pt:
            lin.set_state_dict(res[pj]["start"])
        start = {k: v.numpy().copy() for k, v in lin.state_dict().items()}
        P.nn.utils.weight_norm(lin, dim=1)
        names = [n for n, _ in lin.named_parameters()]
        out = lin(P.to_tensor(x))
        (out * P.to_tensor(cotangent("wn", 0, out.shape))).sum().backward()
        grads = {n: p.grad.numpy() for n, p in lin.named_parameters()}
        P.nn.utils.remove_weight_norm(lin)
        # copies: the port's numpy() of a CPU tensor is a view, and
        # vector_to_parameters below writes the weights in place
        folded = lin.weight.numpy().copy()
        sn = P.nn.Linear(4, 3)
        if P is pt:
            sn.set_state_dict({k: v.numpy() for k, v in
                               res[pj]["sn"].items()})
        sn_state = {k: v.numpy().copy() for k, v in sn.state_dict().items()}
        P.nn.utils.spectral_norm(sn, n_power_iterations=2)
        if P is pt:
            sub = sn._spectral_norm_weight
            sub.set_state_dict({k: v.numpy() for k, v in
                                res[pj]["sn_sub"].items()})
        sn_sub = {k: v.numpy().copy() for k, v in
                  sn._spectral_norm_weight.state_dict().items()}
        sn_out = sn(P.to_tensor(x)).numpy()
        vec = P.nn.utils.parameters_to_vector(lin.parameters())
        P.nn.utils.vector_to_parameters(vec * 2, lin.parameters())
        res[P] = {"start": start, "names": names,
                  "out": out.numpy(), "grads": grads, "folded": folded,
                  "sn": {k: P.to_tensor(v) for k, v in sn_state.items()},
                  "sn_sub": {k: P.to_tensor(v) for k, v in sn_sub.items()},
                  "sn_out": sn_out, "vec": vec.numpy(),
                  "doubled": lin.weight.numpy()}
    assert res[pt]["names"] == res[pj]["names"]
    for k in ("out", "folded", "sn_out", "vec", "doubled"):
        want, got = res[pj][k], res[pt][k]
        assert np.abs(got - want).max() <= FWD_RTOL * max(
            1, np.abs(want).max()), k
    for k, want in res[pj]["grads"].items():
        got = res[pt]["grads"][k]
        assert np.abs(got - want).max() <= GRAD_RTOL * max(
            1, np.abs(want).max()), k
