"""The port's op library against the JAX package's, one case per op name
that the ported modules register (`ops/creation.py`, `math.py`,
`manipulation.py`, `logic.py`, `linalg.py`, `sequence.py`, `legacy.py`,
the registered `flash_attention`, `nn/functional.py`,
`nn/layers_common.py`'s `bilinear` and `nlp/llama.py`'s `rms_norm` and
`llama_attention`): the same seeded numpy inputs go through
both packages on the CPU, and the forward outputs and the gradients of a
fixed random projection of them are compared. The `nn.functional`
cases run from `tests/test_torch_nn_ops.py` and the `legacy.py` cases
from `tests/test_torch_legacy_ops.py` and `tests/test_torch_legacy_ops_2.py`
(other files, so other test workers); the coverage check here counts
them.

Tolerances: f32 forward within 1e-5 x max(1, |ref|) elementwise;
gradients within 1e-4 x max(1, max|g|); integer and bool outputs and all
dtypes exactly. Ops whose outputs are defined up to a sign (svd, qr,
eigh) are compared through their absolute values, in both packages.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.ops import creation as j_creation
from paddle_tpu.ops import dispatch as j_dispatch
from paddle_tpu.ops import legacy as j_legacy
from paddle_tpu.ops import linalg as j_linalg
from paddle_tpu.ops import logic as j_logic
from paddle_tpu.ops import manipulation as j_manip
from paddle_tpu.ops import math as j_math
from paddle_tpu.ops import sequence as j_seq
from paddle_tpu_torch.ops import creation as t_creation
from paddle_tpu_torch.ops import dispatch as t_dispatch
from paddle_tpu_torch.ops import flash_attention as t_flash
from paddle_tpu_torch.ops import legacy as t_legacy
from paddle_tpu_torch.ops import linalg as t_linalg
from paddle_tpu_torch.ops import logic as t_logic
from paddle_tpu_torch.ops import manipulation as t_manip
from paddle_tpu_torch.ops import math as t_math
from paddle_tpu_torch.ops import sequence as t_seq
from torch_op_cases import CASES, LEGACY_CASES, NN_CASES, NS, op_name, run

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
MODULES = ("creation", "math", "manipulation", "logic", "linalg",
           "sequence", "legacy")
NN_SOURCES = ("nn/functional.py", "nn/layers_common.py", "nlp/llama.py")


j_flash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
JAX = NS(pj, j_creation, j_math, j_manip, j_logic, j_linalg, j_seq, j_flash,
         pj.nn.functional, j_dispatch, j_legacy)
PORT = NS(pt, t_creation, t_math, t_manip, t_logic, t_linalg, t_seq, t_flash,
          pt.nn.functional, t_dispatch, t_legacy)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _close(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    ok = np.isnan(want) == np.isnan(got)
    assert ok.all(), f"{what}: NaN positions differ"
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)], err_msg=what)
    err = np.abs(got[fin] - want[fin])
    bound = rtol * np.maximum(1.0, np.abs(want[fin]))
    assert (err <= bound).all(), \
        f"{what}: max err {err.max()} (bound {rtol} x max(1, |ref|))"


@pytest.mark.parametrize("name", sorted(set(CASES) - set(NN_CASES)
                                         - set(LEGACY_CASES)))
def test_op_matches_jax(name):
    check_case(name)


def check_case(name):
    """Case `name` through both packages: dtypes, forward values and
    gradients."""
    jf, jg = run(JAX, name)
    tf, tg = run(PORT, name)
    assert len(jf) == len(tf), name
    for k, ((jd, ja), (td, ta)) in enumerate(zip(jf, tf)):
        assert td == jd, f"{name} output {k}: dtype {td} != JAX {jd}"
        _close(ta, np.asarray(ja), FWD_RTOL, f"{name} output {k}")
    if jg is None:
        return
    for k, (j, t) in enumerate(zip(jg, tg)):
        assert (j is None) == (t is None), f"{name} grad {k}: {j} vs {t}"
        if j is None:
            continue
        j = np.asarray(j)
        if np.iscomplexobj(j):
            # JAX's gradient of a real loss in a complex input is the
            # conjugate of torch's (df/dRe - i df/dIm)
            j = np.conj(j)
        scale = max(1.0, float(np.abs(j).max()))
        assert t.shape == j.shape, (name, k, t.shape, j.shape)
        err = float(np.abs(t - j).max())
        assert err <= GRAD_RTOL * scale, \
            f"{name} grad {k}: max err {err} > {GRAD_RTOL} x {scale}"


def _jax_module_names():
    """The op names the seven JAX op modules, `nn/functional.py`,
    `nn/layers_common.py` and `nlp/llama.py` register (their quoted names
    in the JAX registry), and flash_attention."""
    srcs = [(ROOT / "paddle_tpu" / "ops" / f"{m}.py").read_text()
            for m in MODULES]
    srcs += [(ROOT / "paddle_tpu" / path).read_text() for path in NN_SOURCES]
    def registers(src, n):
        q = re.escape(f'"{n}"')
        return re.search(rf"(register_op|def_op|_make_elementwise)\("
                         rf"\s*{q}", src) or \
            re.search(rf"(_binop|_unary|_reduce|_cmp)\(.*,\s*{q}\)", src)
    names = {n for n in j_dispatch.OP_REGISTRY
             if any(registers(s, n) for s in srcs)}
    return names | {"flash_attention"}


def test_registry_covers_the_jax_modules_and_every_name_has_a_case():
    names = _jax_module_names()
    missing = sorted(names - set(t_dispatch.OP_REGISTRY))
    assert not missing, f"not in the port's OP_REGISTRY: {missing}"
    cased = {op_name(k) for k in CASES}
    assert not sorted(names - cased), sorted(names - cased)
    # reported in CHANGES.md
    assert len(names) >= 367, len(names)
