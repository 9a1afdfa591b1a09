"""The fluid-era op cases of `tests/torch_op_cases.py` (`LEGACY_CASES`,
the ops of `paddle_tpu_torch/ops/legacy.py`) against the JAX package's
`paddle_tpu/ops/legacy.py`, with `tests/test_torch_ops.py`'s comparison
and tolerances: f32 forward within 1e-5 x max(1, |ref|), gradients
within 1e-4 x max(1, max|g|), integer outputs (the hashes' bucket ids
among them) exactly. The random creators' cases compare shapes and
moments. The cases are split, alternately by name, between
`tests/test_torch_legacy_ops.py` and this file, so that two other test
workers take them and each file runs in under a minute alone.
"""
import pytest
import torch

import paddle_tpu_torch as pt
from test_torch_ops import check_case
from torch_op_cases import LEGACY_CASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.mark.parametrize("name", sorted(LEGACY_CASES)[1::2])
def test_legacy_op_matches_jax(name):
    check_case(name)
