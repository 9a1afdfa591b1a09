"""The `nn.functional`, `bilinear` and LLaMA op cases of
`tests/torch_op_cases.py` (`NN_CASES`) against the JAX package, with
`tests/test_torch_ops.py`'s comparison and tolerances: f32 forward
within 1e-5 x max(1, |ref|), gradients within 1e-4 x max(1, max|g|).
"""
import pytest
import torch

import paddle_tpu_torch as pt
from test_torch_ops import check_case
from torch_op_cases import NN_CASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.mark.parametrize("name", sorted(NN_CASES))
def test_nn_op_matches_jax(name):
    check_case(name)
