"""The detection op cases of `tests/torch_op_cases.py` (`VISION_CASES`:
the ops of `paddle_tpu_torch/vision/ops.py` and `quantization.py`'s
`fake_quantize_dequantize`) against the JAX package's, with
`tests/test_torch_ops.py`'s comparison and tolerances: f32 forward
within 1e-5 x max(1, |ref|), gradients within 1e-4 x max(1, max|g|),
integer outputs and dtypes exactly. Two thirds of the cases run here,
one third in `tests/test_torch_vision_ops.py` beside its other checks,
so that two test workers take them.
"""
import pytest
import torch

import paddle_tpu_torch as pt
from test_torch_ops import check_case
from torch_op_cases import VISION_CASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

NAMES = sorted(VISION_CASES)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.mark.parametrize("name", NAMES[1::3] + NAMES[2::3])
def test_op_matches_jax(name):
    check_case(name)
