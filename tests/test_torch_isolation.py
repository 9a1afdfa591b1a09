"""The port stands alone: `paddle_tpu_torch` imports with JAX made
unimportable, never loads the JAX package (`paddle_tpu` — note the port's
name starts with that string, so module names are checked exactly), and
never runs on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")


def test_imports_without_jax_and_without_the_jax_package():
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import paddle_tpu_torch
        import paddle_tpu_torch.amp
        import paddle_tpu_torch.autograd
        import paddle_tpu_torch.framework
        import paddle_tpu_torch.framework.dtype
        import paddle_tpu_torch.framework.errors
        import paddle_tpu_torch.framework.selected_rows
        import paddle_tpu_torch.framework.serialization
        import paddle_tpu_torch.framework.state
        import paddle_tpu_torch.framework.tape
        import paddle_tpu_torch.framework.tensor
        import paddle_tpu_torch.ops.creation
        import paddle_tpu_torch.ops.dispatch
        import paddle_tpu_torch.ops.linalg
        import paddle_tpu_torch.ops.legacy
        import paddle_tpu_torch.ops.logic
        import paddle_tpu_torch.ops.manipulation
        import paddle_tpu_torch.ops.math
        import paddle_tpu_torch.ops.sequence
        import paddle_tpu_torch.tensor
        import paddle_tpu_torch.inference
        import paddle_tpu_torch.jit
        import paddle_tpu_torch.kernels
        import paddle_tpu_torch.nlp
        import paddle_tpu_torch.nlp.bert
        import paddle_tpu_torch.nlp.gpt
        import paddle_tpu_torch.nlp.llama
        import paddle_tpu_torch.nn
        import paddle_tpu_torch.nn.activation
        import paddle_tpu_torch.nn.conv
        import paddle_tpu_torch.nn.decode
        import paddle_tpu_torch.nn.functional
        import paddle_tpu_torch.nn.initializer
        import paddle_tpu_torch.nn.layer
        import paddle_tpu_torch.nn.layers_common
        import paddle_tpu_torch.nn.loss
        import paddle_tpu_torch.nn.norm
        import paddle_tpu_torch.nn.param_attr
        import paddle_tpu_torch.nn.pooling
        import paddle_tpu_torch.nn.transformer
        import paddle_tpu_torch.nn.utils
        import paddle_tpu_torch.ops
        import paddle_tpu_torch.optimizer
        import paddle_tpu_torch.optimizer.lr
        import paddle_tpu_torch.optimizer.wrappers
        import paddle_tpu_torch.ops.chunked_ce
        import paddle_tpu_torch.regularizer
        import paddle_tpu_torch.graphs
        import paddle_tpu_torch.serving
        import paddle_tpu_torch.hapi
        import paddle_tpu_torch.hapi.model
        import paddle_tpu_torch.hapi.callbacks
        import paddle_tpu_torch.io
        import paddle_tpu_torch.io.multiprocess
        import paddle_tpu_torch.metric
        import paddle_tpu_torch.reader
        import paddle_tpu_torch.dataset
        import paddle_tpu_torch.vision
        import paddle_tpu_torch.vision.transforms
        import paddle_tpu_torch.vision.datasets
        import paddle_tpu_torch.vision.models
        import paddle_tpu_torch.utils.resume
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
        assert not bad, bad
        # the eager surface is there, and nothing was built or placed
        assert callable(paddle_tpu_torch.to_tensor)
        assert not paddle_tpu_torch.kernels._loaded
        assert paddle_tpu_torch.framework.state._current_device is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_source_scan_finds_no_jax_or_jax_package_import():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    # the op cases chip_smoke.py's eager phase loads on the card
    files.append(os.path.join(ROOT, "tests", "torch_op_cases.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (path, mod)


def test_no_card_means_no_quiet_cpu_fallback(monkeypatch):
    """Built without device=, every entry point asks for the card and
    raises when there is none — it never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from paddle_tpu_torch import inference, resolve_device
    from paddle_tpu_torch.nlp import (BertConfig, BertForPretraining,
                                      GPTConfig, GPTForPretraining,
                                      LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=2, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForPretraining(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig(vocab_size=64, hidden_size=32,
                                     num_layers=1, num_heads=4,
                                     num_kv_heads=2, max_seq_len=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForPretraining(BertConfig(vocab_size=64, hidden_size=32,
                                      num_layers=1, num_heads=2,
                                      intermediate_size=64, max_seq_len=32))
    model = GPTForPretraining(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(model, num_slots=2, max_len=32, block_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, num_slots=2, max_len=32)
    dense = inference.Config().enable_llm_engine(num_slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.create_llm_predictor(dense, model=model)
    conf = inference.Config().enable_llm_engine(paged=True, num_slots=2,
                                                max_len=32, block_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.create_llm_predictor(conf, model=model)
    # asked for the CPU by name, it runs there
    eng = PagedServingEngine(model, num_slots=2, max_len=32, block_size=8,
                             device="cpu")
    assert eng.paged_kernel == "plain"


def test_dataloader_places_batches_on_the_card_by_default(monkeypatch):
    """A DataLoader without `places` lands its batches on the current
    place: the card, which raises with none, unless set_device("cpu")."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = TensorDataset([torch.arange(6).reshape(3, 2)])
    old = pt.get_device()
    try:
        pt.set_device("gpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            DataLoader(ds)
        pt.set_device("cpu")
        (batch,) = list(DataLoader(ds, batch_size=3))
        assert batch[0].place == pt.CPUPlace()
    finally:
        pt.set_device(old)


def test_seed_replays_the_global_generators():
    import random

    import numpy as np
    from paddle_tpu_torch import seed

    def draw():
        return (random.random(), np.random.rand(), torch.rand(3).tolist())
    seed(11)
    first = draw()
    seed(11)
    assert draw() == first


def test_unported_front_door_options_name_the_roadmap():
    from paddle_tpu_torch import inference
    # the dense engine is ported: paged=False (the default) arms
    assert inference.Config().enable_llm_engine(
        paged=False).llm_engine_enabled()
    # speculative decoding is ported (tests/test_torch_spec.py)
    assert inference.Config().enable_llm_engine(
        paged=True, speculative=True, k=3)._llm_opts["spec_k"] == 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        inference.Config().enable_llm_fleet(replicas=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        inference.Config().enable_metrics_exporter(port=0)
