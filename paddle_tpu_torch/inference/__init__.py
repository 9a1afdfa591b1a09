"""paddle.inference front door to the LLM serving engine (the port of
`Config.enable_llm_engine`, `LLMPredictor` and `create_llm_predictor`
from `paddle_tpu/inference/__init__.py`).

`enable_llm_engine()` serves through the dense `ServingEngine` by
default (`paged=False`), the paged one (`paged=True`), or the
speculative paged one (`speculative=True`, which implies paged: a draft
model proposes `k` tokens per slot per wave and the target verifies them
in one forward). The Config's
`ir_optim` (on by default, `switch_ir_optim`) selects how the engine
runs its decode wave and prefill on the card: as CUDA-graph replays, or
eagerly (`switch_ir_optim(False)`), the counterpart of the JAX
package's `jit_compile=config.ir_optim()`.
"""

class Config:
    """The inference Config's LLM-engine surface."""

    def __init__(self):
        self._llm_opts = None
        self._ir_optim = True

    def switch_ir_optim(self, flag=True):
        """ir_optim (the reference's SwitchIrOptim): True serves each
        decode wave and prefill chunk as a CUDA-graph replay on the card;
        False runs them eagerly, one dispatch per op (for debugging, and
        as the yardstick of the graphs). The CPU always runs eagerly."""
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_llm_engine(self, num_slots=4, max_len=256, prefill_len=None,
                          eos_token_id=None, max_queue=None, paged=False,
                          block_size=16, num_blocks=None, speculative=False,
                          draft_config=None, k=4, paged_kernel=None,
                          device=None):
        """Arm this Config for create_llm_predictor: slot count, cache
        horizon, prefill bucket (dense) or chunk length (paged) as
        `prefill_len`, eos, queue bound, the engine (`paged`), block size
        and pool size of the paged KV cache, the paged attention kernel
        ("reference" | "plain" | "cuda" | "auto"; None defers to
        PT_PAGED_KERNEL, then "auto") and the device (None = the CUDA
        card). speculative=True (implies paged) serves draft-k /
        verify-once speculative decoding, `k` draft tokens per slot per
        wave, with the output distribution the target's (its own tokens
        under greedy). The draft is create_llm_predictor's `draft_model=`,
        or a model built from `draft_config` (a config of the target's
        family, GPTConfig or LlamaConfig, with the target's vocabulary,
        freshly initialised: correct all the same, but acceptance, the
        whole speed-up, needs a draft that predicts the target)."""
        self._llm_opts = {
            "num_slots": int(num_slots),
            "max_len": int(max_len),
            "prefill_len": None if prefill_len is None else int(prefill_len),
            "eos_token_id": eos_token_id,
            "max_queue": max_queue,
            "paged": bool(paged) or bool(speculative),
            "block_size": int(block_size),
            "num_blocks": None if num_blocks is None else int(num_blocks),
            "speculative": bool(speculative),
            "draft_config": draft_config,
            "spec_k": int(k),
            "paged_kernel": paged_kernel,
            "device": device,
        }
        return self

    def llm_engine_enabled(self):
        return self._llm_opts is not None

    def enable_llm_fleet(self, *args, **kw):
        raise NotImplementedError(
            "the serving fleet is not ported yet (ROADMAP Queue 1: serving "
            "fleet and operations tier)")

    def enable_metrics_exporter(self, *args, **kw):
        raise NotImplementedError(
            "the metrics exporter is not ported yet (ROADMAP Queue 1: "
            "serving fleet and operations tier)")


class LLMPredictor:
    """One Config-built Scheduler + engine pair (the dense
    ServingEngine, PagedServingEngine or SpeculativePagedEngine) with a
    blocking generate(), the submit()/run() surface, health() and a
    graceful close()."""

    def __init__(self, config, model, draft_model=None):
        from ..serving import (PagedServingEngine, Scheduler, ServingEngine,
                               SpeculativePagedEngine)
        opts = config._llm_opts
        self._eos_token_id = opts["eos_token_id"]
        common = dict(num_slots=opts["num_slots"], max_len=opts["max_len"],
                      device=opts["device"], cuda_graph=config.ir_optim())
        paged = dict(block_size=opts["block_size"],
                     num_blocks=opts["num_blocks"],
                     prefill_chunk_len=opts["prefill_len"],
                     paged_kernel=opts["paged_kernel"], **common)
        if opts["speculative"]:
            self.engine = SpeculativePagedEngine(
                model, _draft(opts, model, draft_model),
                spec_k=opts["spec_k"], **paged)
        elif opts["paged"]:
            self.engine = PagedServingEngine(model, **paged)
        else:
            self.engine = ServingEngine(
                model, prefill_len=opts["prefill_len"], **common)
        self.scheduler = Scheduler(self.engine, max_queue=opts["max_queue"])

    def close(self, drain=True):
        """Graceful shutdown: drain the scheduler (accepted requests
        complete, new submits are shed with finish_reason "rejected")
        and run it dry. drain=False stops without running the loop (the
        engine's graphs need no teardown)."""
        if drain:
            self.scheduler.shutdown()

    def health(self):
        """The engine's health payload (status ok | draining | degraded,
        load, compile counts, pool occupancy on a paged engine)."""
        return self.engine.health()

    def generate(self, prompt, **kw):
        kw.setdefault("eos_token_id", self._eos_token_id)
        return self.scheduler.generate(prompt, **kw)

    def submit(self, **kw):
        kw.setdefault("eos_token_id", self._eos_token_id)
        return self.scheduler.submit(**kw)

    def run(self, **kw):
        return self.scheduler.run(**kw)

    @property
    def metrics(self):
        return self.scheduler.metrics


def _draft(opts, model, draft_model):
    """The speculative configuration's draft: `draft_model` as given, or
    one built from the Config's draft_config in the target's class, on
    its device and in its dtype (weights from seed 0)."""
    if draft_model is not None:
        return draft_model
    if opts["draft_config"] is None:
        raise ValueError("speculative serving needs a draft model: pass "
                         "draft_model= to create_llm_predictor or "
                         "draft_config= to enable_llm_engine")
    dtype = next(iter(model.parameters())).dtype
    return type(model)(opts["draft_config"], device=model.device,
                       dtype=dtype)


def create_llm_predictor(config, model=None, draft_model=None):
    """Front door from the inference Config to the serving stack: the
    Config carries the engine knobs (enable_llm_engine) and `model` is a
    causal LM exposing the engine's methods (nlp.GPTForPretraining or
    nlp.LlamaForCausalLM), already on the engine's device. `draft_model`
    (the target's family and vocabulary, typically far fewer layers)
    serves the speculative configuration; the other engines ignore it.
    A Config that was not armed gets the defaults, the dense engine, on
    the model's device (where its caller put it)."""
    if model is None:
        raise ValueError("create_llm_predictor needs `model` (a causal LM "
                         "such as nlp.GPTForPretraining or "
                         "nlp.LlamaForCausalLM)")
    if not config.llm_engine_enabled():
        config.enable_llm_engine(device=model.device)
    return LLMPredictor(config, model, draft_model=draft_model)
