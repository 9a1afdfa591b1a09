"""Meta-optimizers (the port of `paddle_tpu/distributed/fleet/
meta_optimizers.py`; ref fleet/meta_optimizers/*: AMP, Recompute,
GradientMerge, Lamb, Lars, LocalSGD, Sharding, Pipeline, chained by the
StrategyCompiler, base/strategy_compiler.py:89).

Each wraps the inner optimizer and records its feature in
`transforms`, which `jit.TrainStep` and `distributed.ShardedTrainStep`
read (`jit/transforms.py`); the steps run the optimizer at the bottom
of the chain. Used eagerly, a wrapper passes step(), clear_grad() and
the rest to the inner optimizer (GradientMerge steps it every k-th
call). Lamb and Lars replace the inner optimizer by a Lamb or Lars over
its parameters. The chain is composed in the reference's order.
"""
from ...optimizer.optimizer import Lamb, Lars, Optimizer


class MetaOptimizerBase(Optimizer):
    """A link of the chain: every attribute it does not set is the inner
    optimizer's."""

    def __init__(self, inner_opt):
        self.inner_opt = inner_opt
        # transform flags consumed by the train steps
        self.transforms = dict(getattr(inner_opt, "transforms", {}))

    def __getattr__(self, name):
        if name == "inner_opt":          # not yet set: no recursion
            raise AttributeError(name)
        return getattr(self.inner_opt, name)

    # the step counter lives on the inner optimizer (a checkpoint restores
    # it there): a copy here would drift from it
    @property
    def _global_step(self):
        return self.inner_opt._global_step

    @_global_step.setter
    def _global_step(self, value):
        self.inner_opt._global_step = value

    @property
    def _state_names(self):
        return self.inner_opt._state_names

    def get_lr(self):
        return self.inner_opt.get_lr()

    def set_lr(self, value):
        return self.inner_opt.set_lr(value)

    def step(self):
        self.inner_opt.step()

    def clear_grad(self):
        self.inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self.inner_opt.minimize(loss)

    def state_dict(self):
        return self.inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self.inner_opt.set_state_dict(sd)

    set_dict = set_state_dict


class AMPOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/amp_optimizer.py: bf16 autocast (loss scaling
    is off for bf16)."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        cfg = configs or {}
        self.transforms["amp"] = {
            "level": "O2" if cfg.get("use_pure_bf16") or cfg.get("use_pure_fp16")
            else "O1",
            "dtype": "bfloat16",
            "init_loss_scaling": cfg.get("init_loss_scaling", 1.0),
        }


class RecomputeOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/recompute_optimizer.py + fluid
    RecomputeOptimizer (optimizer.py:4549): the forward recomputed in
    the backward."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        self.transforms["recompute"] = dict(configs or {"checkpoints": []})

    def backward(self, loss, **kwargs):
        loss.backward()

    def apply_optimize(self, loss, startup_program=None, params_grads=None):
        self.inner_opt.step()


class GradientMergeOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/gradient_merge_optimizer.py — k-step grad
    accumulation before the update. Eagerly the grads accumulate in
    .grad (torch adds each backward's) and every k-th step() updates on
    them (divided by k with `avg`); the train steps accumulate in
    buffers of their own."""

    def __init__(self, inner_opt, k_steps=1, avg=True):
        super().__init__(inner_opt)
        self.k_steps = int(k_steps)
        self.avg = avg
        self._acc_step = 0
        self.transforms["gradient_merge"] = {"k_steps": self.k_steps,
                                             "avg": avg}

    def step(self):
        self._acc_step += 1
        if self._acc_step % self.k_steps != 0:
            return  # keep accumulating in .grad
        if self.avg and self.k_steps > 1:
            for p in self.inner_opt._parameters:
                if p.grad is not None:
                    p.grad = p.grad / self.k_steps
        self.inner_opt.step()

    def clear_grad(self):
        if self._acc_step % self.k_steps == 0:
            self.inner_opt.clear_grad()

    clear_gradients = clear_grad


class LambOptimizer(MetaOptimizerBase):
    def __init__(self, inner_opt, configs=None):
        lamb = Lamb(learning_rate=inner_opt._lr,
                    parameters=inner_opt._parameters,
                    grad_clip=inner_opt._grad_clip,
                    **({k: v for k, v in (configs or {}).items()
                        if k in ("lamb_weight_decay", "beta1", "beta2",
                                 "epsilon")}))
        super().__init__(lamb)


class LarsOptimizer(MetaOptimizerBase):
    def __init__(self, inner_opt, configs=None):
        cfg = {k: v for k, v in (configs or {}).items()
               if k in ("lars_coeff", "lars_weight_decay", "epsilon")}
        momentum = getattr(inner_opt, "_momentum", 0.9)
        lars = Lars(learning_rate=inner_opt._lr, momentum=momentum,
                    parameters=inner_opt._parameters,
                    grad_clip=inner_opt._grad_clip, **cfg)
        super().__init__(lars)


class LocalSGDOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/localsgd_optimizer.py — k local steps, then
    the parameters averaged over dp (the step is ROADMAP item 5c)."""

    def __init__(self, inner_opt, k_steps=1):
        super().__init__(inner_opt)
        self.k_steps = k_steps
        self.transforms["localsgd"] = {"k_steps": k_steps}


class AdaptiveLocalSGDOptimizer(MetaOptimizerBase):
    """ref localsgd_optimizer.py AdaptiveLocalSGDOptimizer: the averaging
    interval follows the loss (the step is ROADMAP item 5c)."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        cfg = dict(configs or {})
        self.transforms["localsgd"] = {
            "adaptive": True,
            "init_k_steps": int(cfg.get("init_k_steps", 1)),
            "begin_step": int(cfg.get("begin_step", 1)),
        }


class DGCOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/dgc_optimizer.py DGCMomentumOptimizer: top-k
    sparsified grads with momentum correction (the step is ROADMAP item
    5c)."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        cfg = dict(configs or {})
        sparsity = cfg.get("sparsity", [0.999])
        if isinstance(sparsity, (list, tuple)):
            sparsity = sparsity[-1]
        self.transforms["dgc"] = {
            "sparsity": float(sparsity),
            "rampup_begin_step": int(cfg.get("rampup_begin_step", 0) or 0)}


class ShardingOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/sharding_optimizer.py:33 (ZeRO): the optimizer
    state cut over 'dp' by ShardedTrainStep."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        self.transforms["sharding"] = dict(configs or {})


class PipelineOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/pipeline_optimizer.py: micro-batches over the
    'pp' axis (`fleet.build_train_step` builds the pipeline step)."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        self.transforms["pipeline"] = dict(
            configs or {"accumulate_steps": 1, "micro_batch_size": 1})


class FP16AllReduceOptimizer(MetaOptimizerBase):
    """ref meta_optimizers/fp16_allreduce_optimizer.py: gradients reduced
    over 'dp' in reduced precision and cast back (ShardedTrainStep)."""

    def __init__(self, inner_opt, configs=None):
        super().__init__(inner_opt)
        cfg = dict(configs or {})
        cfg.setdefault("dtype", "float16")   # the reference's choice
        self.transforms["fp16_allreduce"] = cfg


class GraphExecutionOptimizer(MetaOptimizerBase):
    """ref graph_execution_optimizer.py: the identity end of the chain
    (a train step is one program already)."""


def build_distributed_optimizer(optimizer, strategy):
    """StrategyCompiler analog (ref base/strategy_compiler.py:89): the
    chain AMP ∘ Recompute ∘ (Lamb|Lars) ∘ (Sharding|Pipeline|LocalSGD|
    GradientMerge) ∘ GraphExecution, in the reference's order. With
    `strategy.auto` and no feature set, bf16 AMP turns itself on (the
    caller's strategy is not changed)."""
    opt = optimizer
    auto_amp = False
    if getattr(strategy, "auto", False):
        explicit = any(getattr(strategy, f, False) for f in (
            "amp", "recompute", "sharding", "pipeline", "localsgd",
            "adaptive_localsgd", "dgc", "gradient_merge", "lamb", "lars",
            "fp16_allreduce"))
        auto_amp = not explicit
    if strategy.lamb:
        opt = LambOptimizer(opt, strategy.lamb_configs)
    elif strategy.lars:
        opt = LarsOptimizer(opt, strategy.lars_configs)
    if strategy.recompute:
        opt = RecomputeOptimizer(opt, strategy.recompute_configs)
    if strategy.amp or auto_amp:
        opt = AMPOptimizer(opt, strategy.amp_configs)
    if getattr(strategy, "fp16_allreduce", False):
        opt = FP16AllReduceOptimizer(
            opt, getattr(strategy, "fp16_allreduce_configs", None))
    if strategy.sharding:
        opt = ShardingOptimizer(opt, strategy.sharding_configs)
    if strategy.pipeline:
        opt = PipelineOptimizer(opt, strategy.pipeline_configs)
    if getattr(strategy, "adaptive_localsgd", False):
        opt = AdaptiveLocalSGDOptimizer(
            opt, getattr(strategy, "adaptive_localsgd_configs", None))
    elif strategy.localsgd:
        opt = LocalSGDOptimizer(opt, strategy.localsgd_configs.get("k_steps", 1))
    if strategy.dgc:
        opt = DGCOptimizer(opt, getattr(strategy, "dgc_configs", None))
    if strategy.gradient_merge:
        opt = GradientMergeOptimizer(
            opt, strategy.gradient_merge_configs.get("k_steps", 1),
            strategy.gradient_merge_configs.get("avg", True))
    if not isinstance(opt, MetaOptimizerBase):
        opt = GraphExecutionOptimizer(opt)
    return opt
