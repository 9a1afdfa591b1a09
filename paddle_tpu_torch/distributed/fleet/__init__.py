"""Fleet facade, the collective half (the port of `paddle_tpu/distributed/
fleet/__init__.py`; ref python/paddle/distributed/fleet/base/
fleet_base.py:63): init / distributed_optimizer / distributed_model /
build_train_step / minimize. The parameter-server runtime (MultiTrainer,
PsServer, ..., `metrics`) is ROADMAP Queue 1 item 5c."""
from .base import (init, is_first_worker, worker_index, worker_num,
                   is_worker, worker_endpoints, server_num, server_index,
                   server_endpoints, is_server, barrier_worker,
                   distributed_optimizer, distributed_model,
                   DistributedStrategy, UserDefinedRoleMaker,
                   PaddleCloudRoleMaker, UtilBase, fleet, build_train_step,
                   init_server, run_server, init_worker, stop_worker,
                   minimize, step, clear_grad, get_lr, set_lr, state_dict,
                   set_state_dict, amp_init, shrink, save_persistables,
                   save_inference_model)


def __getattr__(name):
    if name == "util":
        # ref fleet_base.py `util` property: host-collective helpers
        from .base import _fleet
        return _fleet.util
    if name in ("MultiTrainer", "DistMultiTrainer", "PsServer", "PsClient",
                "AsyncPSTrainer", "GeoPSTrainer", "HeterPSTrainer",
                "TheOnePSRuntime", "metrics", "utils"):
        raise NotImplementedError(
            f"fleet.{name}: the parameter-server runtime is not ported yet "
            f"(ROADMAP Queue 1 item 5c)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
