"""Exact-resume training state (the port of the train-state half of
`paddle_tpu/utils/resume.py`, :80-135).

A checkpoint that holds only the parameters and the optimizer's moments
changes the run on resume: the random streams restart, the data cursor
resets. `capture_train_state` / `apply_train_state` close that gap: the
`.pdtrain` file `hapi.Model.save` writes beside `.pdparams` and `.pdopt`
(all three under one `latest.json` manifest entry) records

  * the framework generator: its seed and the state of each device's
    `torch.Generator` (`framework.state.rng_state`), so dropout streams
    resume where they stopped;
  * the global numpy RNG: shuffle permutations and numpy transforms
    (`framework.state.numpy_rng_state`);
  * the data cursor: the epoch, the batches consumed and the numpy RNG
    state at the start of the epoch in progress (what `Model.fit`'s
    fast-forward replays, so the epoch's permutation comes out again);
  * an `amp.GradScaler`'s scale and step counters, when the Model has
    one;
  * the global step and the writing run's id.

The payload is the port's own (its RNG records are torch generator
states, not JAX keys). The watchdog, `record_resume`, the reshard
checks and the telemetry counters of the JAX module are ROADMAP Queue 1
item 6 (and the sharding record item 5: the port writes None there).
"""
import time

from ..framework import state

#: schema version of the `.pdtrain` payload, the JAX package's:
#: `apply_train_state` refuses newer versions rather than resuming with
#: silently misread state
STATE_VERSION = 2


def capture_train_state(cursor=None, step=None, scaler=None):
    """The training state beyond parameters and optimizer as one
    picklable dict. `cursor` is Model.fit's data cursor ({"epoch",
    "batch", "epoch_numpy_rng"}), `scaler` an optional
    `amp.GradScaler`. The JAX payload's `run_id` (the flight recorder's)
    and `sharding` (a sharded step's placements) are written as None."""
    return {
        "version": STATE_VERSION,
        "time_unix": round(time.time(), 3),
        "rng": state.rng_state(),
        "numpy_rng": state.numpy_rng_state(),
        "cursor": None if cursor is None else dict(cursor),
        "step": None if step is None else int(step),
        "scaler": None if scaler is None else dict(scaler.state_dict()),
        "run_id": None,
        "sharding": None,
    }


def apply_train_state(doc, scaler=None):
    """Restore a `capture_train_state` snapshot into the process: the
    random streams rewound, the scaler reloaded. Returns what
    `Model.fit(resume=True)` reads: {"cursor", "step", "run_id",
    "sharding"}. Missing keys are tolerated; a newer version than this
    reader knows is refused."""
    if not isinstance(doc, dict):
        raise ValueError(f"train state is not a dict: {type(doc).__name__}")
    version = int(doc.get("version", 0))
    if version > STATE_VERSION:
        raise ValueError(
            f"checkpoint train-state version {version} is newer than this "
            f"reader ({STATE_VERSION}); refusing a silently-partial resume")
    if doc.get("rng") is not None:
        state.set_rng_state(doc["rng"])
    if doc.get("numpy_rng") is not None:
        state.set_numpy_rng_state(doc["numpy_rng"])
    if scaler is not None and doc.get("scaler") is not None:
        scaler.load_state_dict(doc["scaler"])
    return {"cursor": doc.get("cursor"), "step": doc.get("step"),
            "run_id": doc.get("run_id"), "sharding": doc.get("sharding")}
