"""paddle_tpu_torch.utils: `resume` (the train-state capture and restore
of `Model.save` and `load_latest`) and `cpp_extension` (custom ops and
C++ host kernels). The telemetry, flight-recorder,
chaos, watchdog and profiler utilities are ROADMAP Queue 1 item 6."""
from . import cpp_extension  # noqa: F401,E402
