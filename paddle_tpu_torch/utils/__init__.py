"""paddle_tpu_torch.utils: `resume` (the train-state capture and restore
of `Model.save` and `load_latest`). The telemetry, flight-recorder,
chaos, watchdog and profiler utilities are ROADMAP Queue 1 item 6."""
