"""Training of the port: the task losses (``tasks.py``), the optimizers
and their schedules (``optimizers.py``), the train state
(``train_state.py``), the step (``train_step.py``) and the loop
(``loop.py`` ``Trainer``: seeded init, logging, telemetry, eval,
checkpoints through ``checkpoint/manager.py``, preemption). The launcher
(``launcher/launch.py``) drives it from the command line."""
