"""Training of the port: the LM loss (``tasks.py``), AdamW and its
schedules (``optimizers.py``), the train state (``train_state.py``) and
the step (``train_step.py``). The loop, checkpoints and the launcher
come with ROADMAP queue A item 6."""
