"""Host utilities of the training loop: logging and metric sinks
(``logging.py``), step timing (``timing.py``), dict-of-tensor sizes
(``trees.py``), profiler windows and device memory (``profiling.py``)
and model FLOPs against the card's peak (``flops.py``). The port's
copies of the JAX package's ``utils/``."""
