"""One host's supervisor in ``tests/test_torch_elastic_ranks.py``: the
port's launcher in ``--elastic`` mode over a two-process gloo world
(``mnist_mlp`` on the CPU), as a host of a real cluster runs it.

    python tests/_torch_elastic_worker.py kill|shrink|grow

Environment (set by the test): ``FRL_TPU_COORDINATOR``,
``FRL_TPU_NUM_PROCESSES``, ``FRL_TPU_PROCESS_ID``, ``FRL_TEST_WORKDIR``;
``FRL_FAULT_AT_STEP`` on host 0 only; ``FRL_TPU_INIT_TIMEOUT_S`` bounds
a rendezvous with a dead coordinator; ``FRL_TPU_HOST_ADDRESS`` pins the
published endpoints to loopback.

- ``kill``: host 0's child dies after step 9, host 1's child loses its
  peer; both supervisors restart and the world resumes from step 8.
- ``shrink``: host 0 dies for good (no restart budget); host 1 fails
  against the dead coordinator, shrinks to a world of one and finishes.
- ``grow``: as ``shrink``, then host 0 comes back (a fresh supervisor
  with the original topology) once the shrunk world has saved a step at
  or past ``GATE_STEP``; host 1's watcher preempts its child and both
  finish the run at world 2.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: The shrunk world's checkpoint step that host 0 waits for in ``grow``.
GATE_STEP = 16
COMMON = ["trainer.log_every=4", "trainer.eval_every=0",
          "data.global_batch_size=64", "data.prefetch=0",
          "model.hidden_sizes=32", "precision.policy=fp32",
          "checkpoint.async_save=false", "elastic.backoff_s=0.1"]
MODES = {
    "kill": ["trainer.total_steps=12", "checkpoint.save_every=4"],
    "shrink": ["trainer.total_steps=12", "checkpoint.save_every=4",
               "elastic.shrink_after=2", "elastic.peer_timeout_s=2"],
    "grow": ["trainer.total_steps=40", "checkpoint.save_every=4",
             "elastic.shrink_after=2", "elastic.peer_timeout_s=2"],
}


def launch(mode: str, extra: list) -> int:
    from frl_distributed_ml_scaffold_tpu_torch.launcher.launch import main

    return main(["--config=mnist_mlp", "--device=cpu", "--elastic",
                 "--coordinator", os.environ["FRL_TPU_COORDINATOR"],
                 "--num-processes", os.environ["FRL_TPU_NUM_PROCESSES"],
                 "--process-id", os.environ["FRL_TPU_PROCESS_ID"],
                 *COMMON, *MODES[mode],
                 "workdir=" + os.environ["FRL_TEST_WORKDIR"], *extra])


def main(mode: str) -> int:
    if os.environ["FRL_TPU_PROCESS_ID"] != "0" or mode == "kill":
        return launch(mode, [])
    # Host 0 of shrink / grow: one fault, no restart.
    rc = launch(mode, ["elastic.max_restarts=0"])
    if mode == "shrink":
        return rc
    if rc != 43:
        print(f"grow worker: the fault's rc 43 expected, got {rc}")
        return 7
    ckpt = os.path.join(os.environ["FRL_TEST_WORKDIR"], "mnist_mlp", "ckpt")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        steps = [int(d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt)
                                  else []) if d.isdigit()]
        if steps and max(steps) >= GATE_STEP:
            break
        time.sleep(0.2)
    else:
        print("grow worker: the shrunk world never reached the gate")
        return 7
    # Back from repair: a fresh supervisor, the original topology (the
    # fault marker keeps the hook disarmed).
    return launch(mode, ["elastic.max_restarts=8"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
