"""Two supervised hosts over gloo: the counterpart of the JAX package's
``tests/test_elastic_multiprocess.py`` for the port's
``launcher/elastic.py``.

Each host is one process (``tests/_torch_elastic_worker.py``): the
port's launcher in ``--elastic`` mode, whose child trains ``mnist_mlp``
as one rank of a two-rank gloo world on the CPU. Held, as the JAX test
holds them:

- kill and resume: host 0's child hard-exits after step 9 (43), host 1's
  child loses its peer in the step's all-reduce; each supervisor
  restarts once, the world re-forms on a fresh TCP store and resumes
  from step 8: ``metrics.jsonl`` holds [4, 8, 12];
- shrink: host 0 dies for good; host 1 fails its full-size restart
  against the dead coordinator, shrinks to a world of one and finishes
  from the step-8 checkpoint, no step lost or repeated;
- grow back: host 0 returns after the shrink; host 1's watcher preempts
  its child (SIGTERM, checkpoint, exit 0) and both finish at world 2,
  steps non-decreasing and 40 logged once.

The three scenarios start together (one module fixture) and each test
waits for its own; every subprocess has its own timeout. A rendezvous
with a dead coordinator is bounded by ``FRL_TPU_INIT_TIMEOUT_S`` (5 s;
the kill scenario, which never waits on one, keeps 10).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_elastic_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: Per scenario: the rendezvous timeout, the step delay, each
#: subprocess's timeout.
SCENARIOS = {"kill": ("10", "0", 120), "shrink": ("5", "0", 120),
             "grow": ("5", "0.1", 180)}


def _start(mode: str, workdir: Path) -> list:
    init_timeout, delay, _ = SCENARIOS[mode]
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
               "FRL_TPU_COORDINATOR": f"127.0.0.1:{port}",
               "FRL_TPU_NUM_PROCESSES": "2", "FRL_TPU_PROCESS_ID": str(pid),
               "FRL_TEST_WORKDIR": str(workdir),
               "FRL_TPU_INIT_TIMEOUT_S": init_timeout,
               "FRL_STEP_DELAY_S": delay,
               "FRL_TPU_HOST_ADDRESS": "127.0.0.1"}
        if pid == 0:
            env["FRL_FAULT_AT_STEP"] = "9"
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), mode], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _finish(mode: str, procs: list) -> tuple:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SCENARIOS[mode][2])[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """Every scenario's two hosts, started at once: (workdir, procs)."""
    started = {}
    try:
        for mode in SCENARIOS:
            workdir = tmp_path_factory.mktemp(mode)
            started[mode] = (workdir, _start(mode, workdir))
        yield started
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _run(scenarios, mode: str) -> tuple:
    workdir, procs = scenarios[mode]
    return workdir, *_finish(mode, procs)


def _steps(tmp_path) -> list:
    with open(tmp_path / "mnist_mlp" / "metrics.jsonl") as fh:
        return [json.loads(line)["step"] for line in fh]


def _ckpt_steps(tmp_path) -> list:
    return sorted(int(d) for d in os.listdir(tmp_path / "mnist_mlp" / "ckpt")
                  if d.isdigit())


def test_two_hosts_kill_and_resume(scenarios):
    tmp_path, rcs, outs = _run(scenarios, "kill")
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
        assert "elastic: run completed after 1 restart(s)" in out, out[-3000:]
    assert "fault injection: hard-exit" in outs[0]
    assert "fault injection" not in outs[1]
    assert (tmp_path / "mnist_mlp" / "fault_injected").exists()
    assert _steps(tmp_path) == [4, 8, 12]
    assert 12 in _ckpt_steps(tmp_path)


def test_two_hosts_shrink_to_the_survivor(scenarios):
    tmp_path, rcs, outs = _run(scenarios, "shrink")
    assert rcs[0] == 43, outs[0][-3000:]
    assert "fault injection: hard-exit" in outs[0]
    assert rcs[1] == 0, outs[1][-3000:]
    assert "elastic: shrinking from 2 to 1" in outs[1], outs[1][-3000:]
    assert "elastic: run completed" in outs[1]
    assert "fault injection" not in outs[1]
    assert _steps(tmp_path) == [4, 8, 12]
    assert 12 in _ckpt_steps(tmp_path)
    members = os.listdir(tmp_path / "mnist_mlp" / "members")
    assert "host_0.json" not in members, members


def test_two_hosts_grow_back_after_shrink(scenarios):
    tmp_path, rcs, outs = _run(scenarios, "grow")
    assert rcs[0] == 0, outs[0][-3000:]
    assert rcs[1] == 0, outs[1][-3000:]
    assert "elastic: shrinking from 2 to 1" in outs[1], outs[1][-3000:]
    assert "preempting child to re-form" in outs[1], outs[1][-3000:]
    assert "elastic: growing from 1 to 2" in outs[1], outs[1][-3000:]
    assert "elastic: run completed" in outs[1]
    steps = _steps(tmp_path)
    assert steps == sorted(steps), steps
    assert steps[-1] == 40 and steps.count(40) == 1, steps
    assert 40 in _ckpt_steps(tmp_path)
