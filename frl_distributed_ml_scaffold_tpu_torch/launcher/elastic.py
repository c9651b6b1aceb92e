"""Elastic checkpoint-restart supervisor: the port of the JAX package's
``launcher/elastic.py``.

A per-host supervisor (``launch --elastic``) runs the training as a child
process (the launcher again, without ``--elastic``, checkpointing and
resume forced on); when the child dies, the supervisor restarts it after
a backoff and the run resumes from the last committed checkpoint. Each
restarted child joins a fresh process group: the coordinator's child
serves a new TCP store at the coordinator address (``--sim-devices``
makes a new ``file://`` rendezvous every launch), so no generation reads
another's keys. On several hosts each runs its own supervisor; the
membership heartbeats in the run's workdir let survivors shrink to a
smaller world after ``elastic.shrink_after`` failures and grow back when
an evicted host beats again.

A re-formed world restores through the plain path: the port's checkpoint
holds the whole state under plain names and a restore re-shards it onto
any mesh (``checkpoint/manager.py``), so the child's command line does
not carry the JAX supervisor's ``checkpoint.restore_redistribute=true``
(the redistribution service is ROADMAP A13c, and the port refuses that
flag until then).

Fault injection for the drills lives here too: ``FRL_FAULT_AT_STEP=N``
makes the child hard-exit (``os._exit(FAULT_EXIT_CODE)``: no checkpoint
flush, no atexit) after completing step N, once per workdir;
``FRL_FAULT_SIGNAL=TERM`` sends SIGTERM instead (the loop's graceful
preemption: checkpoint, exit 0); ``FRL_STEP_DELAY_S`` stretches each
step so events can land mid-run.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ExperimentConfig
from frl_distributed_ml_scaffold_tpu_torch.faults import RetryPolicy
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

#: The exit code of the injected fault (told apart from a traceback's 1).
FAULT_EXIT_CODE = 43

LAUNCH_MODULE = "frl_distributed_ml_scaffold_tpu_torch.launcher.launch"

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --------------------------------------------------------------------------
# Supervisor (parent side)
# --------------------------------------------------------------------------


def _child_command(args, topo: Optional[dict] = None) -> list[str]:
    """The launcher without ``--elastic``, on the same ``--device``, with
    checkpointing and resume forced on. The forced overrides come last so
    they beat anything the user passed: a supervised run without them
    would restart from step 0 forever. ``topo`` (coordinator /
    num_processes / process_id) replaces the CLI topology after a
    re-formation."""
    topo = topo or {}
    coordinator = topo.get("coordinator", args.coordinator)
    num_processes = topo.get("num_processes", args.num_processes)
    process_id = topo.get("process_id", args.process_id)
    cmd = [sys.executable, "-m", LAUNCH_MODULE, "--config", args.config,
           "--device", args.device]
    if args.device == "cpu" and args.sim_devices:
        cmd += ["--sim-devices", str(args.sim_devices)]
    if coordinator:
        cmd += ["--coordinator", coordinator]
    if num_processes is not None:
        cmd += ["--num-processes", str(num_processes)]
    if process_id is not None:
        cmd += ["--process-id", str(process_id)]
    cmd += list(args.overrides)
    cmd += ["checkpoint.enabled=true", "checkpoint.resume=true"]
    return cmd


class _Membership:
    """Host membership over the run's shared workdir, for the shrink and
    grow policies.

    Each host's supervisor heartbeats ``members/host_<uid>.json`` ({uid,
    endpoint, ts}) from a daemon thread; any supervisor reads the
    directory and counts peers whose heartbeat is older than
    ``peer_timeout_s`` as dead. ``uid`` is the host's original process
    id, stable across re-formations. ``endpoint`` is the coordinator
    address this host would serve as rank 0 (lowest surviving uid wins).
    Supervisors poll independently, so ``supervise`` commits a topology
    change only after two equal reads a heartbeat interval apart.

    Staleness is judged in the shared filesystem's clock: a peer is stale
    when our own freshly beaten file's ``st_mtime`` exceeds the peer's by
    ``peer_timeout_s``; both mtimes come from the same server, so clock
    skew between hosts cancels. ``ts`` is for people reading the file.
    """

    def __init__(self, run_dir: str, uid: int, endpoint: str, registry=None):
        self.dir = os.path.join(run_dir, "members")
        self.uid = uid
        self.endpoint = endpoint
        self.path = os.path.join(self.dir, f"host_{uid}.json")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The heartbeat thread and survivors() both beat: one writer at a
        # time, so the shared tmp file never publishes torn JSON.
        self._beat_lock = threading.Lock()
        self._m_hb_age = (
            registry.gauge(
                "elastic_heartbeat_age_s",
                help="oldest live member heartbeat age at the last "
                     "liveness read (evicted peers excluded)")
            if registry is not None else None)
        self._m_hb_failures = (
            registry.counter(
                "heartbeat_write_failures_total",
                help="membership heartbeat writes that raised (shared-FS "
                     "outage); consecutive failures retire the record")
            if registry is not None else None)

    def beat(self) -> None:
        with self._beat_lock:
            if self._stop.is_set():
                # retire() may have unlinked the file: a straggling beat
                # must not resurrect a departed host.
                return
            faults.maybe_raise("elastic.heartbeat_write", OSError)
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"uid": self.uid, "endpoint": self.endpoint,
                           "ts": time.time()}, fh)
            os.replace(tmp, self.path)  # atomic: no torn reads

    def start(self, interval_s: float, retire_after: int = 10) -> None:
        """Start the heartbeat thread. A failed write is logged, counted
        (``heartbeat_write_failures_total``) and retried next interval;
        ``retire_after`` consecutive failures (0: never) retire the
        record (unlinked, best effort) so peers evict this host at once
        instead of each racing the staleness window. The first beat
        raises to the caller: an unwritable membership directory at
        start is a misconfiguration."""
        self.beat()

        def loop() -> None:
            failures = 0
            while not self._stop.wait(interval_s):
                try:
                    self.beat()
                    failures = 0
                except OSError as e:
                    failures += 1
                    if self._m_hb_failures is not None:
                        self._m_hb_failures.inc()
                    get_logger().warning(
                        "elastic: heartbeat write failed (%s); %d/%s "
                        "consecutive", e, failures,
                        retire_after if retire_after else "inf")
                    if retire_after and failures >= retire_after:
                        get_logger().error(
                            "elastic: %d consecutive heartbeat-write "
                            "failures — retiring membership record for "
                            "uid %d so peers evict deterministically",
                            failures, self.uid)
                        self._stop.set()
                        with self._beat_lock:
                            try:
                                os.remove(self.path)
                            except OSError as rm_err:
                                get_logger().warning(
                                    "elastic: could not unlink retired "
                                    "heartbeat (%s); peers will fall back "
                                    "to the staleness window", rm_err)
                        return

        self._thread = threading.Thread(target=loop, name="elastic-heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def retire(self) -> None:
        """Clean exit: withdraw from membership so peers do not wait out
        the staleness window. Under the beat lock, so the removal is
        final."""
        self.stop()
        with self._beat_lock:
            try:
                os.remove(self.path)
            except OSError:
                pass

    def survivors(self, peer_timeout_s: float) -> Optional[list[dict]]:
        """Hosts with a fresh heartbeat, sorted by uid (self always
        qualifies: we beat right here). ``None`` when liveness cannot be
        judged this poll (our own heartbeat, the directory or a fresh
        peer file unreadable): a partial outage defers the decision
        instead of dropping live peers."""
        try:
            self.beat()
            now = os.stat(self.path).st_mtime
        except OSError as e:
            get_logger().warning("elastic: cannot stat own heartbeat (%s); "
                                 "deferring liveness judgment this poll", e)
            return None
        out = []
        max_age = 0.0
        try:
            names = os.listdir(self.dir)
        except OSError as e:
            get_logger().warning("elastic: cannot list members dir (%s); "
                                 "deferring", e)
            return None
        for name in names:
            if not (name.startswith("host_") and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            try:
                mtime = os.stat(path).st_mtime
            except FileNotFoundError:
                continue  # a clean retire: absent is correct
            except OSError as e:
                get_logger().warning("elastic: cannot stat %s (%s); "
                                     "deferring liveness judgment this "
                                     "poll", name, e)
                return None
            if now - mtime > peer_timeout_s:
                continue  # stale: dead
            # Live members only: a crashed peer's file is never unlinked,
            # and its growing age would pin the gauge forever.
            max_age = max(max_age, now - mtime)
            try:
                with open(path) as fh:
                    rec = json.load(fh)
            except (OSError, ValueError) as e:
                get_logger().warning("elastic: fresh heartbeat %s "
                                     "unreadable (%s); deferring liveness "
                                     "judgment this poll", name, e)
                return None
            out.append(rec)
        if self._m_hb_age is not None:
            self._m_hb_age.set(max_age)
        return sorted(out, key=lambda r: r["uid"])


def _own_endpoint(args) -> tuple[str, Optional[socket.socket]]:
    """The coordinator address this host would serve after taking rank 0,
    and the socket that holds its port until then.

    The host is ``FRL_TPU_HOST_ADDRESS``, else the coordinator's host when
    this host is already rank 0, else this host's name. The port is
    bound now (not listening) and kept open so nothing else takes it;
    ``supervise`` closes it just before the child that serves it starts.
    Rank 0 keeps the address its peers know (the live child binds it)."""
    host = os.environ.get("FRL_TPU_HOST_ADDRESS")
    if host is None:
        if args.process_id in (0, None) and args.coordinator:
            host = args.coordinator.rsplit(":", 1)[0]
        else:
            host = socket.gethostname()
    if args.process_id in (0, None) and args.coordinator:
        return args.coordinator, None
    s = socket.socket()
    try:
        s.bind((host, 0))
    except OSError:
        s.close()
        raise
    return f"{host}:{s.getsockname()[1]}", s


def supervise(args, cfg: ExperimentConfig) -> int:
    """Run the training child under restart supervision; returns the
    final exit code.

    Restart: up to ``elastic.max_restarts`` restarts, each after the
    ``RetryPolicy`` delay (exponential from ``elastic.backoff_s``, capped
    at ``elastic.max_backoff_s``); a child that ran ``reset_after_s`` or
    more refreshes the budget. A clean child exit (0) ends supervision;
    an exhausted budget returns the child's last code.

    Shrink (``elastic.shrink_after > 0``, several processes, an explicit
    ``--process-id``): after that many consecutive failures, read the
    membership; when peers are dead (stale beyond
    ``elastic.peer_timeout_s`` or retired) and this host survives,
    relaunch over the survivors: ranks by uid order, the coordinator the
    lowest uid's endpoint, the budget refreshed. The child's plain
    restore re-shards the checkpoint onto the smaller mesh.

    Grow-back (``elastic.grow``): after a shrink a watcher keeps reading
    the membership while the child runs; when an evicted host beats again
    for two polls, it SIGTERMs the child (which checkpoints and exits 0
    through the loop's preemption path) and the supervisor re-forms at
    the larger world.

    Telemetry: ``supervisor_<uid>.prom`` (restarts, re-formations,
    shrinks, grows, world size, heartbeat age and write failures) and
    ``supervisor_<uid>_trace.json`` (one lane: ``supervise`` around
    ``child_run`` with its ``rc``, ``restart_wait`` and ``reform``) in
    the run's directory, rewritten at every supervision event.
    """
    logger = get_logger()
    env = os.environ.copy()
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")

    from frl_distributed_ml_scaffold_tpu_torch.telemetry import (
        MetricsRegistry,
        Tracer,
        write_prometheus_file,
    )

    telem = MetricsRegistry()
    tracer = Tracer(enabled=True)
    sup_trace = tracer.new_trace(f"supervisor {args.process_id or 0}")
    sup_span = tracer.begin("supervise", trace=sup_trace, cat="elastic",
                            uid=args.process_id, config=args.config)
    m_restarts = telem.counter("elastic_restarts_total",
                               help="child restarts under supervision")
    m_reforms = telem.counter(
        "elastic_membership_changes_total",
        help="committed topology re-formations (shrinks + grows)")
    m_shrinks = telem.counter("elastic_shrinks_total")
    m_grows = telem.counter("elastic_grows_total")
    m_world = telem.gauge("elastic_world_size")
    run_dir_t = os.path.join(cfg.workdir, cfg.name)

    def export_telemetry() -> None:
        try:
            os.makedirs(run_dir_t, exist_ok=True)
            write_prometheus_file(
                telem, os.path.join(run_dir_t, f"supervisor_{uid or 0}.prom"))
            tracer.write_chrome_trace(
                os.path.join(run_dir_t, f"supervisor_{uid or 0}_trace.json"))
        except OSError as e:  # telemetry never kills a run
            logger.warning("elastic: telemetry export failed (%s)", e)

    world = args.num_processes if args.num_processes is not None else 1
    uid = args.process_id
    topo: dict = {}
    membership: Optional[_Membership] = None
    held_port: Optional[socket.socket] = None
    # One interval for the beat rate and the settle / watch windows: the
    # "two reads one heartbeat apart" argument needs them equal.
    heartbeat_interval = max(0.5, cfg.elastic.peer_timeout_s / 4)
    if cfg.elastic.shrink_after > 0 and world > 1:
        if uid is None:
            logger.warning(
                "elastic: shrink_after=%d requires an explicit "
                "--process-id; shrink policy DISABLED for this run",
                cfg.elastic.shrink_after)
        else:
            endpoint, held_port = _own_endpoint(args)
            membership = _Membership(run_dir_t, uid, endpoint,
                                     registry=telem)
            membership.start(interval_s=heartbeat_interval,
                             retire_after=cfg.elastic.heartbeat_retire_after)

    initial_world = world
    m_world.set(world)
    restart_retry = RetryPolicy(max_retries=cfg.elastic.max_restarts,
                                backoff_s=cfg.elastic.backoff_s,
                                max_backoff_s=cfg.elastic.max_backoff_s)
    restarts = 0
    consecutive_failures = 0
    # Budget-free restarts after a grow commit: the survivors' failed
    # rendezvous while a revived host shrinks its original topology down
    # to the committed one are the grow's doing, not the child's.
    grow_grace = 0

    def settled_survivors() -> Optional[list[dict]]:
        """Two equal survivor reads one heartbeat interval apart, or
        None: never commit a topology change off a single poll."""
        surv = membership.survivors(cfg.elastic.peer_timeout_s)
        time.sleep(heartbeat_interval)
        surv2 = membership.survivors(cfg.elastic.peer_timeout_s)
        if surv is None or surv2 is None:
            logger.warning("elastic: liveness unjudgeable (shared-FS "
                           "error); deferring topology decision")
            return None
        if [r["uid"] for r in surv] != [r["uid"] for r in surv2]:
            logger.warning(
                "elastic: survivor set unsettled (%s vs %s); deferring "
                "topology decision", [r["uid"] for r in surv],
                [r["uid"] for r in surv2])
            return None
        return surv

    def commit_reform(surv: list[dict], reason: str) -> None:
        """Adopt the settled survivor set as the world (shrink or grow):
        ranks by uid order, the coordinator the lowest uid's endpoint,
        budgets refreshed."""
        nonlocal world, topo, cmd, restarts, consecutive_failures, \
            held_port, grow_grace
        uids = [r["uid"] for r in surv]
        new_world = len(surv)
        new_rank = uids.index(uid)
        new_coord = surv[0]["endpoint"] if new_world > 1 else None
        logger.warning(
            "elastic: %s from %d to %d processes; new rank=%d "
            "coordinator=%s — resuming from last checkpoint with "
            "resharding restore", reason, world, new_world, new_rank,
            new_coord)
        tracer.emit("reform", t0=time.perf_counter(), dur_s=0.0,
                    trace=sup_trace, parent=sup_span, cat="elastic",
                    reason=reason, frm=world, to=new_world, rank=new_rank)
        world = new_world
        m_reforms.inc()
        (m_grows if reason == "growing" else m_shrinks).inc()
        m_world.set(new_world)
        export_telemetry()
        topo = {"num_processes": new_world, "process_id": new_rank,
                "coordinator": new_coord}
        if new_rank == 0 and new_world > 1 and held_port is not None:
            # The child binds the port held since startup: release it
            # only now.
            held_port.close()
            held_port = None
        # The plain restore re-shards onto the new world: no
        # checkpoint.restore_redistribute (module docstring).
        cmd = _child_command(args, topo)
        restarts = 0
        consecutive_failures = 0
        grow_grace = 3 if reason == "growing" else 0

    def grow_watch(proc: subprocess.Popen, stop: threading.Event,
                   grow_req: threading.Event) -> None:
        """After a shrink: when the settled survivor set outgrows the
        world (an evicted host beats again), preempt the child (SIGTERM:
        checkpoint, clean exit) so the main loop re-forms larger."""
        consecutive = 0
        while not stop.wait(heartbeat_interval):
            surv = membership.survivors(cfg.elastic.peer_timeout_s)
            if (surv is not None and uid in [r["uid"] for r in surv]
                    and world < len(surv) <= initial_world):
                consecutive += 1
                if consecutive >= 2:
                    logger.warning(
                        "elastic: evicted peer(s) heartbeating again "
                        "(%d survivors > world %d); preempting child to "
                        "re-form at the larger world", len(surv), world)
                    grow_req.set()
                    proc.terminate()
                    return
            else:
                consecutive = 0

    try:
        cmd = _child_command(args)
        logger.info("elastic: supervising %s", " ".join(cmd))
        while True:
            t0 = time.monotonic()
            t0_span = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=_REPO_ROOT, env=env)
            grow_req = threading.Event()
            stop_watch = threading.Event()
            watcher: Optional[threading.Thread] = None
            if (membership is not None and cfg.elastic.grow
                    and world < initial_world):
                watcher = threading.Thread(
                    target=grow_watch, args=(proc, stop_watch, grow_req),
                    name="elastic-grow-watch", daemon=True)
                watcher.start()
            rc = proc.wait()
            stop_watch.set()
            if watcher is not None:
                watcher.join(timeout=5)
            elapsed = time.monotonic() - t0
            tracer.emit("child_run", t0=t0_span, dur_s=elapsed,
                        trace=sup_trace, parent=sup_span, cat="elastic",
                        rc=rc, world=world, restarts=restarts)

            if grow_req.is_set():
                surv = settled_survivors()
                if (surv is not None and uid in [r["uid"] for r in surv]
                        and world < len(surv) <= initial_world):
                    commit_reform(surv, "growing")
                    continue
                # A fizzled grow relaunches free only when the exit was
                # our preemption (0 through the loop's path, or -SIGTERM
                # mid-start); a child that died of its own fault in the
                # same interval is counted as a failure.
                if rc == 0 or rc == -signal.SIGTERM:
                    logger.warning("elastic: grow fizzled (peer gone "
                                   "again?); continuing at world=%d", world)
                    continue
                logger.warning("elastic: grow fizzled AND child died on "
                               "its own (rc=%d); counting the failure", rc)

            if rc == 0:
                logger.info("elastic: run completed after %d restart(s)",
                            restarts)
                return 0
            if elapsed >= cfg.elastic.reset_after_s:
                restarts = 0  # the child made real progress: fresh budget
                consecutive_failures = 0
            consecutive_failures += 1

            if (membership is not None and world > 1
                    and consecutive_failures >= cfg.elastic.shrink_after):
                surv = settled_survivors()
                if (surv is not None and uid in [r["uid"] for r in surv]
                        and len(surv) < world):
                    logger.warning("elastic: dead peers stale > %.0fs",
                                   cfg.elastic.peer_timeout_s)
                    commit_reform(surv, "shrinking")
                    continue  # relaunch at once: the peers already waited

            if grow_grace > 0:
                grow_grace -= 1
                logger.warning("elastic: child rc=%d during grow "
                               "re-formation; budget-free retry (%d grace "
                               "left)", rc, grow_grace)
                time.sleep(cfg.elastic.backoff_s)
                continue

            if restarts >= cfg.elastic.max_restarts:
                logger.error("elastic: child rc=%d; restart budget (%d) "
                             "exhausted — giving up", rc,
                             cfg.elastic.max_restarts)
                return rc
            restarts += 1
            m_restarts.inc()
            export_telemetry()
            delay = restart_retry.delay(restarts)
            logger.warning(
                "elastic: child died rc=%d after %.1fs; restart %d/%d in "
                "%.1fs (resume from last checkpoint)", rc, elapsed,
                restarts, cfg.elastic.max_restarts, delay)
            t_wait = time.perf_counter()
            time.sleep(delay)
            tracer.emit("restart_wait", t0=t_wait,
                        dur_s=time.perf_counter() - t_wait,
                        trace=sup_trace, parent=sup_span, cat="elastic",
                        restart=restarts, rc=rc)
    finally:
        if held_port is not None:
            held_port.close()
        if membership is not None:
            membership.retire()
        sup_span.end(world=world)
        export_telemetry()


# --------------------------------------------------------------------------
# Fault injection (child side)
# --------------------------------------------------------------------------


def fault_hook_from_env(
    cfg: ExperimentConfig,
    before_hard_exit: Optional[Callable[[], None]] = None,
) -> Optional[Callable[[int, dict], None]]:
    """The ``on_step`` hook of the supervised drills, or None when the
    environment asks for nothing.

    ``FRL_FAULT_AT_STEP=N``: after completing step N (``step + 1 == N``)
    the process dies as ``FRL_FAULT_SIGNAL`` says: unset or ``KILL``,
    ``os._exit(FAULT_EXIT_CODE)`` (no checkpoint flush, no atexit;
    ``before_hard_exit`` runs first: the launcher kills the
    ``--sim-devices`` ranks it started there, so none is left holding the
    rendezvous); ``TERM``, SIGTERM to itself
    (the loop's graceful preemption: finish the step, checkpoint, exit
    0). A marker file in the run's directory makes the fault one-shot, so
    the restarted child survives. ``FRL_STEP_DELAY_S`` sleeps that long
    after every step. The in-process fault sites (``faults/plan.py``)
    count per process; this marker does not."""
    delay_s = float(os.environ.get("FRL_STEP_DELAY_S", "0") or 0)
    spec = os.environ.get("FRL_FAULT_AT_STEP")
    fault_step = int(spec) if spec else 0
    fault_signal = (os.environ.get("FRL_FAULT_SIGNAL") or "KILL").upper()
    if fault_signal not in ("KILL", "TERM"):
        raise ValueError(
            f"FRL_FAULT_SIGNAL={fault_signal!r}: want KILL (hard exit) "
            "or TERM (graceful preemption)")
    marker = os.path.join(cfg.workdir, cfg.name, "fault_injected")
    if fault_step and os.path.exists(marker):
        fault_step = 0
    if not fault_step and not delay_s:
        return None
    logger = get_logger()

    def hook(step: int, metrics: dict) -> None:
        if delay_s:
            time.sleep(delay_s)
        if fault_step and step + 1 == fault_step:
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as fh:
                fh.write(str(fault_step))
            if fault_signal == "TERM":
                logger.warning(
                    "fault injection: SIGTERM self-preemption after "
                    "step %d (graceful checkpoint-and-exit path)",
                    fault_step)
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGTERM)
                return
            logger.warning("fault injection: hard-exit(%d) after step %d",
                           FAULT_EXIT_CODE, fault_step)
            if before_hard_exit is not None:
                before_hard_exit()
            sys.stdout.flush()
            os._exit(FAULT_EXIT_CODE)

    return hook
