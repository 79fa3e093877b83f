"""Chaos campaign harness: prove the self-healing serve heals.

Counterpart of ``sartsolver_tpu/resilience/chaos.py``, host-only: it imports
numpy and neither torch nor JAX. Its campaigns run the port's own workers
(``python -m sartsolver_tpu_torch.cli serve`` and ``fleet``, and for
``--pod N`` the solver CLI itself), read their solution files through the
port's HDF5 codec (``io/h5.py``), and draw the JAX package's schedules for
every seed.

``chaos`` (docs/SERVING.md §9, docs/RESILIENCE.md §10) runs
seeded randomized fault schedules against a REAL supervised engine
while a workload generator submits requests, then asserts the global
invariants the whole resilience stack promises:

1. **Exactly one outcome** — every accepted request ends with exactly
   one ``completed`` journal marker and a ``done`` response, across any
   number of kills and restarts (no request lost, none double-solved).
2. **Byte-identical outputs** — every solution file matches an
   undisturbed reference run dataset-for-dataset.
3. **Bounded unavailability** — supervised restarts never exceed the
   schedule's kill count (each SIGKILL buys at most one restart) and
   the crash-loop breaker never opens under the drill's budget.
4. **State continuity** — the final engine checkpoint's cumulative
   counters account every request exactly once across all process
   incarnations (``engine_requests_total``; with ``--slo_ms``, the SLO
   ok+breach pair) — a counter reset or a double solve both break it.

A schedule is drawn deterministically from the campaign seed: transient
fault arming (site × kind × count from the *retryable* subset of the
``SART_FAULT`` registry — faults the stack recovers from without
changing outcomes) plus process-level SIGKILLs timed inside the
deterministic crash windows the engine announces on stderr —
``SART_JOURNAL_POINT`` (each journal marker), ``SART_CKPT_POINT``
(mid-checkpoint), ``SART_RESPONSE_POINT`` (mid-response-write). The
same seed replays the same campaign.

Usage::

    python -m sartsolver_tpu_torch.cli chaos --engine_dir /tmp/chaos \
        --seeds 0,1 -- --use_cpu -m 40 -c 1e-12 rtm_*.h5 img_*.h5

Everything after ``--`` is the serve worker's own flag set (solver
flags + input files). Exit codes: 0 all invariants hold on every seed;
1 flag/usage error; 2 an invariant was violated (the report names it).

``--fleet M`` swaps in the fleet campaign (docs/SERVING.md §10), ``--pod
N`` the pod campaign (:class:`PodCampaign`, docs/RESILIENCE.md §11):
N fake-pod solver workers, one SIGKILLed in a stride barrier or inside a
checkpoint's append, the survivors' exit 3 and the whole pod's resume
judged. Everything after ``--`` is then the solver's flag set (the
scheduler: ``--no_guess --batch_frames K``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# Transient fault pool: sites the stack retries/recovers WITHOUT
# changing any request's outcome (journal appends and checkpoint writes
# retry in place; frame/RTM reads retry inside ingest). Sites that fail
# requests by design (session.attach, solve.dispatch) belong in the
# targeted drills of tests/test_engine.py, not here — this harness pins
# byte-identity against an undisturbed run.
FAULT_POOL: Tuple[Tuple[str, str], ...] = (
    ("journal.append", "io"),
    ("state.checkpoint", "io"),
    ("hdf5.frame_read", "io"),
    ("hdf5.rtm_ingest", "io"),
)

# Kill windows and the stderr marker lines that announce them.
KILL_WINDOWS = ("accepted", "dispatched", "pre-flush", "ckpt", "response")

_SPAWN_RE = re.compile(r"worker-spawn pid=(\d+)")
_JOURNAL_RE = re.compile(r"SART_JOURNAL_POINT (\S+)")
_CKPT_RE = re.compile(r"SART_CKPT_POINT")
# only COMPLETION responses: a kill there dies with the completed
# marker durable but the response unwritten — the window that drills
# the replay-republish and pre-respond-checkpoint contracts. Acceptance
# responses would shadow it (they are written first) and their kill is
# equivalent to the 'accepted' journal window.
_RESPONSE_RE = re.compile(r"SART_RESPONSE_POINT \S+ state=done")


def line_window(line: str) -> Optional[str]:
    """The kill window a combined-output line announces, or None."""
    m = _JOURNAL_RE.search(line)
    if m:
        return m.group(1)
    if _CKPT_RE.search(line):
        return "ckpt"
    if _RESPONSE_RE.search(line):
        return "response"
    return None


class FaultSchedule:
    """One seed's deterministic campaign: armed faults + kill plan."""

    def __init__(self, seed: int, *, max_kills: int = 2,
                 max_faults: int = 2):
        self.seed = int(seed)
        rng = np.random.default_rng([0x5A47, self.seed])
        n_faults = int(rng.integers(1, max_faults + 1))
        picks = rng.choice(len(FAULT_POOL), size=n_faults, replace=False)
        self.faults = [
            (FAULT_POOL[int(i)][0], FAULT_POOL[int(i)][1],
             int(rng.integers(1, 3)))
            for i in picks
        ]
        n_kills = int(rng.integers(1, max_kills + 1))
        self.kills: List[Tuple[str, int]] = [
            (KILL_WINDOWS[int(rng.integers(0, len(KILL_WINDOWS)))],
             int(rng.integers(1, 4)))
            for _ in range(n_kills)
        ]

    def fault_spec(self) -> str:
        return ",".join(f"{site}:{kind}:1:{count}"
                        for site, kind, count in self.faults)

    def window_env(self) -> Dict[str, str]:
        """Only the crash windows the kill plan targets are slowed."""
        env = {}
        windows = {w for w, _ in self.kills}
        if windows & {"accepted", "dispatched", "pre-flush"}:
            env["SART_TEST_JOURNAL_DELAY"] = "0.4"
        if "ckpt" in windows:
            env["SART_TEST_CKPT_DELAY"] = "0.3"
        if "response" in windows:
            env["SART_TEST_RESPONSE_DELAY"] = "0.3"
        return env

    def describe(self) -> dict:
        return {"seed": self.seed,
                "faults": [f"{s}:{k}:1:{c}" for s, k, c in self.faults],
                "kills": [f"{w}#{occ}" for w, occ in self.kills]}


def _solution_datasets(path: str) -> Dict[str, "np.ndarray"]:
    from sartsolver_tpu_torch.io import h5

    with h5.File(path, "r") as f:
        sol = f["solution"]
        return {key: sol[key][:] for key in sol}


def _stage_requests(engine_dir: str, requests: List[dict]) -> None:
    ingest = os.path.join(engine_dir, "ingest")
    os.makedirs(ingest, exist_ok=True)
    from sartsolver_tpu_torch.utils import atomicio

    for i, payload in enumerate(requests):
        path = os.path.join(ingest, f"{i:03d}-{payload['id']}.json")
        atomicio.write_json_atomic(path, payload, fsync=False)


class CampaignError(Exception):
    """An invariant violation (exit 2)."""


class ChaosCampaign:
    """Run the reference pass + one supervised seed pass and judge."""

    def __init__(self, *, root: str, serve_args: List[str],
                 requests: List[dict], slo_ms: Optional[float],
                 timeout: float, verbose=print):
        self.root = root
        self.serve_args = list(serve_args)
        self.requests = requests
        self.slo_ms = slo_ms
        self.timeout = float(timeout)
        self.say = verbose
        self.reference: Optional[Dict[str, dict]] = None

    # ---- process plumbing ------------------------------------------------

    def _env(self, extra: Optional[dict] = None) -> dict:
        env = dict(os.environ)
        for key in ("SART_FAULT", "SART_TEST_JOURNAL_DELAY",
                    "SART_TEST_CKPT_DELAY", "SART_TEST_RESPONSE_DELAY",
                    "SART_TEST_SERVE_CRASH"):
            env.pop(key, None)
        env["PYTHONUNBUFFERED"] = "1"  # the kill plan watches live lines
        env.update(extra or {})
        return env

    def _serve_cmd(self, engine_dir: str, *extra: str) -> List[str]:
        cmd = [sys.executable, "-m", "sartsolver_tpu_torch.cli", "serve",
               "--engine_dir", engine_dir, "--poll_interval", "0.05",
               "--idle_exit", "1.5",
               # keep the full journal history: the exactly-once audit
               # counts completed markers across the whole campaign
               "--journal_rotate_bytes", "0",
               *extra]
        if self.slo_ms is not None:
            cmd += ["--slo_ms", str(self.slo_ms)]
        return cmd + self.serve_args

    # ---- reference pass --------------------------------------------------

    def run_reference(self) -> None:
        ref_dir = os.path.join(self.root, "reference")
        os.makedirs(ref_dir, exist_ok=True)
        _stage_requests(ref_dir, self.requests)
        self.say(f"chaos: reference pass in {ref_dir}")
        res = subprocess.run(
            self._serve_cmd(ref_dir), env=self._env(),
            capture_output=True, text=True, timeout=self.timeout,
        )
        if res.returncode != 0:
            raise CampaignError(
                f"reference serve exited {res.returncode}:\n"
                f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}"
            )
        self.reference = {}
        for payload in self.requests:
            rid = payload["id"]
            out = os.path.join(ref_dir, "outputs", f"{rid}.h5")
            resp = self._response(ref_dir, rid)
            if not resp or resp.get("state") != "done":
                raise CampaignError(
                    f"reference run left no done response for {rid!r}"
                )
            self.reference[rid] = {
                "datasets": _solution_datasets(out),
                "status": (resp.get("outcome") or {}).get("status"),
            }

    @staticmethod
    def _response(engine_dir: str, rid: str) -> Optional[dict]:
        try:
            with open(os.path.join(engine_dir, "responses",
                                   f"{rid}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ---- seed pass -------------------------------------------------------

    def run_seed(self, schedule: FaultSchedule) -> dict:
        seed_dir = os.path.join(self.root, f"seed{schedule.seed}")
        os.makedirs(seed_dir, exist_ok=True)
        _stage_requests(seed_dir, self.requests)
        env = self._env(schedule.window_env())
        if schedule.faults:
            env["SART_FAULT"] = schedule.fault_spec()
            env["SART_FAULT_SEED"] = str(schedule.seed)
            env["SART_RETRY_BASE_DELAY"] = "0.02"
        self.say(f"chaos: seed {schedule.seed} "
                 f"faults=[{schedule.fault_spec()}] "
                 f"kills={schedule.describe()['kills']}")
        cmd = self._serve_cmd(
            seed_dir, "--supervised",
            "--restart_backoff", "0.05", "--restart_backoff_max", "0.5",
            # breaker budget far above the kill plan: the drill asserts
            # the breaker does NOT open under scheduled faults (the
            # storm drill in tests/test_selfheal.py proves it opens)
            "--crash_loop_window", "30",
            "--crash_loop_threshold", str(len(schedule.kills) + 10),
        )
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        guard = threading.Timer(self.timeout, proc.kill)
        guard.start()
        kills_fired = 0
        lines: List[str] = []
        try:
            pending = list(schedule.kills)
            worker_pid: Optional[int] = None
            count = 0
            for line in proc.stdout:
                lines.append(line)
                m = _SPAWN_RE.search(line)
                if m:
                    worker_pid = int(m.group(1))
                    continue
                if not pending:
                    continue
                window = line_window(line)
                if window != pending[0][0]:
                    continue
                count += 1
                if count < pending[0][1]:
                    continue
                # the worker is sleeping inside the announced window:
                # this SIGKILL lands deterministically mid-commit
                if worker_pid is not None:
                    try:
                        os.kill(worker_pid, signal.SIGKILL)
                        kills_fired += 1
                        self.say(f"chaos: seed {schedule.seed} SIGKILL "
                                 f"pid={worker_pid} in window "
                                 f"{pending[0][0]}#{pending[0][1]}")
                    except OSError:
                        pass
                pending.pop(0)
                count = 0
            rc = proc.wait(timeout=self.timeout)
        finally:
            guard.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        text = "".join(lines)
        if rc != 0:
            raise CampaignError(
                f"seed {schedule.seed}: supervised serve exited {rc} "
                f"(expected 0)\n{text[-6000:]}"
            )
        verdict = self._judge(seed_dir, schedule, kills_fired, text)
        verdict["exit"] = rc
        return verdict

    # ---- invariants ------------------------------------------------------

    def _judge(self, seed_dir: str, schedule: FaultSchedule,
               kills_fired: int, text: str) -> dict:
        from sartsolver_tpu_torch.engine.journal import RequestJournal
        from sartsolver_tpu_torch.engine.state import StateStore

        ids = [r["id"] for r in self.requests]
        # 1a. journal: every request completed, none pending
        journal = RequestJournal(os.path.join(seed_dir, "journal.jsonl"))
        completed, pending_reqs = journal.replay()
        if set(completed) != set(ids) or pending_reqs:
            raise CampaignError(
                f"seed {schedule.seed}: journal shows completed="
                f"{sorted(completed)} pending="
                f"{[r.id for r in pending_reqs]}, expected all of {ids}"
            )
        # 1b. exactly once: one completed marker per id over the WHOLE
        # campaign (rotation disabled above, so history is complete)
        marks: Dict[str, int] = {}
        with open(journal.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("marker") == "completed":
                    marks[rec["id"]] = marks.get(rec["id"], 0) + 1
        doubled = {rid: n for rid, n in marks.items() if n != 1}
        if doubled:
            raise CampaignError(
                f"seed {schedule.seed}: completed-marker counts != 1: "
                f"{doubled} (a request was lost or double-solved)"
            )
        # 1c. every request has a done response with the reference status
        for rid in ids:
            resp = self._response(seed_dir, rid)
            if not resp or resp.get("state") != "done":
                raise CampaignError(
                    f"seed {schedule.seed}: no done response for {rid!r}"
                )
            status = (resp.get("outcome") or {}).get("status")
            want = self.reference[rid]["status"]
            if status != want:
                raise CampaignError(
                    f"seed {schedule.seed}: {rid!r} ended {status!r}, "
                    f"reference says {want!r}"
                )
        # 2. byte-identical outputs vs the undisturbed run
        for rid in ids:
            got = _solution_datasets(
                os.path.join(seed_dir, "outputs", f"{rid}.h5")
            )
            ref = self.reference[rid]["datasets"]
            if sorted(got) != sorted(ref):
                raise CampaignError(
                    f"seed {schedule.seed}: {rid!r} dataset set differs"
                )
            for key in sorted(ref):
                if not np.array_equal(got[key], ref[key]):
                    raise CampaignError(
                        f"seed {schedule.seed}: {rid!r} solution/{key} "
                        "not byte-identical to the undisturbed run"
                    )
        # 3. bounded unavailability: each kill buys at most one restart,
        # and the breaker stayed closed under the drill budget
        restarts = text.count("supervisor: worker-crash code=")
        if restarts > kills_fired:
            raise CampaignError(
                f"seed {schedule.seed}: {restarts} restart(s) for "
                f"{kills_fired} scheduled kill(s) — the worker is "
                "crashing on its own"
            )
        if "lame-duck-enter" in text:
            raise CampaignError(
                f"seed {schedule.seed}: crash-loop breaker opened "
                "under the drill's restart budget"
            )
        # 4. counter continuity across incarnations (engine/state.py):
        # cumulative totals account each request exactly once
        payload = StateStore(os.path.join(seed_dir, "state.jsonl")).load()
        if payload is None:
            raise CampaignError(
                f"seed {schedule.seed}: no consistent state checkpoint"
            )
        totals: Dict[str, float] = {}
        slo_total = 0.0
        for snap in payload.get("metrics") or []:
            if snap.get("kind") != "counter":
                continue
            name = snap.get("name")
            if name == "engine_requests_total":
                outcome = (snap.get("labels") or {}).get("outcome", "?")
                totals[outcome] = totals.get(outcome, 0) \
                    + float(snap.get("value", 0))
            elif name in ("engine_slo_ok_total",
                          "engine_slo_breach_total"):
                slo_total += float(snap.get("value", 0))
        if sum(totals.values()) != len(ids):
            raise CampaignError(
                f"seed {schedule.seed}: cumulative "
                f"engine_requests_total={totals} does not account "
                f"{len(ids)} request(s) exactly once — counter "
                "continuity broke across a restart"
            )
        if self.slo_ms is not None and slo_total != len(ids):
            raise CampaignError(
                f"seed {schedule.seed}: SLO ok+breach={slo_total:g} for "
                f"{len(ids)} request(s) — SLO burn not continuous "
                "across restarts"
            )
        return {
            **schedule.describe(),
            "kills_fired": kills_fired,
            "restarts": restarts,
            "requests": len(ids),
            "requests_total": totals,
            "verdict": "ok",
        }


# ---------------------------------------------------------------------------
# fleet campaign (docs/SERVING.md §10)
# ---------------------------------------------------------------------------

# fleet workers tag their window announcements (journal.py) so the kill
# plan can target the SPECIFIC worker sleeping inside the window
_WINDOW_WORKER_RE = re.compile(r"SART_JOURNAL_POINT (\S+) worker=w(\d+)")
_SPAWN_WORKER_RE = re.compile(
    r"worker-spawn pid=(\d+) spawn=\d+ worker=(\d+)")


class FleetSchedule:
    """One seed's fleet campaign: SIGKILL one of M workers inside a
    journal commit window, optionally SIGKILL the whole node (controller
    + workers) while the controller sleeps inside its handoff-marker
    append, with forced session evictions armed throughout."""

    WINDOWS = ("accepted", "dispatched", "pre-flush")

    def __init__(self, seed: int, *, size: int = 3):
        self.seed = int(seed)
        self.size = max(2, int(size))
        rng = np.random.default_rng([0x5A48, self.seed])
        self.window = self.WINDOWS[int(rng.integers(0,
                                                    len(self.WINDOWS)))]
        self.occurrence = int(rng.integers(1, 3))
        self.kill_controller_in_handoff = bool(rng.integers(0, 2))
        # fixed, not drawn: with >= 2*size requests some worker
        # incarnation must lease twice (pigeonhole), so every-2nd-lease
        # eviction provably fires — the campaign's eviction-under-load
        # leg can assert it happened instead of hoping
        self.evict_every = 2

    def describe(self) -> dict:
        return {"seed": self.seed,
                "window": f"{self.window}#{self.occurrence}",
                "controller_kill": self.kill_controller_in_handoff,
                "evict_every": self.evict_every}


class FleetCampaign(ChaosCampaign):
    """Reference pass (undisturbed single serve) + fleet passes:
    ``sartsolve fleet`` with M workers under seeded worker/controller
    SIGKILLs and forced session evictions, judged on the same
    invariants — fleet-wide: exactly one completed marker per id across
    ALL worker journals, done responses in the SHARED responses dir,
    byte-identical outputs, counter continuity summed across every
    worker's state checkpoint."""

    def __init__(self, *, size: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.size = max(2, int(size))

    def _fleet_cmd(self, fleet_dir: str) -> List[str]:
        worker = ["--poll_interval", "0.05", "--idle_exit", "3.0",
                  "--journal_rotate_bytes", "0"]
        if self.slo_ms is not None:
            worker += ["--slo_ms", str(self.slo_ms)]
        return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "fleet",
                "--fleet_dir", fleet_dir, "--size", str(self.size),
                "--restart_backoff", "0.05",
                "--restart_backoff_max", "0.5",
                "--poll_interval", "0.05",
                "--"] + worker + self.serve_args

    def run_fleet_seed(self, schedule: FleetSchedule) -> dict:
        fleet_dir = os.path.join(self.root, f"fleet{schedule.seed}")
        os.makedirs(os.path.join(fleet_dir, "ingest"), exist_ok=True)
        # requests go through the controller intake: tenant-affinity
        # routing distributes them across the worker shards
        _stage_requests(fleet_dir, self.requests)
        env = self._env({
            "SART_TEST_JOURNAL_DELAY": "0.25",
            "SART_TEST_EVICT_EVERY": str(schedule.evict_every),
        })
        self.say(f"chaos: fleet seed {schedule.seed} "
                 f"{schedule.describe()}")
        cmd = self._fleet_cmd(fleet_dir)
        pids: Dict[int, int] = {}
        lines: List[str] = []
        kills_fired = 0
        controller_kills = 0
        relaunches = 0
        worker_kill_pending = True
        count = 0
        launch = 0
        while True:
            launch += 1
            proc = subprocess.Popen(cmd, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            guard = threading.Timer(self.timeout, proc.kill)
            guard.start()
            try:
                for line in proc.stdout:
                    lines.append(line)
                    m = _SPAWN_WORKER_RE.search(line)
                    if m:
                        pids[int(m.group(2))] = int(m.group(1))
                        continue
                    if (schedule.kill_controller_in_handoff
                            and controller_kills == 0
                            and line_window(line) == "handoff"):
                        # only the controller appends handoff markers:
                        # it is sleeping inside the append — the marker
                        # is durable, the re-staged payload is NOT. The
                        # node-crash model takes out the controller AND
                        # every worker; recovery on relaunch must
                        # re-stage via the needs_restage gate.
                        for pid in [proc.pid] + list(pids.values()):
                            try:
                                os.kill(pid, signal.SIGKILL)
                            except OSError:
                                pass
                        controller_kills += 1
                        self.say(f"chaos: fleet seed {schedule.seed} "
                                 "SIGKILL controller (+workers) in "
                                 "handoff window")
                        continue
                    if not worker_kill_pending:
                        continue
                    m = _WINDOW_WORKER_RE.search(line)
                    if not m or m.group(1) != schedule.window:
                        continue
                    count += 1
                    if count < schedule.occurrence:
                        continue
                    victim = int(m.group(2))
                    pid = pids.get(victim)
                    if pid is not None:
                        try:
                            os.kill(pid, signal.SIGKILL)
                            kills_fired += 1
                            self.say(f"chaos: fleet seed "
                                     f"{schedule.seed} SIGKILL worker "
                                     f"{victim} pid={pid} in window "
                                     f"{schedule.window}"
                                     f"#{schedule.occurrence}")
                        except OSError:
                            pass
                    worker_kill_pending = False
                rc = proc.wait(timeout=self.timeout)
            finally:
                guard.cancel()
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            if controller_kills and relaunches == 0:
                relaunches += 1
                self.say(f"chaos: fleet seed {schedule.seed} "
                         "relaunching after controller kill")
                continue
            break
        text = "".join(lines)
        if rc != 0:
            for pid in pids.values():  # no stray workers past a failure
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            raise CampaignError(
                f"fleet seed {schedule.seed}: controller exited {rc} "
                f"(expected 0)\n{text[-6000:]}"
            )
        verdict = self._judge_fleet(fleet_dir, schedule, kills_fired,
                                    controller_kills, text)
        verdict["exit"] = rc
        return verdict

    # ---- fleet-wide invariants -------------------------------------------

    def _judge_fleet(self, fleet_dir: str, schedule: FleetSchedule,
                     kills_fired: int, controller_kills: int,
                     text: str) -> dict:
        from sartsolver_tpu_torch.engine.journal import RequestJournal
        from sartsolver_tpu_torch.engine.state import StateStore

        ids = [r["id"] for r in self.requests]
        marks: Dict[str, int] = {}
        completed_union: Dict[str, dict] = {}
        pending_ids: List[str] = []
        evictions = 0
        for k in range(self.size):
            jpath = os.path.join(fleet_dir, "workers", f"w{k}",
                                 "journal.jsonl")
            completed, pending, _handed = \
                RequestJournal(jpath).replay_full()
            completed_union.update(completed)
            pending_ids += [req.id for req in pending]
            try:
                f = open(jpath)
            except OSError:
                continue
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("marker") == "completed":
                        marks[rec["id"]] = marks.get(rec["id"], 0) + 1
                    elif (rec.get("marker") == "session"
                          and rec.get("event") == "session-evict"
                          and rec.get("reason") == "test-forced"):
                        evictions += 1
        # 1a. fleet-wide completion: every request completed SOMEWHERE,
        # none left pending on any shard
        if set(completed_union) != set(ids) or pending_ids:
            raise CampaignError(
                f"fleet seed {schedule.seed}: completed="
                f"{sorted(completed_union)} pending={pending_ids}, "
                f"expected all of {ids}"
            )
        # 1b. exactly once fleet-wide: ONE completed marker per id
        # across every worker journal (a handoff that double-drove a
        # request shows up as two markers on two shards)
        doubled = {rid: n for rid, n in marks.items() if n != 1}
        if doubled:
            raise CampaignError(
                f"fleet seed {schedule.seed}: completed-marker counts "
                f"!= 1 across the fleet: {doubled} (a request was lost "
                "or double-solved)"
            )
        # 1c. done response per id in the SHARED responses dir, status
        # matching the undisturbed reference
        for rid in ids:
            resp = self._response(fleet_dir, rid)
            if not resp or resp.get("state") != "done":
                raise CampaignError(
                    f"fleet seed {schedule.seed}: no done response "
                    f"for {rid!r}"
                )
            status = (resp.get("outcome") or {}).get("status")
            want = self.reference[rid]["status"]
            if status != want:
                raise CampaignError(
                    f"fleet seed {schedule.seed}: {rid!r} ended "
                    f"{status!r}, reference says {want!r}"
                )
        # 2. byte-identical outputs (shared outputs dir) — this is also
        # the eviction-correctness gate: a rebuilt session that solved
        # differently, or a handoff re-drive that lost frames, breaks it
        for rid in ids:
            got = _solution_datasets(
                os.path.join(fleet_dir, "outputs", f"{rid}.h5")
            )
            ref = self.reference[rid]["datasets"]
            if sorted(got) != sorted(ref):
                raise CampaignError(
                    f"fleet seed {schedule.seed}: {rid!r} dataset set "
                    "differs"
                )
            for key in sorted(ref):
                if not np.array_equal(got[key], ref[key]):
                    raise CampaignError(
                        f"fleet seed {schedule.seed}: {rid!r} "
                        f"solution/{key} not byte-identical to the "
                        "undisturbed run"
                    )
        # 3. bounded unavailability: each worker SIGKILL costs at most
        # one controller-observed crash (node kills die WITH the
        # controller and are respawns, not crashes)
        restarts = text.count("fleet: worker-crash code=")
        if restarts > kills_fired:
            raise CampaignError(
                f"fleet seed {schedule.seed}: {restarts} worker "
                f"crash(es) for {kills_fired} scheduled kill(s) — "
                "workers are crashing on their own"
            )
        # 4. counter continuity fleet-wide: summed across every
        # worker's state checkpoint, the cumulative totals account
        # each request exactly once — across kills, handoffs and a
        # controller relaunch
        totals: Dict[str, float] = {}
        slo_total = 0.0
        for k in range(self.size):
            payload = StateStore(os.path.join(
                fleet_dir, "workers", f"w{k}", "state.jsonl")).load()
            for snap in (payload or {}).get("metrics") or []:
                if snap.get("kind") != "counter":
                    continue
                name = snap.get("name")
                if name == "engine_requests_total":
                    outcome = (snap.get("labels") or {}).get(
                        "outcome", "?")
                    totals[outcome] = totals.get(outcome, 0) \
                        + float(snap.get("value", 0))
                elif name in ("engine_slo_ok_total",
                              "engine_slo_breach_total"):
                    slo_total += float(snap.get("value", 0))
        if sum(totals.values()) != len(ids):
            raise CampaignError(
                f"fleet seed {schedule.seed}: fleet-summed "
                f"engine_requests_total={totals} does not account "
                f"{len(ids)} request(s) exactly once"
            )
        if self.slo_ms is not None and slo_total != len(ids):
            raise CampaignError(
                f"fleet seed {schedule.seed}: fleet-summed SLO "
                f"ok+breach={slo_total:g} for {len(ids)} request(s)"
            )
        # 5. the eviction leg is not vacuous: forced evictions fired
        # (byte-identity above proves they were harmless)
        if evictions == 0:
            raise CampaignError(
                f"fleet seed {schedule.seed}: SART_TEST_EVICT_EVERY="
                f"{schedule.evict_every} armed but no forced eviction "
                "fired — the eviction-under-load leg ran vacuously"
            )
        return {
            **schedule.describe(),
            "kills_fired": kills_fired,
            "controller_kills": controller_kills,
            "restarts": restarts,
            "evictions": evictions,
            "requests": len(ids),
            "requests_total": totals,
            "verdict": "ok",
        }



# ---------------------------------------------------------------------------
# the pod campaign (docs/RESILIENCE.md §11 of the JAX package)

# the fake pod's kill windows, announced on the victim's stderr: "stride"
# is the stride rendezvous (SART_TEST_POD_MARKERS, printed before the
# barrier's arrival lands: a kill there leaves the peers waiting) and
# "ckpt" the held-open window inside a solve checkpoint's append
# (SART_TEST_SOLVE_CKPT_DELAY: a kill there dies with the record not
# durable, so the pod falls back one checkpoint)
_POD_STRIDE_RE = re.compile(r"SART_POD_POINT stride serial=(\d+)")
_POD_CKPT_RE = re.compile(r"SART_SOLVE_CKPT_POINT pre-append serial=(\d+)")
_POD_RESUME_RE = re.compile(r"SART_POD_POINT resume serial=(\d+)")

POD_CKPT_STRIDE = 2

# the solver CLI's infrastructure exit, a survivor's at the barrier deadline
EXIT_INFRASTRUCTURE_POD = 3


class PodSchedule:
    """One seed's pod campaign: which host dies, in which window, at which
    occurrence of the window's marker (the JAX package's draw, seed for
    seed)."""

    WINDOWS = ("stride", "ckpt")

    def __init__(self, seed: int, *, size: int = 2):
        self.seed = int(seed)
        self.size = max(2, int(size))
        rng = np.random.default_rng([0x5A4A, self.seed])
        self.victim = int(rng.integers(0, self.size))
        self.window = self.WINDOWS[int(rng.integers(0, len(self.WINDOWS)))]
        # stride markers come every stride, ckpt markers every
        # POD_CKPT_STRIDE strides: both draws stay inside a short run
        if self.window == "stride":
            self.occurrence = int(rng.integers(2, 5))
        else:
            self.occurrence = int(rng.integers(1, 3))

    def describe(self) -> dict:
        return {"seed": self.seed, "victim": f"h{self.victim}",
                "window": f"{self.window}#{self.occurrence}"}


class PodCampaign:
    """The reference pass (N undisturbed fake-pod workers in lockstep, whose
    outputs must already agree), then per seed: SIGKILL one host inside its
    seeded window, require every survivor to exit 3 at the barrier deadline
    naming the dead host (stderr and crash bundle), ``--resume`` the whole
    pod on a fresh barrier directory and judge byte identity, one agreed
    resume serial, no stride repeated, a ``ckpt`` kill resuming below the
    killed serial, and the checkpoint counters.

    The fake pod is N one-process solver CLIs (``python -m
    sartsolver_tpu_torch.cli``) over the same frames: ``SART_POD_PROCESS=
    k/N``, file barriers under a fresh ``SART_POD_BARRIER_DIR`` each pass
    (a previous incarnation's arrival files would meet a rendezvous at
    once), and one ``SART_SOLVE_CKPT_FILE`` base so the pod-wide
    intersection sees every host's records. The reference workers keep
    their stdout and metrics artifact beside their outputs (the report's
    ``reference_workers``): an undisturbed pod's frame times and launches."""

    def __init__(self, *, root: str, solve_args: List[str], size: int,
                 timeout: float, verbose=print):
        self.root = root
        self.solve_args = list(solve_args)
        self.size = max(2, int(size))
        self.timeout = float(timeout)
        self.say = verbose
        self.reference: Optional[Dict[str, "np.ndarray"]] = None
        self.reference_s: Optional[float] = None
        self.reference_workers: List[dict] = []

    def _pod_env(self, index: int, barrier_dir: str,
                 extra: Optional[dict] = None) -> dict:
        env = dict(os.environ)
        for key in ("SART_FAULT", "SART_TEST_POD_MARKERS",
                    "SART_TEST_SOLVE_CKPT_DELAY", "SART_SOLVE_CKPT_FILE"):
            env.pop(key, None)
        env["PYTHONUNBUFFERED"] = "1"  # the kill plan watches live lines
        env["SART_POD_PROCESS"] = f"{index}/{self.size}"
        env["SART_POD_BARRIER_DIR"] = barrier_dir
        # a short deadline: the barrier (not the hang watchdog) must see
        # the dead peer, and a campaign should not idle long
        env.setdefault("SART_POD_BARRIER_TIMEOUT", "30")
        env.update(extra or {})
        return env

    def _solve_cmd(self, outfile: str, *extra: str) -> List[str]:
        return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", outfile,
                *self.solve_args, *extra]

    def _outputs(self, pass_dir: str) -> List[str]:
        return [os.path.join(pass_dir, f"out_h{k}.h5") for k in range(self.size)]

    @staticmethod
    def _barrier_dir(pass_dir: str, name: str) -> str:
        path = os.path.join(pass_dir, name)
        os.makedirs(path, exist_ok=True)
        if os.listdir(path):
            raise CampaignError(f"pod barrier dir {path} is not empty — stale arrival "
                                "files would satisfy rendezvous instantly")
        return path

    def _start(self, outs: List[str], bdir: str, extra_env: Optional[dict],
               *flags: str, keep: bool = False) -> List[subprocess.Popen]:
        """One worker per output. With ``keep`` each worker's stdout goes
        to ``<output>.stdout`` and its metrics artifact to
        ``<output>.metrics.jsonl``."""
        procs = []
        for k in range(self.size):
            extra = (*flags, "--metrics_out", f"{outs[k]}.metrics.jsonl") if keep else flags
            with open(f"{outs[k]}.stdout", "w") if keep else contextlib.nullcontext(
                    subprocess.DEVNULL) as stdout:
                procs.append(subprocess.Popen(self._solve_cmd(outs[k], *extra),
                                              env=self._pod_env(k, bdir, extra_env),
                                              stdout=stdout, stderr=subprocess.PIPE,
                                              text=True))
        return procs

    def run_reference(self) -> None:
        ref_dir = os.path.join(self.root, "podref")
        os.makedirs(ref_dir, exist_ok=True)
        bdir = self._barrier_dir(ref_dir, "barriers")
        outs = self._outputs(ref_dir)
        self.say(f"chaos: pod reference pass ({self.size} hosts) in {ref_dir}")
        t0 = time.monotonic()
        procs = self._start(outs, bdir, None, keep=True)
        errs, _ends = self._drain(procs)
        self.reference_s = time.monotonic() - t0
        self.reference_workers = [
            {"output": out, "stdout": f"{out}.stdout", "metrics": f"{out}.metrics.jsonl"}
            for out in outs]
        for k, proc in enumerate(procs):
            if proc.returncode != 0:
                raise CampaignError(f"pod reference host h{k} exited {proc.returncode}:"
                                    f"\n{errs[k][-4000:]}")
        datasets = [_solution_datasets(out) for out in outs]
        # the lockstep's sanity: every host solved the same stream
        for k in range(1, self.size):
            for key in sorted(datasets[0]):
                if not np.array_equal(datasets[0][key], datasets[k][key]):
                    raise CampaignError(
                        f"pod reference hosts h0/h{k} disagree on solution/{key} — "
                        "lockstep is broken before any fault was injected")
        self.reference = datasets[0]

    def _drain(self, procs: List[subprocess.Popen]) -> Tuple[List[str], List[float]]:
        """Every worker's stderr and the monotonic time it ended, under one
        wall-clock guard (``timeout``: every worker killed past it)."""
        errs: List[str] = [""] * len(procs)
        ends: List[float] = [0.0] * len(procs)

        def drain(k: int, proc: subprocess.Popen) -> None:
            errs[k] = proc.communicate()[1] or ""
            ends[k] = time.monotonic()

        guards = [threading.Timer(self.timeout, p.kill) for p in procs]
        readers = [threading.Thread(target=drain, args=(k, p), daemon=True)
                   for k, p in enumerate(procs)]
        for t in guards + readers:
            t.start()
        try:
            for t in readers:
                t.join(self.timeout + 60)
        finally:
            for g in guards:
                g.cancel()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        return errs, ends

    def run_pod_seed(self, schedule: PodSchedule) -> dict:
        pass_dir = os.path.join(self.root, f"pod{schedule.seed}")
        os.makedirs(pass_dir, exist_ok=True)
        outs = self._outputs(pass_dir)
        chaos_env = {"SART_TEST_POD_MARKERS": "1", "SART_TEST_SOLVE_CKPT_DELAY": "0.4",
                     "SART_SOLVE_CKPT_FILE": os.path.join(pass_dir, "pod.solveckpt")}
        ckpt = ("--solve_ckpt_stride", str(POD_CKPT_STRIDE))
        self.say(f"chaos: pod seed {schedule.seed} {schedule.describe()}")

        # the kill pass: one host dies inside the seeded window
        t0 = time.monotonic()
        procs = self._start(outs, self._barrier_dir(pass_dir, "barriers_kill"), chaos_env,
                            *ckpt)
        victim = procs[schedule.victim]
        want_re = _POD_STRIDE_RE if schedule.window == "stride" else _POD_CKPT_RE
        victim_lines: List[str] = []
        killed: List[Tuple[int, float]] = []

        def watch_victim() -> None:
            seen = 0
            for line in victim.stderr:
                victim_lines.append(line)
                m = want_re.search(line)
                if not m:
                    continue
                seen += 1
                if seen < schedule.occurrence:
                    continue
                victim.kill()
                killed.append((int(m.group(1)), time.monotonic()))
                break
            try:  # drained, so the dying child never blocks on the pipe
                victim.stderr.read()
            except (OSError, ValueError):
                pass

        watcher = threading.Thread(target=watch_victim, daemon=True)
        watcher.start()
        survivors = [p for k, p in enumerate(procs) if k != schedule.victim]
        errs, ends = self._drain(survivors)
        watcher.join(timeout=60)
        victim.wait(timeout=60)
        kill_pass_s = time.monotonic() - t0
        if victim.returncode != -signal.SIGKILL or not killed:
            raise CampaignError(
                f"pod seed {schedule.seed}: victim h{schedule.victim} exited "
                f"{victim.returncode} before the kill landed in window "
                f"{schedule.window}#{schedule.occurrence} — a clean exit 0 here usually "
                "means the workload is too short to reach this seed's window; give the "
                f"campaign more frames:\n{''.join(victim_lines)[-4000:]}")
        killed_serial, killed_at = killed[0]
        self.say(f"chaos: pod seed {schedule.seed} SIGKILL h{schedule.victim} in window "
                 f"{schedule.window}#{schedule.occurrence} (serial {killed_serial})")
        # every survivor exits 3 at the barrier deadline, its stderr naming
        # the barrier and the dead host, its crash bundle's reason the host
        exit_after_kill = []
        for k, (proc, err) in enumerate(zip(survivors, errs)):
            host = k if k < schedule.victim else k + 1
            exit_after_kill.append(ends[k] - killed_at)
            if proc.returncode != EXIT_INFRASTRUCTURE_POD:
                raise CampaignError(
                    f"pod seed {schedule.seed}: survivor h{host} exited {proc.returncode}, "
                    f"expected {EXIT_INFRASTRUCTURE_POD} (the barrier-deadline abort):"
                    f"\n{err[-4000:]}")
            if "pod barrier" not in err or f"h{schedule.victim}" not in err:
                raise CampaignError(
                    f"pod seed {schedule.seed}: survivor h{host} abort does not name the "
                    f"pod barrier and the dead host h{schedule.victim}:\n{err[-4000:]}")
            bundle_path = f"{outs[host]}.crash.json"
            try:
                with open(bundle_path) as f:
                    bundle = json.load(f)
            except (OSError, ValueError) as exc:
                raise CampaignError(f"pod seed {schedule.seed}: survivor h{host} left no "
                                    f"readable crash bundle at {bundle_path}: {exc}")
            if f"h{schedule.victim}" not in str(bundle.get("reason")):
                raise CampaignError(
                    f"pod seed {schedule.seed}: crash bundle reason "
                    f"{bundle.get('reason')!r} does not name the dead host "
                    f"h{schedule.victim}")
            if bundle.get("status", {}).get("host") != f"{host}/{self.size}":
                raise CampaignError(
                    f"pod seed {schedule.seed}: crash bundle host tag "
                    f"{bundle.get('status', {}).get('host')!r} is not {host}/{self.size}")

        # the resume pass: the whole pod relaunches with --resume
        arts = [os.path.join(pass_dir, f"resume_h{k}.jsonl") for k in range(self.size)]
        bdir = self._barrier_dir(pass_dir, "barriers_resume")
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            self._solve_cmd(outs[k], *ckpt, "--resume", "--metrics_out", arts[k]),
            env=self._pod_env(k, bdir, chaos_env), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True) for k in range(self.size)]
        errs, _ends = self._drain(procs)
        resume_pass_s = time.monotonic() - t0
        for k, proc in enumerate(procs):
            if proc.returncode != 0:
                raise CampaignError(f"pod seed {schedule.seed}: resume host h{k} exited "
                                    f"{proc.returncode}:\n{errs[k][-4000:]}")
        verdict = self._judge_pod(schedule, outs, arts, errs, killed_serial)
        verdict.update(killed_serial=killed_serial, kill_pass_s=kill_pass_s,
                       resume_pass_s=resume_pass_s,
                       survivor_exit_after_kill_s=exit_after_kill,
                       barrier_timeout_s=float(self._pod_env(0, pass_dir)[
                           "SART_POD_BARRIER_TIMEOUT"]))
        return verdict

    def _judge_pod(self, schedule: PodSchedule, outs: List[str], arts: List[str],
                   errs: List[str], killed_serial: int) -> dict:
        # 1. every host's resumed file equals the undisturbed reference
        for k, out in enumerate(outs):
            got = _solution_datasets(out)
            if sorted(got) != sorted(self.reference):
                raise CampaignError(f"pod seed {schedule.seed}: h{k} dataset set differs")
            for key in sorted(self.reference):
                if not np.array_equal(got[key], self.reference[key]):
                    raise CampaignError(f"pod seed {schedule.seed}: h{k} solution/{key} "
                                        "not byte-identical to the undisturbed run")
        # 2. the pod resumed from one checkpoint serial; after a kill inside
        # an append, one older than the torn record (the one-stride fallback)
        resumed: List[int] = []
        for k, err in enumerate(errs):
            m = _POD_RESUME_RE.search(err)
            if not m:
                raise CampaignError(f"pod seed {schedule.seed}: h{k} did not resume from "
                                    f"a solve checkpoint:\n{err[-4000:]}")
            resumed.append(int(m.group(1)))
        if len(set(resumed)) != 1:
            raise CampaignError(f"pod seed {schedule.seed}: hosts resumed from divergent "
                                f"serials {resumed}")
        if schedule.window == "ckpt" and resumed[0] >= killed_serial:
            raise CampaignError(
                f"pod seed {schedule.seed}: killed inside the append of serial "
                f"{killed_serial}, yet the pod resumed from serial {resumed[0]}")
        # 3. no stride re-run: every stride after the resume is newer than
        # the restored serial, strictly increasing
        post_serials: List[List[int]] = []
        for k, err in enumerate(errs):
            serials = [int(m.group(1)) for m in _POD_STRIDE_RE.finditer(err)]
            post_serials.append(serials)
            if not serials:
                raise CampaignError(f"pod seed {schedule.seed}: h{k} resumed without "
                                    "completing a single stride")
            if serials[0] <= resumed[0] or serials != sorted(set(serials)):
                raise CampaignError(
                    f"pod seed {schedule.seed}: h{k} stride serials {serials} repeat or "
                    f"precede the restored checkpoint {resumed[0]} — a completed stride "
                    "was re-run")
        # 4. the counters: each host's artifact validates and counts exactly
        # one checkpoint resume, and a checkpoint where the resumed leg
        # completed a checkpoint-aligned stride
        from sartsolver_tpu_torch.obs.cli import metrics_main

        for k, art in enumerate(arts):
            if metrics_main(["--check", art]) != 0:
                raise CampaignError(f"pod seed {schedule.seed}: h{k} metrics artifact "
                                    f"{art} fails sartsolve metrics --check")
            counters: Dict[str, float] = {}
            with open(art) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("type") == "metric" and rec.get("kind") == "counter":
                        counters[rec["name"]] = float(rec.get("value", 0))
            if counters.get("solve_ckpt_resumed_total") != 1:
                raise CampaignError(
                    f"pod seed {schedule.seed}: h{k} solve_ckpt_resumed_total="
                    f"{counters.get('solve_ckpt_resumed_total')}, expected exactly 1")
            aligned = [s for s in post_serials[k] if s % POD_CKPT_STRIDE == 0]
            if aligned and counters.get("solve_ckpt_written_total", 0) < 1:
                raise CampaignError(
                    f"pod seed {schedule.seed}: h{k} completed checkpoint-aligned "
                    f"stride(s) {aligned} but wrote no solve checkpoints")
        return {**schedule.describe(), "resumed_serial": resumed[0], "hosts": self.size,
                "verdict": "ok"}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve chaos",
        description="Chaos campaign against a real supervised serve: "
                    "seeded fault schedules + SIGKILLs inside commit "
                    "windows, judged on exactly-once / byte-identity / "
                    "restart-budget / state-continuity invariants "
                    "(docs/SERVING.md §9). Everything after -- is the "
                    "serve worker's own flag set.",
    )
    p.add_argument("--engine_dir", required=True,
                   help="Campaign root: reference/ and seed<K>/ engine "
                        "dirs are created under it.")
    p.add_argument("--seeds", default="0,1",
                   help="Comma-separated campaign seeds (each runs one "
                        "supervised pass). Default 0,1.")
    p.add_argument("--requests", type=int, default=4,
                   help="Workload size per pass. Default 4.")
    p.add_argument("--max_kills", type=int, default=2,
                   help="Max SIGKILLs a seed's schedule may draw. "
                        "Default 2.")
    p.add_argument("--fleet", type=int, default=0, metavar="M",
                   help="Run fleet campaigns instead: each seed passes "
                        "through `sartsolve fleet` with M workers under "
                        "a seeded worker SIGKILL inside a commit "
                        "window, an optional controller kill mid-"
                        "handoff, and forced session evictions — "
                        "judged fleet-wide (docs/SERVING.md §10). "
                        "0 = single supervised engine (default).")
    p.add_argument("--pod", type=int, default=0, metavar="N",
                   help="Run pod campaigns instead: each seed runs N "
                        "lockstep fake-pod solver workers with in-solve "
                        "checkpointing, SIGKILLs one host inside a "
                        "seeded stride-barrier or mid-checkpoint "
                        "window, asserts the survivors abort via the "
                        "coordinated barrier deadline naming the dead "
                        "host, then --resume's the pod and judges "
                        "byte-identity + stride-progress monotonicity "
                        "(docs/RESILIENCE.md §11). Everything after -- "
                        "is the solver's own flag set (needs "
                        "--batch_frames > 1). 0 = serve campaign "
                        "(default).")
    p.add_argument("--slo_ms", type=float, default=None,
                   help="Arm the engine SLO pair and assert its burn "
                        "accounting is continuous across restarts.")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="Per-pass wall-clock guard in seconds. "
                        "Default 300.")
    p.add_argument("--report", default=None, metavar="FILE",
                   help="Write the campaign report JSON here too.")
    p.add_argument("serve_args", nargs=argparse.REMAINDER,
                   help="-- followed by serve solver flags + input "
                        "files.")
    return p


def chaos_main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as err:
        raise SystemExit(1 if err.code else 0) from None
    serve_args = list(args.serve_args)
    if serve_args[:1] == ["--"]:
        serve_args = serve_args[1:]
    if not serve_args:
        print("sartsolve chaos: no serve flags/input files after -- .",
              file=sys.stderr)
        return 1
    try:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    except ValueError:
        print(f"sartsolve chaos: malformed --seeds {args.seeds!r}.",
              file=sys.stderr)
        return 1
    if not seeds or args.requests < 1 or args.max_kills < 1:
        print("sartsolve chaos: need >=1 seed, >=1 request, >=1 kill.",
              file=sys.stderr)
        return 1
    if args.fleet < 0 or args.fleet == 1:
        print("sartsolve chaos: --fleet needs >= 2 workers (or 0 for "
              "the single-engine campaign).", file=sys.stderr)
        return 1
    if args.pod < 0 or args.pod == 1:
        print("sartsolve chaos: --pod needs >= 2 hosts (or 0 for the "
              "serve campaigns).", file=sys.stderr)
        return 1
    if args.pod and args.fleet:
        print("sartsolve chaos: --pod and --fleet are separate "
              "campaigns; pick one.", file=sys.stderr)
        return 1
    if args.pod:
        campaign = PodCampaign(root=args.engine_dir, solve_args=serve_args,
                               size=args.pod, timeout=args.timeout)
        report = {"seeds": seeds, "pod": args.pod, "passes": []}
        try:
            campaign.run_reference()
            report["reference_s"] = campaign.reference_s
            report["reference_workers"] = campaign.reference_workers
            for seed in seeds:
                verdict = campaign.run_pod_seed(PodSchedule(seed, size=args.pod))
                report["passes"].append(verdict)
                print(f"chaos: pod seed {seed} OK — killed {verdict['victim']} in "
                      f"{verdict['window']}, survivors exited {EXIT_INFRASTRUCTURE_POD} at "
                      "the barrier deadline, pod resumed from serial "
                      f"{verdict['resumed_serial']} without repeating a stride, outputs "
                      "byte-identical")
        except CampaignError as err:
            report["verdict"] = "FAILED"
            report["error"] = str(err)
            print(f"chaos: INVARIANT VIOLATED — {err}", file=sys.stderr)
            if args.report:
                with open(args.report, "w") as f:
                    json.dump(report, f, indent=2)
            return 2
        report["verdict"] = "ok"
        print(json.dumps({"chaos": report}))
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
        return 0
    if args.fleet:
        # >= 2*size requests with DISTINCT tenants: affinity spreads
        # them across shards, and pigeonhole guarantees some worker
        # incarnation leases twice so the forced-eviction leg fires
        n_requests = max(args.requests, 2 * args.fleet + 2)
        requests = [
            {"id": f"chaos-{i}", "tenant": f"t{i}"}
            for i in range(n_requests)
        ]
        campaign = FleetCampaign(
            size=args.fleet, root=args.engine_dir,
            serve_args=serve_args, requests=requests,
            slo_ms=args.slo_ms, timeout=args.timeout,
        )
    else:
        requests = [
            {"id": f"chaos-{i}", "tenant": f"t{i % 2}"}
            for i in range(args.requests)
        ]
        campaign = ChaosCampaign(
            root=args.engine_dir, serve_args=serve_args,
            requests=requests, slo_ms=args.slo_ms, timeout=args.timeout,
        )
    report = {"seeds": seeds, "requests": len(requests),
              "fleet": args.fleet, "passes": []}
    try:
        campaign.run_reference()
        for seed in seeds:
            if args.fleet:
                verdict = campaign.run_fleet_seed(
                    FleetSchedule(seed, size=args.fleet)
                )
                report["passes"].append(verdict)
                print(f"chaos: fleet seed {seed} OK — "
                      f"{verdict['kills_fired']} worker kill(s), "
                      f"{verdict['controller_kills']} controller "
                      f"kill(s), {verdict['evictions']} forced "
                      f"eviction(s), {verdict['requests']} request(s) "
                      "exactly once fleet-wide, outputs byte-identical")
                continue
            schedule = FaultSchedule(seed, max_kills=args.max_kills)
            verdict = campaign.run_seed(schedule)
            report["passes"].append(verdict)
            print(f"chaos: seed {seed} OK — "
                  f"{verdict['kills_fired']} kill(s), "
                  f"{verdict['restarts']} restart(s), "
                  f"{verdict['requests']} request(s) exactly once, "
                  "outputs byte-identical")
    except CampaignError as err:
        report["verdict"] = "FAILED"
        report["error"] = str(err)
        print(f"chaos: INVARIANT VIOLATED — {err}", file=sys.stderr)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2)
        return 2
    except subprocess.TimeoutExpired:
        print(f"chaos: campaign pass exceeded --timeout "
              f"{args.timeout:g}s.", file=sys.stderr)
        return 2
    report["verdict"] = "ok"
    print(json.dumps({"chaos": report}))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    return 0


__all__ = ["ChaosCampaign", "FleetCampaign", "PodCampaign", "CampaignError",
           "FaultSchedule", "FleetSchedule", "PodSchedule", "chaos_main", "line_window",
           "FAULT_POOL", "KILL_WINDOWS"]
