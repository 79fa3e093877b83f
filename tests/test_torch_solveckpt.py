"""In-solve checkpoints (``--solve_ckpt_stride``) of the port.

Ports the one-host legs of ``tests/test_pod.py`` (its units and
``:466-560``): the bit-exact state encoding, the store (compaction, the
torn-tail and CRC fallbacks), the scheduler's snapshot and restore, the
solver's lane export and its signature, and the CLI drills on the fixture
world through the continuous-batching scheduler (``--no_guess
--batch_frames 4``, the deterministic ``--use_cpu -m 40 -c 1e-12``
profile): stride 0 writes no file and changes no byte, a SIGKILL inside the
held-open append of serial 2 resumes from serial 1 to the bytes of an
uninterrupted run, a flipped CRC falls back a record, another configuration
is refused, a permanent ``solve.checkpoint`` failure leaves the run at exit
0 with a warning. The JAX package's store reads the port's records.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.resilience import podckpt as jpodckpt

from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.obs import metrics
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.resilience import faults, podckpt
from sartsolver_tpu_torch.sched import ContinuousBatcher
from sartsolver_tpu_torch.sched.scheduler import sched_held_ftimes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 10


# ---------------------------------------------------------------------------
# the state encoding and the store
# ---------------------------------------------------------------------------

def test_encode_decode_roundtrip_bit_exact():
    rng = np.random.default_rng(7)
    state = {
        "f": rng.standard_normal((3, 5)),
        "w": rng.standard_normal((4,)).astype(np.float32),
        "iters": np.arange(6, dtype=np.int32).reshape(2, 3),
        "mask": np.array([True, False, True]),
        "scalar": np.float64(0.1 + 0.2),
        "count": np.int64(41),
        "nested": {"lanes": [np.arange(3), {"tk": 1.25}], "tag": "s"},
        "empty": np.zeros((0, 2)),
        "plain": [1, "two", None, 3.5],
    }
    back = podckpt.decode_state(json.loads(json.dumps(podckpt.encode_state(state))))
    for key in ("f", "w", "iters", "mask", "empty"):
        assert back[key].dtype == state[key].dtype
        assert np.array_equal(back[key], state[key])
    assert back["scalar"] == state["scalar"]
    assert back["count"] == 41
    assert np.array_equal(back["nested"]["lanes"][0], np.arange(3))
    assert back["nested"]["lanes"][1]["tk"] == 1.25
    assert back["plain"] == [1, "two", None, 3.5]
    # the JAX package's encoding of the same tree is the same JSON
    assert json.dumps(jpodckpt.encode_state(state), sort_keys=True) \
        == json.dumps(podckpt.encode_state(state), sort_keys=True)
    back["f"][0, 0] = 99.0  # writable: a restore mutates lane bookkeeping


def _state(serial):
    return {"serial_echo": serial, "f": np.full((2, 2), float(serial))}


def test_store_save_load_and_compaction(tmp_path):
    store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
    before = metrics.get_registry().counter("solve_ckpt_written_total").value
    for serial in range(1, 7):
        assert store.save(serial, _state(serial))
    assert metrics.get_registry().counter("solve_ckpt_written_total").value == before + 6
    assert store.serials() == [4, 5, 6]
    with open(store.path) as f:
        assert len([ln for ln in f if ln.strip()]) == podckpt.KEEP_RECORDS
    snap = store.load(5)
    assert snap["serial_echo"] == 5 and np.array_equal(snap["f"], np.full((2, 2), 5.0))
    assert store.load(1) is None
    assert podckpt.newest_consistent_serial(store.path) == 6
    assert podckpt.newest_consistent_serial(str(tmp_path / "none")) is None


def test_jax_store_reads_the_port_records(tmp_path):
    """The envelope is the JAX package's: its store lists the port's
    serials and decodes their states."""
    store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
    for serial in (3, 4):
        store.save(serial, _state(serial))
    theirs = jpodckpt.SolveCheckpointStore(store.path)
    assert theirs.serials() == [3, 4]
    assert np.array_equal(theirs.load(4)["f"], store.load(4)["f"])
    rec = json.loads(open(store.path).readlines()[-1])
    assert set(rec) == {"v", "serial", "unix", "crc", "state"} and rec["v"] == 1


def test_store_torn_tail_falls_back(tmp_path):
    store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
    store.save(1, _state(1))
    store.save(2, _state(2))
    with open(store.path, "a") as f:
        f.write('{"v": 1, "serial": 3, "crc": 123, "state": {"tr')
    assert store.serials() == [1, 2]
    assert store.load(3) is None


@pytest.mark.parametrize("step", [1, 7, 23])
def test_store_torn_tail_property(tmp_path, step):
    """A cut at any byte inside the last record falls back to the previous
    serial: no cut yields a wrong or an extra record."""
    store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
    store.save(1, _state(1))
    store.save(2, _state(2))
    with open(store.path, "rb") as f:
        blob = f.read()
    second = blob.index(b"\n") + 1
    for cut in range(second, len(blob), step):
        with open(store.path, "wb") as f:
            f.write(blob[:cut])
        got = store.serials()
        if cut == len(blob) - 1:  # only the newline missing: still valid
            assert got in ([1], [1, 2])
        else:
            assert got == [1], (cut, got)


def test_store_crc_rejects_tampered_state(tmp_path):
    store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
    store.save(1, _state(1))
    store.save(2, _state(2))
    lines = open(store.path).readlines()
    lines[-1] = lines[-1].replace('"state": {', '"state": {"__rot__": 1, ', 1)
    with open(store.path, "w") as f:
        f.writelines(lines)
    assert store.serials() == [1]


def test_permanent_failure_warns_and_returns(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SART_FAULT", "solve.checkpoint:io:1:100")
    monkeypatch.setenv("SART_RETRY_BASE_DELAY", "0.001")
    faults.reset()
    try:
        store = podckpt.SolveCheckpointStore(str(tmp_path / "ck"))
        before = metrics.get_registry().counter("solve_ckpt_written_total").value
        assert store.save(1, _state(1)) is False
        assert "Warning: solve checkpoint serial 1 not written" in capsys.readouterr().err
        assert metrics.get_registry().counter("solve_ckpt_written_total").value == before
        assert store.serials() == []
    finally:
        monkeypatch.delenv("SART_FAULT")
        faults.reset()


def test_append_window_marker(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SART_TEST_SOLVE_CKPT_DELAY", "0.01")
    podckpt.SolveCheckpointStore(str(tmp_path / "ck")).save(7, _state(7))
    assert "SART_SOLVE_CKPT_POINT pre-append serial=7" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the scheduler and the solver
# ---------------------------------------------------------------------------

def _case(n=6, seed=1):
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 1.0, (16, 64)).astype(np.float32)
    f_true = rng.uniform(0.5, 2.0, 64)
    G = np.stack([H.astype(np.float64) @ (f_true * (1 + 0.1 * k)) for k in range(n)])
    return H, G


def _opts(**kw):
    return SolverOptions.cpu_parity(max_iterations=30, conv_tolerance=1e-9,
                                    schedule_stride=4, **kw)


def _drive(solver, G, **kw):
    out = []
    stats = ContinuousBatcher(
        solver, lanes=3,
        on_result=lambda t, c, s, i, cv, fetch, ms: out.append((t, s, i, fetch().copy())),
        **kw).run([(g, 0.1 * k, [0.1 * k]) for k, g in enumerate(G)])
    return out, stats


@pytest.mark.parametrize("variant", [{}, dict(momentum="nesterov", divergence_recovery=2),
                                     dict(logarithmic=True, os_subsets=4)])
def test_restore_from_any_snapshot_is_byte_identical(variant):
    """Every stride's snapshot, restored into a fresh scheduler with the rows
    it had emitted as written, finishes the run with the bytes of the
    uninterrupted run; serials carry on from the snapshot's."""
    H, G = _case()
    opts = _opts(**variant)
    snaps = []
    with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
        want, stats = _drive(solver, G, ckpt_stride=1,
                             ckpt_sink=lambda serial, snap: snaps.append((serial, snap)))
        assert [s for s, _ in snaps] == list(range(1, stats.strides + 1))
        for serial, snap in snaps[:-1]:
            # the file of the killed run holds the rows emitted so far
            snap = podckpt.decode_state(json.loads(json.dumps(podckpt.encode_state(snap))))
            W = snap["next_emit"]
            held = sched_held_ftimes(snap, W)
            more = []
            batcher = ContinuousBatcher(
                solver, lanes=3, restore=snap, restore_emitted=W, ckpt_stride=1,
                ckpt_sink=lambda s, _snap: more.append(s),
                on_result=lambda t, c, s, i, cv, fetch, ms: got.append(
                    (t, s, i, fetch().copy())))
            got = []
            batcher.run([(g, 0.1 * k, [0.1 * k]) for k, g in enumerate(G)
                         if k >= W and 0.1 * k not in held])
            assert [r[0] for r in got] == [r[0] for r in want[W:]]
            for a, b in zip(got, want[W:]):
                assert a[1:3] == b[1:3] and a[3].tobytes() == b[3].tobytes()
            assert not more or more[0] == serial + 1


def test_lane_export_is_bit_exact_and_signed():
    H, G = _case()
    opts = _opts(momentum="nesterov", divergence_recovery=1)
    with DistributedSARTSolver(H, opts=opts, device="cpu") as solver:
        lanes = solver.sched_lanes(3)
        solver.sched_step(lanes, [(0, G[0]), (2, G[1])])
        exp = solver.export_sched_lanes(lanes)
        back = solver.restore_sched_lanes(
            podckpt.decode_state(json.loads(json.dumps(podckpt.encode_state(exp)))))
        for name in type(lanes.state)._fields:
            a, b = getattr(lanes.state, name), getattr(back.state, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), name
        assert back.norms.tobytes() == lanes.norms.tobytes()
        killed = solver.restore_sched_lanes(exp, kill_lanes=[2])
        assert bool(killed.state.done[2]) and float(killed.state.f[2, 0]) == 1.0
        assert killed.norms[2] == 1.0 and killed.norms[0] == lanes.norms[0]
        assert "torch" in exp["sig"]
    with DistributedSARTSolver(H, opts=_opts(), device="cpu") as other:
        with pytest.raises(ValueError, match="does not match this solver configuration"):
            other.restore_sched_lanes(exp)


def test_restore_refuses_another_lane_count_or_a_snapshot_ahead():
    H, G = _case()
    snaps = []
    with DistributedSARTSolver(H, opts=_opts(), device="cpu") as solver:
        _drive(solver, G, ckpt_stride=2, ckpt_sink=lambda s, snap: snaps.append(snap))
        snap = snaps[-1]
        with pytest.raises(ValueError, match="lanes"):
            ContinuousBatcher(solver, lanes=2, on_result=print, restore=snap,
                              restore_emitted=snap["next_emit"]).run([])
        if snap["next_emit"]:
            with pytest.raises(ValueError, match="ahead of the output file"):
                ContinuousBatcher(solver, lanes=3, on_result=print, restore=snap,
                                  restore_emitted=snap["next_emit"] - 1).run([])


# ---------------------------------------------------------------------------
# the CLI drills (subprocesses)
# ---------------------------------------------------------------------------

def _env(extra=None):
    env = dict(os.environ)
    for key in ("SART_FAULT", "SART_TEST_SOLVE_CKPT_DELAY", "SART_SOLVE_CKPT_FILE",
                "SART_TEST_POD_MARKERS"):
        env.pop(key, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONUNBUFFERED"] = "1"
    env["SART_RETRY_BASE_DELAY"] = "0.001"
    env.update(extra or {})
    return env


def _cmd(paths, out, *extra):
    return [sys.executable, "-m", "sartsolver_tpu_torch.cli", "-o", out,
            paths["rtm_a1"], paths["rtm_a2"], paths["rtm_b"], paths["img_a"], paths["img_b"],
            "--use_cpu", "-m", "40", "-c", "1e-12", "-l", paths["laplacian"], "-b", "0.001",
            "--max_cached_solutions", "1", "--no_guess", "--batch_frames", "4", *extra]


def _bytes(path):
    with h5py.File(path, "r") as f:
        data = {k: f["solution"][k][:].tobytes() for k in f["solution"]}
        data["completed"] = int(f["solution"].attrs["completed"])
    return data


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    td = tmp_path_factory.mktemp("ckpt_world")
    paths, *_ = fx.write_world(td, with_laplacian=True, n_frames=N_FRAMES)
    ref = str(td / "reference.h5")
    proc = subprocess.run(_cmd(paths, ref), env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = _bytes(ref)
    assert want["completed"] == N_FRAMES
    return paths, want, td


@pytest.mark.parametrize("stride", [0, 2])
def test_checkpoint_stride_changes_no_byte(ckpt_world, stride):
    """Stride 0 writes no file; a stride writes its file and the solution
    file is the same bytes as the run without the flag."""
    paths, want, td = ckpt_world
    out = str(td / f"stride{stride}.h5")
    sidecar = str(td / f"custom{stride}.solveckpt")
    proc = subprocess.run(_cmd(paths, out, "--solve_ckpt_stride", str(stride)),
                          env=_env({"SART_SOLVE_CKPT_FILE": sidecar}),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert _bytes(out) == want
    assert not os.path.exists(out + ".solveckpt")
    if stride == 0:
        assert not os.path.exists(sidecar)
    else:
        serials = podckpt.SolveCheckpointStore(sidecar).serials()
        assert serials and len(serials) <= podckpt.KEEP_RECORDS and serials[-1] % 2 == 0


@pytest.mark.parametrize("argv", [
    ["--solve_ckpt_stride", "-1"],
    ["--solve_ckpt_stride", "2", "--no_continuous_batching"],
])
def test_solve_ckpt_stride_validation_matches_jax(ckpt_world, tmp_path, argv):
    from sartsolver_tpu.cli import main as jax_main
    from sartsolver_tpu_torch.cli import main as torch_main

    paths, _, _ = ckpt_world
    base = [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]
    for main in (torch_main, jax_main):
        with pytest.raises(SystemExit) as info:
            main(["-o", str(tmp_path / "x.h5"), *base, "--no_guess", "--batch_frames", "4",
                  *argv])
        assert info.value.code == 1
    proc = subprocess.run(_cmd(paths, str(tmp_path / "y.h5"), *argv), env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "solve_ckpt_stride" in proc.stderr
    # a lone frame per dispatch has no lanes to snapshot
    proc = subprocess.run(_cmd(paths, str(tmp_path / "z.h5"), "--solve_ckpt_stride", "1",
                               "--batch_frames", "1"), env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "needs --batch_frames > 1" in proc.stderr


def _kill_in_window(cmd, env, serial):
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    guard = threading.Timer(240, proc.kill)
    guard.start()
    try:
        for line in proc.stderr:
            if line.strip() == f"SART_SOLVE_CKPT_POINT pre-append serial={serial}":
                proc.kill()
                break
        else:
            raise AssertionError(f"run ended before the serial-{serial} append")
        proc.stderr.read()
    finally:
        guard.cancel()
        proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL


def test_kill_in_ckpt_window_then_resume(ckpt_world):
    """SIGKILL inside the held-open append of serial 2: the record is not
    durable, ``--resume`` restores serial 1 and completes with the bytes of
    the uninterrupted run; the artifact counts one resume."""
    paths, want, td = ckpt_world
    out = str(td / "killed.h5")
    env = _env({"SART_TEST_SOLVE_CKPT_DELAY": "0.6", "SART_TEST_POD_MARKERS": "1"})
    _kill_in_window(_cmd(paths, out, "--solve_ckpt_stride", "1"), env, 2)
    assert podckpt.SolveCheckpointStore(out + ".solveckpt").serials() == [1]
    art = str(td / "resume.jsonl")
    done = subprocess.run(_cmd(paths, out, "--solve_ckpt_stride", "1", "--resume",
                               "--metrics_out", art),
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    assert _bytes(out) == want
    assert re.findall(r"SART_POD_POINT resume serial=(\d+)", done.stderr) == ["1"]
    assert "resumed from solve checkpoint serial 1" in done.stderr
    assert max(podckpt.SolveCheckpointStore(out + ".solveckpt").serials()) > 1
    counters = {}
    for line in open(art):
        rec = json.loads(line)
        if rec.get("type") == "metric" and rec.get("kind") == "counter":
            counters[rec["name"]] = rec["value"]
    assert counters.get("solve_ckpt_resumed_total") == 1
    assert counters.get("solve_ckpt_written_total", 0) >= 1


def test_flipped_crc_falls_back_a_record(ckpt_world):
    """A kill in the window of serial 3, then a flipped byte in serial 2's
    record: the resume restores serial 1, to the same bytes."""
    paths, want, td = ckpt_world
    out = str(td / "crc.h5")
    env = _env({"SART_TEST_SOLVE_CKPT_DELAY": "0.4", "SART_TEST_POD_MARKERS": "1"})
    _kill_in_window(_cmd(paths, out, "--solve_ckpt_stride", "1"), env, 3)
    side = out + ".solveckpt"
    lines = open(side).readlines()
    assert len(lines) == 2
    lines[-1] = lines[-1].replace('"state": {', '"state": {"__rot__": 1, ', 1)
    with open(side, "w") as f:
        f.writelines(lines)
    done = subprocess.run(_cmd(paths, out, "--solve_ckpt_stride", "1", "--resume"),
                          env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    assert re.findall(r"SART_POD_POINT resume serial=(\d+)", done.stderr) == ["1"]
    assert _bytes(out) == want


def test_resume_under_another_configuration_is_refused(ckpt_world):
    paths, _, td = ckpt_world
    out = str(td / "sig.h5")
    env = _env({"SART_TEST_SOLVE_CKPT_DELAY": "0.4"})
    _kill_in_window(_cmd(paths, out, "--solve_ckpt_stride", "1"), env, 2)
    done = subprocess.run(_cmd(paths, out, "--solve_ckpt_stride", "1", "--resume",
                               "--momentum", "nesterov"),
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode == 1
    assert "does not match this solver configuration" in done.stderr


def test_permanent_checkpoint_failure_is_survived(ckpt_world):
    """Every append fails past its retries: a warning each time, no file,
    exit 0 with the bytes of the run without checkpoints, and the retry
    layer's exhaustion counter at ``solve.checkpoint``."""
    paths, want, td = ckpt_world
    out = str(td / "perm.h5")
    art = str(td / "perm.jsonl")
    proc = subprocess.run(_cmd(paths, out, "--solve_ckpt_stride", "2", "--metrics_out", art),
                          env=_env({"SART_FAULT": "solve.checkpoint:io:1:1000"}),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Warning: solve checkpoint serial 2 not written" in proc.stderr
    assert _bytes(out) == want
    assert not os.path.exists(out + ".solveckpt")
    exhausted = [json.loads(ln) for ln in open(art)]
    exhausted = [r for r in exhausted if r.get("name") == "retry_exhausted_total"
                 and r.get("labels", {}).get("site") == "solve.checkpoint"]
    assert exhausted and exhausted[0]["value"] >= 1
