"""The integrity layer of the port (``--integrity``) against the JAX package's.

``resilience/integrity.py`` gives the JAX module's tolerances, sums,
verdicts and escalation on the same inputs; a clean ``--integrity`` run
writes the same file as one without, in every frame loop and storage; the
``corrupt`` fault kind is caught where the JAX CLI catches it
(``tests/test_integrity.py``): a torn RTM read is read again, a corrupted
resident matrix trips the in-solve check, is re-solved once and then
FAILED or quarantined, with the JAX CLI's exit codes and statuses on the
same fault seed; a genuine divergence stays DIVERGED.
"""

import json

import h5py
import ml_dtypes
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.resilience import integrity as jinteg

from sartsolver_tpu_torch.cli import main
from sartsolver_tpu_torch.config import DIVERGED, SolverOptions
from sartsolver_tpu_torch.models import sart as tsart
from sartsolver_tpu_torch.ops.laplacian import make_laplacian
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver
from sartsolver_tpu_torch.resilience import faults
from sartsolver_tpu_torch.resilience import integrity as integ
from sartsolver_tpu_torch.resilience.failures import (
    EXIT_INFRASTRUCTURE,
    EXIT_PARTIAL,
    FRAME_FAILED,
    SDC_DETECTED,
    PersistentCorruptionError,
)
from sartsolver_tpu_torch.resilience.retry import reset_retry_stats, retry_stats


@pytest.fixture(autouse=True)
def _clean_state():
    faults.reset()
    faults.clear_faults()
    reset_retry_stats()
    integ._state["enabled"] = None
    tsart.record_abft_worst(True)  # an empty record, not kept
    tsart.record_abft_worst(False)
    yield
    tsart.record_abft_worst(False)
    faults.reset()
    integ._state["enabled"] = None
    # the JAX CLI's --integrity runs set its process-wide switch too; later
    # tests in this process would read matrices twice
    jinteg._state["enabled"] = None


# ---------------------------------------------------------------------------
# the module against the JAX module

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rtm_dtype", [None, "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(14, 16), (8192, 65536), (16384, 65536)])
def test_abft_tolerance_equals_the_jax_band(dtype, rtm_dtype, shape):
    assert integ.abft_tolerance(dtype, rtm_dtype, *shape) == \
        jinteg.abft_tolerance(dtype, rtm_dtype, *shape)


def test_storage_round_ingest_stats_and_verdicts_equal_jax():
    rng = np.random.default_rng(7)
    block = (rng.standard_normal((9, 13)) * 50).astype(np.float32)
    for name in ("float32", "bfloat16", "float64"):
        np.testing.assert_array_equal(integ.storage_round(block, name),
                                      jinteg.storage_round(block, name))
    np.testing.assert_array_equal(integ._bf16_round(block),
                                  np.asarray(block, ml_dtypes.bfloat16).astype(np.float32))
    port, jax_stats = integ.IngestStats(9, 13), jinteg.IngestStats(9, 13)
    for r0 in (0, 4):
        part = integ.storage_round(block[r0:r0 + 5], "bfloat16")
        port.add(part, r0, 0)
        jax_stats.add(part, r0, 0)
    for key in ("colsum", "rowsum", "colabs", "rowabs"):
        np.testing.assert_array_equal(getattr(port, key), getattr(jax_stats, key))
    dev = integ.IngestStats(9, 13)  # the sums where a tensor lies
    for r0 in (0, 4):
        dev.add(torch.as_tensor(integ.storage_round(block[r0:r0 + 5], "bfloat16")), r0, 0)
    np.testing.assert_allclose(dev.finish().colsum, port.colsum, rtol=1e-15)
    dens, length = port.colsum.copy(), port.rowsum.copy()
    for d, ln in ((dens, length), (dens + 1.0, length), (dens, length * (1 + 1e-3))):
        assert integ.verify_ray_stats(port, d, ln) == jinteg.verify_ray_stats(jax_stats, d, ln)
    assert integ.verify_ray_stats(port, dens + 1.0, length)


def test_sdc_escalation_equals_jax(monkeypatch):
    monkeypatch.setenv("SART_SDC_ABORT_THRESHOLD", "3")
    events, jevents = [], []
    port = integ.SdcEscalation(on_event=events.append)
    jax_policy = jinteg.SdcEscalation(on_event=jevents.append)
    assert port.threshold == jax_policy.threshold == 3
    for policy in (port, jax_policy):
        policy.detected(2)
        policy.note_recompute(2)
        policy.record_terminal(0.1)
        policy.record_terminal(0.2)
    with pytest.raises(PersistentCorruptionError) as err:
        port.record_terminal(0.3)
    with pytest.raises(jinteg.PersistentCorruptionError) as jerr:
        jax_policy.record_terminal(0.3)
    assert str(err.value) == str(jerr.value) and events == jevents
    with pytest.raises(PersistentCorruptionError, match="resident integrity"):
        integ.SdcEscalation().resident_failure("ray_density: 1 element(s) changed")


def test_a_genuine_divergence_stays_diverged_not_sdc():
    """Integrity and the divergence guard on a solve that genuinely
    diverges (an unstable Laplacian weight): the frame ends DIVERGED, equal
    to the guard-only run byte for byte, never SDC_DETECTED
    (``tests/test_integrity.py:336``); the JAX solver agrees on the status."""
    from sartsolver_tpu.config import SolverOptions as JaxOptions
    from sartsolver_tpu.models.sart import make_problem as jmake_problem
    from sartsolver_tpu.models.sart import solve as jsolve
    from sartsolver_tpu.ops.laplacian import make_laplacian as jmake_laplacian

    rng = np.random.default_rng(3)
    H = rng.uniform(0.1, 1.0, (16, 12)).astype(np.float32)
    g = H @ rng.uniform(0.5, 2.0, 12)
    V = H.shape[1]
    rows, cols, vals = [], [], []
    for i in range(V):
        rows.append(i), cols.append(i), vals.append(2.0)
        if i > 0:
            rows.append(i), cols.append(i - 1), vals.append(-1.0)
        if i < V - 1:
            rows.append(i), cols.append(i + 1), vals.append(-1.0)
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals, np.float32)
    kw = dict(max_iterations=500, conv_tolerance=1e-6, beta_laplace=0.8,
              divergence_recovery=6, divergence_threshold=1e3)
    lap = make_laplacian(rows, cols, vals, nvoxel=V, dtype=torch.float32, device="cpu")
    out = {}
    for name, on in (("guard", False), ("both", True)):
        opts = SolverOptions(integrity=on, **kw)
        out[name] = tsart.solve(tsart.make_problem(H, lap, opts=opts, device="cpu"), g,
                                opts=opts, device="cpu")
    assert int(out["both"].status) == int(out["guard"].status) == DIVERGED
    assert int(out["both"].iterations) == int(out["guard"].iterations)
    assert torch.equal(out["both"].solution, out["guard"].solution)
    jopts = JaxOptions(integrity=True, **kw)
    jlap = jmake_laplacian(rows, cols, vals, dtype="float32")
    assert int(jsolve(jmake_problem(H, jlap, opts=jopts), g, opts=jopts).status) == DIVERGED


def test_solver_ray_stats_verify_reaudit_and_resident_corruption(monkeypatch):
    """The upload-time snapshot verifies against the ingest's sums and
    re-audits clean (the same reductions twice give the same bits); a
    ``device.buffer`` corruption of the resident matrix shows in the
    re-audit, for every storage."""
    rng = np.random.default_rng(5)
    H = rng.uniform(0.5, 1.0, (24, 32)).astype(np.float32)
    for storage in ("float32", "bfloat16", "int8"):
        opts = SolverOptions(integrity=True, rtm_dtype=storage, max_iterations=5)
        # a copy: on the CPU an fp32 matrix is held where it lies
        solver = DistributedSARTSolver(H.copy(), opts=opts, device="cpu")
        stats = integ.IngestStats(*H.shape)
        if storage == "int8":
            scale = solver.problem.rtm_scale.numpy()
            # the host recipe of the int8 codes, dequantized
            codes = np.clip(np.rint(H / scale[None, :]), -127, 127)
            stats.add(codes.astype(np.float64) * scale.astype(np.float64)[None, :], 0, 0)
        else:
            stats.add(integ.storage_round(H, storage), 0, 0)
        assert solver.verify_ray_stats(stats) == [] and solver.reaudit_ray_stats() == []
        faults.inject(faults.SITE_DEVICE_BUFFER, "corrupt", count=1)
        res = solver.solve_batch(rng.uniform(0.5, 1.5, (2, 32)) @ H.T)
        assert (res.status == SDC_DETECTED).all()
        assert any("ray_density" in m for m in solver.reaudit_ray_stats())
        faults.clear_faults()


# ---------------------------------------------------------------------------
# the CLI

@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path)


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def run_cli(paths, *extra, out=None):
    return main(["-o", out or paths["output"], *_inputs(paths), "--device", "cpu",
                 "-m", "100", *extra])


def _status(path):
    with h5py.File(path, "r") as f:
        return f["solution/status"][:]


LOOPS = {"chain": [], "serial": ["--chain_frames", "1"],
         "scheduler": ["--no_guess", "--batch_frames", "3"],
         "classic": ["--no_guess", "--batch_frames", "3", "--no_continuous_batching"]}


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_clean_integrity_run_writes_the_same_file(world, tmp_path, storage):
    """Every loop and storage: ``--integrity`` on a clean run trips nothing
    (its largest residual stays inside the band), the three counters are
    registered at zero, and the file is the same bytes as without it. The
    residual's record is kept only where asked for."""
    paths, *_ = world
    assert run_cli(paths, *LOOPS["chain"], "--integrity", out=str(tmp_path / "norec.h5")) == 0
    assert tsart.abft_worst_ratio() == 0.0
    tsart.record_abft_worst(True)
    for loop, flags in LOOPS.items():
        plain, checked = str(tmp_path / f"{loop}.h5"), str(tmp_path / f"{loop}.int.h5")
        flags = flags + ["--rtm_dtype", storage]
        assert run_cli(paths, *flags, out=plain) == 0
        metrics = checked + ".jsonl"
        assert run_cli(paths, *flags, "--integrity", "--metrics_out", metrics,
                       out=checked) == 0
        with open(plain, "rb") as a, open(checked, "rb") as b:
            assert a.read() == b.read(), loop
        counters = {r["name"]: r["value"] for r in map(json.loads, open(metrics))
                    if r.get("type") == "metric" and r.get("kind") == "counter"}
        for name in ("sdc_detected_total", "integrity_recomputes_total",
                     "stripe_digest_mismatch_total"):
            assert counters.get(name) == 0, (loop, name)
    assert 0 < tsart.abft_worst_ratio() < 1


def test_a_torn_rtm_read_is_detected_and_read_again(world, tmp_path, monkeypatch):
    paths, *_ = world
    clean = str(tmp_path / "clean.h5")
    assert run_cli(paths, out=clean) == 0
    monkeypatch.setenv("SART_FAULT", "hdf5.rtm_ingest:corrupt:1:1")
    faults.reset()
    metrics = paths["output"] + ".jsonl"
    assert run_cli(paths, "--integrity", "--metrics_out", metrics) == 0
    with open(clean, "rb") as a, open(paths["output"], "rb") as b:
        assert a.read() == b.read()
    assert retry_stats()["hdf5.rtm_ingest"]["recoveries"] == 1
    assert any(r.get("name") == "stripe_digest_mismatch_total" and r["value"] == 1
               for r in map(json.loads, open(metrics)))
    faults.reset()  # the same fault without the layer poisons the solutions
    assert run_cli(paths) == 0
    with open(clean, "rb") as a, open(paths["output"], "rb") as b:
        assert a.read() != b.read()


def _jax_recipe(self):
    """The JAX package's ``device.buffer`` recipe for a float matrix,
    ``x * 256 + 1`` on element [0, 0]."""
    if faults.take_corrupt(faults.SITE_DEVICE_BUFFER):
        rtm = self._live_problem().rtm
        rtm[0, 0] = rtm[0, 0] * 256 + 1


@pytest.mark.parametrize("recipe", ["own", "jax"])
@pytest.mark.parametrize("loop", ["chain", "scheduler", "classic"])
@pytest.mark.parametrize("threshold", [None, "99"])
def test_resident_corruption_fails_or_quarantines_as_the_jax_cli(world, tmp_path,
                                                                 monkeypatch, capsys,
                                                                 loop, threshold, recipe):
    """``device.buffer:corrupt:1:1``: the check trips, the recompute
    reproduces it; at the default threshold the run is quarantined (exit 3,
    "Quarantined", a crash bundle), at a high one every frame is FAILED
    (exit 2) — the JAX CLI's exit code and statuses. The fault site is the
    same, the recipes differ: the port flips the exponent's top bit of a
    float element (about 1e38 for fp32), the JAX package computes
    ``x * 256 + 1`` (``own``); ``jax`` runs the port with the JAX recipe,
    so both packages meet the same change of the matrix. (On this world
    either change is far above the check's band; at 8192 x 65,536 the JAX
    one is below it, and the re-audit catches it: ``chip_smoke.py``.)"""
    paths, *_ = world
    monkeypatch.setenv("SART_FAULT", "device.buffer:corrupt:1:1")
    if recipe == "jax":
        monkeypatch.setattr(DistributedSARTSolver, "_maybe_corrupt_resident", _jax_recipe)
    if threshold:
        monkeypatch.setenv("SART_SDC_ABORT_THRESHOLD", threshold)
    jax_out = str(tmp_path / "jax.h5")
    faults.reset()
    from sartsolver_tpu.resilience import faults as jfaults

    jfaults.reset()
    jrc = jax_main(["-o", jax_out, *_inputs(paths), "-m", "100", "--pixel_shards", "1",
                    "--integrity", *LOOPS[loop]])
    jfaults.reset()
    rc = run_cli(paths, "--integrity", *LOOPS[loop])
    assert rc == jrc == (EXIT_PARTIAL if threshold else EXIT_INFRASTRUCTURE)
    err = capsys.readouterr()
    if threshold:
        assert (_status(paths["output"]) == FRAME_FAILED).all()
        np.testing.assert_array_equal(_status(paths["output"]), _status(jax_out))
        assert "integrity: " in err.out and "SDC detection(s)" in err.out
    else:
        assert "Quarantined" in err.err
        rec = json.load(open(paths["output"] + ".crash.json"))
        assert rec["reason"].startswith("SDC quarantine:")


def test_a_lane_that_trips_once_is_re_solved_and_written(world, tmp_path, monkeypatch,
                                                          capsys):
    """A transient corruption (undone before the recompute): the scheduler
    re-queues the tripped lanes once, ahead of new frames, and they solve
    clean — the file equals the clean run's, exit 0."""
    paths, *_ = world
    clean = str(tmp_path / "clean.h5")
    assert run_cli(paths, *LOOPS["scheduler"], out=clean) == 0
    calls = {"n": 0, "saved": None}
    original = DistributedSARTSolver._maybe_corrupt_resident

    def transient(self):
        rtm = self.problem.rtm
        calls["n"] += 1
        if calls["n"] == 1:
            calls["saved"] = rtm[0, 0].clone()
            rtm[0, 0] = rtm[0, 0] * 256 + 1
        elif calls["saved"] is not None:
            rtm[0, 0], calls["saved"] = calls["saved"], None
        return original(self)

    monkeypatch.setattr(DistributedSARTSolver, "_maybe_corrupt_resident", transient)
    assert run_cli(paths, *LOOPS["scheduler"], "--integrity") == 0
    with open(clean, "rb") as a, open(paths["output"], "rb") as b:
        assert a.read() == b.read()
    out = capsys.readouterr().out
    assert "SDC detection(s)" in out and "re-solved" in out
