"""The observability layer through the port's CLI (sartsolver_tpu_torch.cli)
on the fixture world, on the CPU, beside the JAX CLI.

- The port's and the JAX CLI's ``--metrics_out`` artifacts of one world
  validate under both packages' ``validate_jsonl(require_run=True)``, and
  both tools' ``metrics --diff`` of the pair show the same frame outcomes.
- Turning every sink on (``--metrics_out``, ``SART_METRICS_PROM``,
  ``SART_TRACE_EVENTS``) changes no byte of the solution file and, apart
  from wall-clock digits, no line of stdout, in the chain loop, the
  scheduler and the classic loop, for each storage type; the artifact's
  frames and counters agree with the file and stdout.
- ``--timing``, the partial artifact of an error exit, ``--profile_dir``
  (one profiler step per group or stride), the OOM ladder's and the
  non-finite pixels' counters.
"""

import json
import os
import re

import h5py
import numpy as np
import pytest
import torch

import fixtures as fx
from sartsolver_tpu.cli import main as jax_main
from sartsolver_tpu.obs import schema as jschema
from sartsolver_tpu.obs.cli import metrics_main as jax_metrics_main

from sartsolver_tpu_torch.cli import PROFILE_TRACE
from sartsolver_tpu_torch.cli import main as torch_main
from sartsolver_tpu_torch.obs import schema, trace
from sartsolver_tpu_torch.obs.cli import metrics_main
from sartsolver_tpu_torch.parallel.sharded import DistributedSARTSolver

FP32 = ["--device", "cpu", "-m", "40", "-c", "1e-12"]
LOOPS = {
    "chain": ["--chain_frames", "2"],
    "scheduler": ["--no_guess", "--batch_frames", "3"],
    "classic": ["--no_guess", "--batch_frames", "3", "--no_continuous_batching"],
}
PHASES = ["validate + index inputs", "ingest RTM + upload",
          "frame loop (solve + prefetch + flush)", "write voxel map"]


@pytest.fixture
def world(tmp_path):
    return fx.write_world(tmp_path, with_laplacian=True)


@pytest.fixture(autouse=True)
def _no_env_sinks(monkeypatch):
    for var in ("SART_METRICS_PROM", "SART_TRACE_EVENTS"):
        monkeypatch.delenv(var, raising=False)
    yield
    trace.uninstall()


def _inputs(paths):
    return [paths[k] for k in ("rtm_a1", "rtm_a2", "rtm_b", "img_a", "img_b")]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _metric(records, name, **labels):
    hits = [r for r in records if r["type"] == "metric" and r["name"] == name
            and r["labels"] == labels]
    assert len(hits) == 1, (name, labels)
    return hits[0]


def _normalized(stdout):
    return re.sub(r"\d+\.\d+(e-?\d+)? ms", "X ms", stdout)


def _solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][:] for k in ("status", "iterations", "time")}


def test_port_and_jax_artifacts_agree_under_both_tools(world, tmp_path, capsys):
    """The fp64 profile (equal statuses and iterations in the two packages):
    each artifact passes both packages' run contract, both tools' --diff
    of the pair report no change in frames or statuses, and the frame
    records agree field by field except for the wall clock."""
    paths, *_ = world
    argv = [*_inputs(paths), "--use_cpu", "-m", "300", "-c", "1e-6"]
    port_art, jax_art = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert torch_main(["-o", str(tmp_path / "port.h5"), *argv, "--timing",
                       "--metrics_out", port_art]) == 0
    port_out = capsys.readouterr().out
    assert jax_main(["-o", str(tmp_path / "jax.h5"), *argv, "--pixel_shards", "1",
                     "--timing", "--metrics_out", jax_art]) == 0
    jax_out = capsys.readouterr().out
    # --timing: the same phase rows, sweep provenance and run summary
    tails = [out[out.index("timing summary (wall clock):"):].splitlines()
             for out in (port_out, jax_out)]
    names = [[re.split(r"\s{2,}", line.strip())[0] for line in tail[1:-2]]
             for tail in tails]
    assert names[0] == names[1] and "solve chain (pipelined wall)" in names[0]
    assert tails[0][-2:] == tails[1][-2:]
    for art in (port_art, jax_art):
        for validate in (schema.validate_jsonl, jschema.validate_jsonl):
            n, errors = validate(art, require_run=True)
            assert errors == [] and n > 0, (art, errors)
    diffs = []
    for tool in (metrics_main, jax_metrics_main):
        assert tool(["--diff", "--json", jax_art, port_art]) == 0
        diffs.append(json.loads(capsys.readouterr().out))
    for d in diffs:
        assert d["frames"] == {"old": 4, "new": 4} and d["by_status"] == {}
        assert "variant_mismatch" not in d
    assert diffs[0] == diffs[1]
    keep = ("time", "status", "status_name", "iterations", "group", "os_subsets",
            "momentum", "logarithmic", "operator")
    frames = [[{k: r[k] for k in keep} for r in _records(a) if r["type"] == "frame"]
              for a in (port_art, jax_art)]
    assert frames[0] == frames[1] and len(frames[0]) == 4
    meta = [_records(a)[0] for a in (port_art, jax_art)]
    assert meta[0]["backend"] == meta[1]["backend"] == "cpu"
    assert meta[0]["mesh"] == meta[1]["mesh"] == "1x1"
    assert {k for k in meta[1] if k != "created_unix"} <= set(meta[0])


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_sinks_change_no_byte(world, tmp_path, monkeypatch, capsys, loop, storage):
    """With every sink on, the solution file is the same bytes and stdout the
    same lines; the artifact passes the run contract, its frame records are
    the file's rows (count, status, iterations), frames_total counts the
    Processed-in lines and sched_strides_total the printed strides."""
    paths, *_ = world
    argv = [*_inputs(paths), *FP32, "-l", paths["laplacian"], "--rtm_dtype", storage,
            *LOOPS[loop]]
    plain, sinks_on = str(tmp_path / "plain.h5"), str(tmp_path / "sinks.h5")
    assert torch_main(["-o", plain, *argv]) == 0
    plain_out = capsys.readouterr().out
    art = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("SART_METRICS_PROM", str(tmp_path / "run.prom"))
    monkeypatch.setenv("SART_TRACE_EVENTS", str(tmp_path / "run.trace.json"))
    assert torch_main(["-o", sinks_on, *argv, "--metrics_out", art]) == 0
    captured = capsys.readouterr()
    assert _normalized(captured.out) == _normalized(plain_out)
    assert art in captured.err and art not in captured.out
    with open(plain, "rb") as a, open(sinks_on, "rb") as b:
        assert a.read() == b.read()

    assert metrics_main(["--check", art]) == 0
    records = _records(art)
    frames = [r for r in records if r["type"] == "frame"]
    sol = _solution(sinks_on)
    assert [r["status"] for r in frames] == sol["status"].tolist()
    assert [r["iterations"] for r in frames] == sol["iterations"].tolist()
    assert [r["time"] for r in frames] == sol["time"].tolist()
    n_processed = plain_out.count("Processed in:")
    assert n_processed == len(frames) == 4
    assert sum(r["value"] for r in records if r["type"] == "metric"
               and r["name"] == "frames_total") == n_processed
    assert {r["group"] for r in frames} == {"chain": {"chain"}, "scheduler": {"sched"},
                                            "classic": {"batch"}}[loop]
    if loop == "scheduler":
        strides = int(re.search(r"strides=(\d+)", plain_out)[1])
        assert _metric(records, "sched_strides_total")["value"] == strides
        assert _metric(records, "sched_lanes_backfilled_total")["value"] == 4
        assert _metric(records, "sched_lanes_retired_total")["value"] == 4
        occupancy = float(re.search(r"occupancy=([0-9.]+)", plain_out)[1])
        assert _metric(records, "sched_lane_occupancy")["value"] == round(occupancy, 6)
        assert _metric(records, "sched_stride_occupancy")["count"] == strides
    prom = (tmp_path / "run.prom").read_text()
    assert f'sart_frames_total{{status="{frames[0]["status_name"]}"}}' in prom
    names = {e["name"] for e in json.load(open(tmp_path / "run.trace.json"))["traceEvents"]}
    assert {"ingest.rtm", "device.put", "solve.dispatch", "result.fetch",
            "flush.voxel_map"} <= names


@pytest.mark.parametrize("case,flags,rows,engaged", [
    ("serial", ["--chain_frames", "1"], ["solve frame"], "plain"),
    ("chain", ["--chain_frames", "2"], ["solve chain (pipelined wall)"], "plain"),
    ("scheduler", LOOPS["scheduler"], ["solve sched (pipelined wall)"], "plain"),
    ("classic", LOOPS["classic"], ["solve batch (pipelined wall)"], "plain"),
    ("two_matmul", ["--fused_sweep", "off"], ["solve chain (pipelined wall)"], "off"),
    ("os", ["--os_subsets", "2"], ["solve chain (pipelined wall)"], "os-subset"),
])
def test_timing_prints_the_jax_phases(world, tmp_path, capsys, case, flags, rows, engaged):
    paths, *_ = world
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *FP32, *flags,
                       "--timing"]) == 0
    out = capsys.readouterr().out
    summary = out[out.index("timing summary (wall clock):"):].splitlines()
    names = [re.split(r"\s{2,}", line.strip())[0] for line in summary[1:]]
    want = PHASES[:2] + rows + PHASES[2:] + ["total"]
    assert names[:len(want)] == want
    requested = "off" if case == "two_matmul" else "auto"
    assert summary[len(want) + 1] == \
        f"fused sweep: requested={requested} resolved={requested} engaged={engaged}"
    assert summary[len(want) + 2].startswith("resilience summary: 4 frame(s): ")


def test_timing_on_the_fp64_profile_reads_off(world, tmp_path, capsys):
    paths, *_ = world
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), "--use_cpu",
                       "-m", "40", "--timing"]) == 0
    assert "fused sweep: requested=auto resolved=auto engaged=off" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["missing_file", "bad_time_range", "no_card"])
def test_error_exit_writes_a_partial_artifact(world, tmp_path, monkeypatch, capsys, case):
    """An input error exits 1 and leaves an artifact marked partial that
    passes both packages' run contract."""
    paths, *_ = world
    argv = ["-o", str(tmp_path / "o.h5"), *_inputs(paths)]
    if case == "missing_file":
        argv += [str(tmp_path / "nope.h5"), "--device", "cpu"]
    elif case == "bad_time_range":
        argv += ["--device", "cpu", "-t", "0.3:0.1"]
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = str(tmp_path / "abort.jsonl")
    assert torch_main([*argv, "--metrics_out", art]) == 1
    capsys.readouterr()
    records = _records(art)
    assert records[0]["type"] == "meta" and records[0]["partial"] is True
    assert records[-1]["type"] == "summary" and records[-1]["frames"] == 0
    assert metrics_main(["--check", art]) == 0
    assert jax_metrics_main(["--check", art]) == 0


@pytest.mark.parametrize("case,flags,steps", [
    ("serial", ["--chain_frames", "1"], 4),
    ("chain", ["--chain_frames", "2"], 2),
    ("classic", LOOPS["classic"], 2),
    ("scheduler", LOOPS["scheduler"], None),
    ("os", ["--chain_frames", "4", "--os_subsets", "2"], 1),
])
def test_profile_dir_has_one_step_per_group(world, tmp_path, capsys, case, flags, steps):
    """--profile_dir on --device cpu: a torch.profiler Chrome trace with one
    ProfilerStep per frame group (scheduler: per stride); the OS cycle's
    record_function ranges show in it."""
    paths, *_ = world
    prof = tmp_path / "prof"
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *FP32, *flags,
                       "--profile_dir", str(prof)]) == 0
    out = capsys.readouterr().out
    if steps is None:
        steps = int(re.search(r"strides=(\d+)", out)[1])
    events = json.load(open(prof / PROFILE_TRACE))["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert sorted(n for n in names if n.startswith("ProfilerStep#")) == \
        sorted(f"ProfilerStep#{k}" for k in range(steps))
    if case == "os":
        assert {"os_subset_forward", "os_subset_back", "os_full_forward"} <= set(names)


def test_nonfinite_pixels_are_counted(world, tmp_path, capsys):
    paths, *_ = world
    with h5py.File(paths["img_a"], "r+") as f:
        f["image/frame"][1, 0, 0] = np.nan
        f["image/frame"][2, 0, 0] = np.inf
    art = str(tmp_path / "run.jsonl")
    with pytest.warns(RuntimeWarning, match="non-finite"):
        assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *FP32,
                           "--metrics_out", art]) == 0
    assert _metric(_records(art), "nonfinite_pixels_total")["value"] == 2


@pytest.mark.parametrize("where", ["solve_batch", "sched_step"])
def test_oom_events_reach_the_artifact(world, tmp_path, monkeypatch, capsys, where):
    """A device OOM: the ladder's gauge and counter, one availability event
    in the artifact (and in --timing's summary), the message on stderr."""
    paths, *_ = world
    real = getattr(DistributedSARTSolver, where)
    calls = {"n": 0}

    def failing(self, *args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return real(self, *args, **kw)

    monkeypatch.setattr(DistributedSARTSolver, where, failing)
    loop = ["--no_guess", "--batch_frames", "4"]
    if where == "solve_batch":
        loop.append("--no_continuous_batching")
    art = str(tmp_path / "run.jsonl")
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *FP32, *loop,
                       "--metrics_out", art, "--timing"]) == 0
    captured = capsys.readouterr()
    records = _records(art)
    events = [r for r in records if r["type"] == "event"]
    assert len(events) == 1 and events[0]["message"] in captured.err
    assert f"  {events[0]['message']}" in captured.out.splitlines()
    assert _metric(records, "availability_events_total")["value"] == 1
    assert _metric(records, "oom_degradations_total")["value"] == \
        (1 if where == "solve_batch" else 0)
    # the scheduler hands its frames to the grouped loop at half its lanes
    assert _metric(records, "frame_group_size")["value"] == 2
    assert len([r for r in records if r["type"] == "frame"]) == 4
    assert metrics_main(["--check", art]) == 0


def test_metrics_subcommand_through_the_cli(world, tmp_path, capsys):
    paths, *_ = world
    art = str(tmp_path / "run.jsonl")
    assert torch_main(["-o", str(tmp_path / "o.h5"), *_inputs(paths), *FP32,
                       "--metrics_out", art]) == 0
    capsys.readouterr()
    assert torch_main(["metrics", "--check", art]) == 0
    assert capsys.readouterr().out == f"{art}: ok ({len(_records(art))} record(s))\n"
    assert torch_main(["metrics", art]) == 0
    assert "4 frame(s)" in capsys.readouterr().out
    assert os.path.exists(art)
