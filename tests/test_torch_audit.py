"""The port's launch audit (sartsolver_tpu_torch/analysis/audit.py) on the
CPU: every entry of the JAX registry under its name, each run through the
port's real entry point for K and 2K iterations and held to its declared
invariants (``ok``), or refused on a grid with ``grid_refusal``'s words; each
port entry's collectives per iteration at or under the JAX entry's declared
budget; and the auditor catching a matrix-sized copy, a matrix-sized
conversion, an fp64 matrix, an extra host sync and a loop that runs nothing."""

import dataclasses
import json

import pytest
import torch

from sartsolver_tpu_torch.analysis import audit, registry
from sartsolver_tpu_torch.analysis.registry import AuditEntry, AuditShape
from sartsolver_tpu_torch.config import SolverOptions
from sartsolver_tpu_torch.parallel import comm
from sartsolver_tpu_torch.parallel.mesh import RankGrid
from sartsolver_tpu_torch.parallel.sharded import grid_loop_refusal, grid_refusal

REFUSED = {
    "sharded_integrity_batch": grid_refusal(SolverOptions(integrity=True), RankGrid(2, 1)),
    "sharded_sched_step": grid_loop_refusal("the continuous-batching scheduler"),
    "sharded_sparse_panel_sweep": grid_refusal(SolverOptions(sparse_rtm="0"),
                                               RankGrid(2, 1)),
    "sharded_implicit_batch": grid_refusal(SolverOptions(), RankGrid(2, 1), geometry=True),
    "sharded_lowrank_batch": grid_refusal(SolverOptions(lowrank_rtm="4"), RankGrid(2, 1)),
}


@pytest.fixture(scope="module")
def jax_registry():
    from sartsolver_tpu.analysis.registry import load_registered_entries

    return load_registered_entries()


@pytest.fixture(scope="module")
def reports():
    return {r.name: r for r in audit.run_launch_audit()}


def test_every_jax_entry_name_is_audited(reports, jax_registry):
    assert set(reports) == set(jax_registry) == set(registry.load_registered_entries())
    assert len(reports) == 20
    assert {n for n, r in reports.items() if r.status == "refused"} == set(REFUSED)


@pytest.mark.parametrize("name", sorted(registry.load_registered_entries()))
def test_entry_holds_its_invariants_on_the_cpu(name, reports, jax_registry):
    rep = reports[name]
    if name in REFUSED:
        assert rep.status == "refused" and rep.detail == REFUSED[name]
        assert not rep.failed and not rep.per_iteration
        return
    assert rep.status == "ok", rep.format()
    it = rep.per_iteration
    entry = registry.AUDIT_REGISTRY[name]
    assert it["aten_ops"] > 0 and it["host_syncs"] == 1  # the done flag
    assert it["launches"] == dict(entry.hand_launches)
    assert it["f64_max_elems"] <= rep.shape["B"] * rep.shape["P"]  # the precise ||Hf||^2
    budget = sum(jax_registry[name].loop_collective_budget.values())
    assert sum(it["collectives"].values()) <= budget
    if entry.min_ranks > 1:
        assert it["collectives"]["all-reduce"] == 2 and rep.shape["ranks"] == 2


def _fixture_entry(**kw):
    return AuditEntry(name="drill", build=None, description="drill", **kw)


def _loop(per_iteration):
    """A runner whose every iteration does ``per_iteration(P, V)``, with the
    done flag's sync, as the solver's loop does."""
    P, V = 16, 64

    def run(k):
        done = torch.zeros(1, dtype=torch.bool)
        for _ in range(k):
            if bool(done.all()):
                break
            per_iteration(P, V)

    return run, AuditShape(P, V)


@pytest.mark.parametrize("fault", ["copy", "convert", "fp64", "sync", "collective"])
def test_the_auditor_catches_a_fault_per_iteration(fault):
    H = torch.ones((16, 64), dtype=torch.float32)
    w = torch.ones((1, 16), dtype=torch.float32)

    def iteration(P, V):
        bp = w @ H
        if fault == "copy":
            H.clone()
        elif fault == "convert":
            H.to(torch.bfloat16)
        elif fault == "fp64":
            torch.zeros((P, V), dtype=torch.float64)
        elif fault == "sync":
            float(bp.sum())
        else:  # what parallel/comm.py counts for one gather
            comm.stats["by_kind"]["all-gather"] += 1
            with registry.region("collective", "all-gather"):
                pass
        return bp

    run, shape = _loop(iteration)
    rep = audit.measure_entry(_fixture_entry(), run, shape, k=2)
    assert rep.status == "violation" and len(rep.violations) == 1, rep.format()
    want = {"copy": "matrix-sized copy", "convert": "matrix-sized convert",
            "fp64": "fp64 tensor of 1024", "sync": "2 host sync(s)",
            "collective": "`all-gather` count 1"}[fault]
    assert want in rep.violations[0]


def test_the_auditor_accepts_a_clean_loop_and_counts_launches():
    H = torch.ones((16, 64), dtype=torch.float32)

    @registry.opaque("drill_kernel")
    def kernel(w):
        return (w @ H).clone()  # inside the launch: not the loop's copy

    run, shape = _loop(lambda P, V: kernel(torch.ones((1, 16), dtype=torch.float32)))
    rep = audit.measure_entry(_fixture_entry(hand_launches={"drill_kernel": 1}), run, shape, k=3)
    assert rep.status == "ok", rep.format()
    assert rep.per_iteration["launches"] == {"drill_kernel": 1}
    assert rep.per_iteration["ops_inside_launches"] >= 2
    rep = audit.measure_entry(_fixture_entry(), run, shape, k=3)  # undeclared launch
    assert rep.status == "violation" and "hand-kernel calls" in rep.violations[0]


def test_a_loop_that_runs_nothing_fails():
    rep = audit.measure_entry(_fixture_entry(host_sync_budget=0), lambda k: None,
                              AuditShape(16, 64), k=2)
    assert rep.status == "violation" and "no work per iteration" in rep.violations[0]


def test_the_fused_entry_takes_the_context_storage_and_batch():
    """chip_smoke.py runs the fused entry at bf16 and at larger B: the
    context's storage and frames reach the solver."""
    ctx = audit.AuditContext(B=3, storage="bfloat16")
    try:
        rep = audit.run_entry(registry.AUDIT_REGISTRY["fused_sweep"], ctx, k=2)
        assert rep.status == "ok", rep.format()
        assert rep.shape["B"] == 3
        solver = next(iter(ctx._solvers.values()))
        assert solver.problem.rtm.dtype == torch.bfloat16
    finally:
        ctx.close()


def test_unknown_entry_is_an_error():
    (rep,) = audit.run_launch_audit(entries=["no_such_entry"])
    assert rep.status == "error" and rep.failed and "unknown entry" in rep.detail


def test_reports_serialize_for_the_json_output():
    rep = audit.EntryReport("x", "ok", per_iteration={"launches": {"fused_sweep": 1}},
                            shape=dataclasses.asdict(AuditShape(2, 3)))
    assert audit.EntryReport(**dataclasses.asdict(rep)) == rep


def test_chip_smoke_audit_phase_at_small_size(tmp_path, capsys):
    """chip_smoke.py's audit phase on the CPU at a small size: every
    single-rank entry and the fused cases ok, one emitted line each, the
    five grid refusals by their words (the plans and CUDA kernels are the
    card's)."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(repo)
    world = cs.write_world(str(tmp_path), nx=16, ny=16, cam=(8, 4), n_frames=4)
    rec = cs.audit_phase(world, device="cpu",
                         geometry=cs.geometry_record(nx=8, ny=8, nz=4, cam=(8, 8)))
    assert rec["entries"] == 12 + len(cs.AUDIT_CASES)
    assert rec["refused"] == REFUSED
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    audited = [ln for ln in lines if ln["phase"] == "audit"]
    assert len(audited) == rec["entries"] and all(ln["status"] == "ok" for ln in audited)
    assert {(ln["entry"], ln["storage"], ln["shape"]["B"]) for ln in audited} >= set(
        cs.AUDIT_CASES)
