"""The port's crash-point model checker (sartsolver_tpu_torch/analysis/
protocol.py) over the port's engine, against the JAX checker over the JAX
engine: the same effect points, crash states and verdict at one byte
stride, and both catch the three drills of tests/test_protocol.py (the
replay gate broken on purpose, the recount disabled, the response publish
without fsync). Plus the torn-write drills of the port's atomicio, and the
shim it gives the checker (use_fs)."""

import json
import os
import tempfile

import pytest

import sartsolver_tpu.analysis.protocol as jap
import sartsolver_tpu.engine.protocol as jep
import sartsolver_tpu_torch.analysis.protocol as ap
import sartsolver_tpu_torch.engine.protocol as ep
from sartsolver_tpu_torch.engine.journal import RequestJournal
from sartsolver_tpu_torch.engine.request import Request
from sartsolver_tpu_torch.utils import atomicio

# the drills' stride (as the JAX suite's); the agreement's is finer
DRILL_STRIDE = 30
AGREE_STRIDE = 9


@pytest.fixture(autouse=True)
def _shm_tmpdir(monkeypatch):
    # hundreds of fsync-heavy scratch dirs: tmpfs, as the JAX drills use
    if os.path.isdir("/dev/shm"):
        monkeypatch.setenv("TMPDIR", "/dev/shm")
        tempfile.tempdir = None
        yield
        tempfile.tempdir = None
    else:
        yield


def test_port_checker_agrees_with_the_jax_checker(monkeypatch):
    # the records carry time.time(), whose repr's length moves the torn-byte
    # count; one fixed clock makes both runs' records the same bytes
    import time

    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    ours = ap.run_protocol_check(byte_stride=AGREE_STRIDE)
    theirs = jap.run_protocol_check(byte_stride=AGREE_STRIDE)
    assert ours.ok and theirs.ok, "\n".join(ours.violations + theirs.violations)
    assert ours.commit_order_ok and theirs.commit_order_ok
    assert set(ours.scenarios_by_effect) == {p.name for p in ep.PROTOCOL}
    assert ours.scenarios_by_effect == theirs.scenarios_by_effect
    assert (ours.effect_points, ours.effects_armed, ours.scenarios_total) == (
        theirs.effect_points, theirs.effects_armed, theirs.scenarios_total)
    assert ours.scenarios_by_effect["journal.completed"] > 10


def _broken_republish(outcome, prev, *, response_ttl_s, now=None):
    """The replay gate of the old bug: republish on a MISSING response only
    (the kill leaves the stale pending response behind)."""
    import time as _t

    if not outcome:
        return False
    now = _t.time() if now is None else now
    done = float(outcome.get("journal_unix") or now)
    fresh = (not response_ttl_s) or (now - done < response_ttl_s)
    return bool(fresh and prev is None)


_DRILLS = {
    "republish_gate": (("needs_republish", _broken_republish), None,
                       lambda v: "stuck in state 'pending'" in v),
    "recount_disabled": (("uncounted_completed", lambda completed, counted: []), None,
                         lambda v: "counters" in v),
    "publish_without_fsync": (None, ("RESPONSE_FSYNC", False),
                              lambda v: "torn" in v and "atomic-publish" in v),
}


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("drill", sorted(_DRILLS))
def test_both_checkers_catch_the_drills(monkeypatch, drill, package):
    checker, engine = (ap, ep) if package == "port" else (jap, jep)
    on_engine, on_checker, seen = _DRILLS[drill]
    if on_engine:
        monkeypatch.setattr(engine, *on_engine)
    if on_checker:
        monkeypatch.setattr(checker, *on_checker)
    rep = checker.run_protocol_check(byte_stride=DRILL_STRIDE)
    assert not rep.ok
    assert any(seen(v) for v in rep.violations), rep.violations[:5]
    if drill == "recount_disabled":  # a violation names its chaos window
        assert any("chaos kill window: ckpt" in v for v in rep.violations)


def test_use_fs_routes_every_helper_through_the_shim(tmp_path):
    calls = []

    class Tracer:
        def append(self, path, data, *, fsync=True):
            calls.append(("append", os.path.basename(path), fsync))

        def write_atomic(self, path, data, *, fsync=True):
            calls.append(("publish", os.path.basename(path), fsync))

        def remove(self, path):
            calls.append(("delete", os.path.basename(path)))

    (tmp_path / "x.json.1.tmp").write_text("debris")
    with atomicio.use_fs(Tracer()):
        assert atomicio.current_fs() is not atomicio._REAL_FS
        atomicio.append_line(str(tmp_path / "j.jsonl"), "{}\n")
        atomicio.write_atomic(str(tmp_path / "a.json"), "{}", fsync=False)
        atomicio.write_json_atomic(str(tmp_path / "b.json"), {})
        assert atomicio.sweep_orphans(str(tmp_path)) == 1
    assert atomicio.current_fs() is atomicio._REAL_FS
    assert calls == [("append", "j.jsonl", True), ("publish", "a.json", False),
                     ("publish", "b.json", True), ("delete", "x.json.1.tmp")]
    assert os.listdir(tmp_path) == ["x.json.1.tmp"]  # the tracer touched nothing


def test_append_seals_a_torn_tail(tmp_path):
    path = str(tmp_path / "log.jsonl")
    atomicio.append_line(path, json.dumps({"n": 1}) + "\n")
    with open(path, "a") as f:
        f.write('{"n": 2, "torn')  # kill -9 mid-append
    atomicio.append_line(path, json.dumps({"n": 3}) + "\n")
    parsed = []
    for ln in open(path).read().splitlines():
        try:
            parsed.append(json.loads(ln))
        except ValueError:
            parsed.append(None)
    assert parsed == [{"n": 1}, None, {"n": 3}]


def test_append_after_every_truncation_point(tmp_path):
    base = str(tmp_path / "base.jsonl")
    for i in range(3):
        atomicio.append_line(base, json.dumps({"i": i}) + "\n")
    data = open(base, "rb").read()
    rec = json.dumps({"i": "after"}) + "\n"
    for cut in range(len(data) + 1):
        path = str(tmp_path / f"cut{cut}.jsonl")
        with open(path, "wb") as f:
            f.write(data[:cut])
        atomicio.append_line(path, rec)
        assert json.loads(open(path).read().splitlines()[-1]) == {"i": "after"}


# the truncation drill's byte stride: the JAX suite's twin walks every byte
# (about 80 s); stride 1 stays reachable through `lint --protocol
# --protocol-stride 1`
TRUNCATION_STRIDE = 5


def test_journal_replay_tolerates_truncation_at_a_byte_stride(tmp_path):
    """The port's journal and replay under torn tails every
    TRUNCATION_STRIDE bytes, and at every record boundary: no exception,
    and the recovered story is always a consistent prefix."""
    j = RequestJournal(str(tmp_path / "journal.jsonl"))
    reqs = [Request(id=f"r{i}", trace=f"t{i}") for i in range(3)]
    for r in reqs:
        j.accepted(r)
        j.dispatched(r)
        j.completed(r, {"status": "completed"})
    data = open(j.path, "rb").read()
    cuts = sorted(set(range(0, len(data) + 1, TRUNCATION_STRIDE))
                  | {i + 1 for i, b in enumerate(data) if b == ord("\n")} | {len(data)})
    prev_known = -1
    for cut in cuts:
        p = str(tmp_path / "cut.jsonl")
        with open(p, "wb") as f:
            f.write(data[:cut])
        completed, pending = RequestJournal(p).replay()
        known = set(completed) | {r.id for r in pending}
        assert known <= {r.id for r in reqs}
        assert len(known) >= prev_known
        prev_known = len(known)
    assert prev_known == 3


def test_sweep_orphans_removes_only_tmp_files(tmp_path):
    d = str(tmp_path)
    open(os.path.join(d, "keep.json"), "w").write("{}")
    open(os.path.join(d, "a.json.123.tmp"), "w").write("debris")
    open(os.path.join(d, "b.json.456.tmp"), "w").write("debris")
    os.makedirs(os.path.join(d, "sub.tmp"))  # a directory: not swept
    assert atomicio.sweep_orphans(d) == 2
    assert sorted(os.listdir(d)) == ["keep.json", "sub.tmp"]
    assert atomicio.sweep_orphans(os.path.join(d, "missing")) == 0


def test_lint_protocol_cli_green(capsys):
    from sartsolver_tpu_torch.cli import main

    assert main(["lint", "--protocol", "--protocol-stride", str(DRILL_STRIDE), "-q"]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s), commit order ok" in out
    assert f"byte stride {DRILL_STRIDE}" in out
