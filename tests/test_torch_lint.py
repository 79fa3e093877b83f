"""The port's AST lint (sartsolver_tpu_torch/analysis/rules.py and its SL1xx
and SL2xx families) against the JAX linter: the same concurrency and
durability findings (rule, line, severity) on every fixture snippet of the
JAX suite's lint tests and over both package trees; a true positive and a
near miss for each PyTorch SL0xx rule; the port's tree lints clean; and the
``lint`` command line's flags, messages and exit codes."""

import ast
import json
import os
import textwrap
import time

import pytest

from sartsolver_tpu.analysis import concurrency as jconc
from sartsolver_tpu.analysis import durability as jdur
from sartsolver_tpu.analysis import rules as jrules
from sartsolver_tpu.analysis.cli import lint_main as jax_lint_main
from sartsolver_tpu_torch.analysis import concurrency as conc
from sartsolver_tpu_torch.analysis import durability as dur
from sartsolver_tpu_torch.analysis import rules
from sartsolver_tpu_torch.analysis.cli import lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FAMILIES = jconc.CONCURRENCY_RULES + jdur.DURABILITY_RULES
PORT_FAMILIES = conc.CONCURRENCY_RULES + dur.DURABILITY_RULES


def _key(findings):
    return [(f.rule, f.line, f.severity) for f in findings]


def _snippets(path):
    """Every string literal of a test module that parses as Python source
    and spans lines: the lint fixtures."""
    out = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value:
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append(src)
    return out


@pytest.mark.parametrize("module", ["test_concurrency.py", "test_durability_lint.py",
                                    "test_analysis.py"])
def test_families_match_the_jax_linter_on_its_fixtures(module):
    snippets = _snippets(os.path.join(REPO, "tests", module))
    assert snippets
    fired = 0
    for src in snippets:
        want = _key(jrules.lint_source("fixture.py", src, rules=JAX_FAMILIES))
        got = _key(rules.lint_source("fixture.py", src, rules=PORT_FAMILIES))
        assert got == want, src
        fired += bool(want)
    if module != "test_concurrency.py":  # its drills hold no lint fixture
        assert fired


@pytest.mark.parametrize("suppressions", ["kept", "stripped"])
@pytest.mark.parametrize("tree", ["sartsolver_tpu", "sartsolver_tpu_torch"])
def test_families_match_the_jax_linter_over_both_trees(tree, suppressions):
    """Over every file of both packages: as written (both clean), and with
    every suppression comment stripped (the findings they hide)."""
    want, got = [], []
    for root, _dirs, names in os.walk(os.path.join(REPO, tree)):
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            src = open(path, encoding="utf-8").read()
            if suppressions == "stripped":
                src = src.replace("sart-lint:", "sart-lint-stripped:")
            want += _key(jrules.lint_source(path, src, rules=JAX_FAMILIES))
            got += _key(rules.lint_source(path, src, rules=PORT_FAMILIES))
    assert got == want
    assert bool(want) == (suppressions == "stripped")


_TORCH = "import torch\n"
_CASES = {
    "SL002": (
        _TORCH + "def f(n):\n"
        "    x = torch.zeros(n, dtype=torch.float32)\n"
        "    for _ in range(n):\n"
        "        v = x.sum().item()\n"
        "    while x.any():\n"
        "        x = x - 1\n",
        _TORCH + "def f(n, values):\n"
        "    x = torch.zeros(n, dtype=torch.float32)\n"
        "    total = float(x.sum())  # outside any loop\n"
        "    for v in values:\n"
        "        total += float(v)  # a host value\n"
        "    return total\n",
    ),
    "SL003": (
        _TORCH + "a = torch.zeros(4)\nb = torch.tensor([1.0, 2.0])\n"
        "c = torch.arange(8)\n",
        _TORCH + "import numpy as np\n"
        "a = torch.zeros(4, dtype=torch.float32)\n"
        "b = torch.as_tensor(np.ones(3), device='cpu')\n"
        "kw = dict(dtype=torch.float64)\nc = torch.ones(2, **kw)\n"
        "d = torch.zeros_like(a)\ne = torch.as_tensor([1.0], torch.float64)\n",
    ),
    "SL006": (
        _TORCH + "from sartsolver_tpu_torch.ops.fused_sweep import fused_sweep\n"
        "def f(x):\n"
        "    try:\n"
        "        return fused_sweep(x, x, x, [])\n"
        "    except Exception:\n"
        "        return torch.zeros(1, dtype=torch.float32)\n"
        "def g():\n"
        "    try:\n"
        "        pass\n"
        "    except:\n"
        "        pass\n",
        _TORCH + "import json\n"
        "def f(path):\n"
        "    try:\n"
        "        return json.load(open(path))\n"
        "    except Exception:\n"
        "        return None\n"
        "def g(x):\n"
        "    try:\n"
        "        return torch.matmul(x, x)\n"
        "    except RuntimeError:\n"
        "        raise\n",
    ),
    "SL007": (
        _TORCH + "def f(problem, rtm, x):\n"
        "    a = rtm @ x\n"
        "    return torch.matmul(problem.rtm, x)\n",
        _TORCH + "from sartsolver_tpu_torch.ops.projection import back_project\n"
        "def f(problem, rtm_scale, w, x):\n"
        "    a = back_project(problem.rtm, w) @ x\n"
        "    return torch.matmul(rtm_scale, x)\n",
    ),
}


@pytest.mark.parametrize("case", ["positive", "near_miss"])
@pytest.mark.parametrize("rule_id", sorted(_CASES))
def test_torch_rules_fire_and_stay_silent(rule_id, case):
    rule = next(r for r in rules.TORCH_RULES if r.id == rule_id)
    src = _CASES[rule_id][0 if case == "positive" else 1]
    findings = rules.lint_source("pkg/models/fixture.py", src, rules=[rule])
    if case == "near_miss":
        assert not findings, [f.format() for f in findings]
        return
    assert findings and {f.rule for f in findings} == {rule_id}
    if rule_id == "SL006":
        assert [f.severity for f in findings] == ["warning", "error"]
    if rule_id == "SL002":
        assert len(findings) == 2  # the .item() and the while test
    if rule_id == "SL003":
        assert len(findings) == 3


def test_sl007_blesses_the_operator_layer():
    src = _CASES["SL007"][0]
    for path in ("sartsolver_tpu_torch/ops/projection.py", "sartsolver_tpu_torch/ops/os_subsets.py",
                 "sartsolver_tpu_torch/ops/fused_sweep.py",
                 "sartsolver_tpu_torch/operators/lowrank.py"):
        assert not rules.lint_source(path, src, rules=[rules.DenseRtmContraction()])
    assert rules.lint_source("sartsolver_tpu_torch/models/sart.py", src,
                             rules=[rules.DenseRtmContraction()])


def test_suppression_and_severity_override():
    src = (_TORCH + "a = torch.zeros(4)  # sart-lint: disable=SL003\n\n"
           "b = torch.ones(4)\n")
    findings = rules.lint_source("x.py", src)
    assert _key(findings) == [("SL003", 4, "warning")]
    assert _key(rules.lint_source("x.py", src, severity_overrides={"SL003": "error"})) == [
        ("SL003", 4, "error")]
    assert not rules.lint_source("x.py", src, severity_overrides={"SL003": "off"})


def test_port_tree_lints_clean_in_budget():
    t0 = time.perf_counter()
    findings = rules.lint_paths([os.path.join(REPO, "sartsolver_tpu_torch")])
    assert time.perf_counter() - t0 < 10.0
    assert not findings, "\n".join(f.format() for f in findings)


def test_catalogue_holds_the_torch_rules_and_both_families():
    ids = [r.id for r in rules.ALL_RULES]
    assert ids == ["SL002", "SL003", "SL006", "SL007", "SL101", "SL102", "SL103", "SL104",
                   "SL105", "SL201", "SL202", "SL203", "SL204", "SL205"]


@pytest.mark.parametrize("argv", [
    [],
    ["--self", "--severity", "SL4=error"],
    ["--self", "--severity", "SL003=loud"],
    ["--self", "--select", "X1"],
    ["--self", "--ignore", "SL"],
    ["--self", "--select", "SL1", "--ignore", "SL1"],
])
def test_cli_usage_errors_match_the_jax_cli(argv, capsys):
    assert lint_main(argv) == 1
    ours = capsys.readouterr().err
    assert jax_lint_main(argv) == 1
    assert ours == capsys.readouterr().err


def test_cli_refuses_the_jax_only_rules_and_the_goldens(capsys):
    assert lint_main(["--self", "--select", "SL001"]) == 1
    assert capsys.readouterr().err.startswith(
        "--select prefix 'SL001' matches no known rule; known: SL002, SL003")
    assert lint_main(["--self", "--severity", "SL004=error"]) == 1
    assert "Unknown rule id(s) in --severity: SL004" in capsys.readouterr().err
    for flag in ("--update-goldens", "--update-cost-goldens"):
        assert lint_main([flag]) == 1
        assert f"{flag} is refused: the port keeps no goldens" in capsys.readouterr().err


def test_cli_json_and_list_rules(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(_CASES["SL003"][0] + "import time, threading\n_lock = threading.Lock()\n"
                   "def f():\n    with _lock:\n        time.sleep(1)\n")
    assert lint_main([str(bad), "--json"]) == 0  # warnings only
    out = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in out["findings"]} == {"SL003", "SL102"}
    assert out["errors"] == 0 and out["audit"] == [] and out["protocol"] is None
    assert out["rules"] == [r.id for r in rules.ALL_RULES]
    assert lint_main([str(bad), "--json", "--select", "SL1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in out["findings"]} == {"SL102"}
    assert out["rules"] == ["SL101", "SL102", "SL103", "SL104", "SL105"]
    assert lint_main(["--list-rules", "--select", "SL0"]) == 0
    listed = capsys.readouterr().out
    assert "SL002 [error]" in listed and "SL101" not in listed
