"""``sartsolve lint``: the command line of the static analysis.

Counterpart of ``sartsolver_tpu/analysis/cli.py``, with its flags, messages
and exit codes. Dispatched by ``sartsolver_tpu_torch.cli.main`` before the
solver's own parser. Three passes:

- the AST lint (``analysis/rules.py``) over explicit paths, or over the
  port's package with ``--self``;
- the launch audit (``analysis/audit.py``) of the registered hot entry
  points, run with ``--self`` (or ``--audit-only``) unless ``--no-audit``:
  on the CPU at the fixture's size, the grid entries in a two-rank gloo
  group of their own;
- the crash-point model checker (``analysis/protocol.py``) with
  ``--protocol``.

The port keeps no goldens (eager PyTorch compiles no module whose
op histogram or cost could be pinned), so ``--update-goldens`` and
``--update-cost-goldens`` are refused with their own words and exit 1.

Exit status: 1 when any error-severity lint finding, any audit failure
(an invariant violated, an entry that cannot run) or a protocol violation
survives, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

GOLDENS_REFUSAL = (
    "sartsolve lint: {flag} is refused: the port keeps no goldens (eager PyTorch "
    "compiles no module whose op histogram or cost could be pinned); its launch "
    "audit checks per-iteration counts against the invariants each entry declares "
    "(analysis/registry.py)."
)


def build_lint_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sartsolve lint",
        description="Static analysis for PyTorch hazards: AST lint rules "
                    "(SL002..) plus a launch audit of the registered hot entry "
                    "points and the crash-point model checker.",
    )
    p.add_argument("paths", nargs="*",
                   help="Files or directories to lint (recursively, *.py).")
    p.add_argument("--self", dest="self_", action="store_true",
                   help="Lint the sartsolver_tpu_torch package and run the "
                        "launch audit over its registered hot entry points.")
    p.add_argument("--no-audit", action="store_true",
                   help="Skip the launch audit (AST lint only).")
    p.add_argument("--audit-only", action="store_true",
                   help="Run only the launch audit (no AST lint).")
    p.add_argument("--update-goldens", action="store_true",
                   help="Refused: the port keeps no goldens.")
    p.add_argument("--update-cost-goldens", action="store_true",
                   help="Refused: the port keeps no goldens.")
    p.add_argument("--entries", default=None,
                   help="Comma-separated audit entry names (default: all "
                        "registered).")
    p.add_argument("--severity", default="",
                   help="Per-rule severity overrides, e.g. "
                        "'SL006=error,SL003=off'.")
    p.add_argument("--select", default="",
                   help="Comma-separated rule-id prefixes to run, e.g. "
                        "'SL1' for the concurrency family or "
                        "'SL002,SL1' to mix ids and families (default: "
                        "all rules).")
    p.add_argument("--ignore", default="",
                   help="Comma-separated rule-id prefixes to skip, e.g. "
                        "'SL1'; applied after --select.")
    p.add_argument("--protocol", action="store_true",
                   help="Run the crash-point model checker: enumerate a "
                        "crash at every durable-effect prefix (and every "
                        "byte boundary of every append) of the engine's "
                        "exactly-once protocol and assert the chaos "
                        "invariants over each (analysis/protocol.py).")
    p.add_argument("--protocol-stride", type=int, default=1,
                   metavar="N",
                   help="Thin the torn-append byte boundaries to every "
                        "Nth byte (default 1: every byte).")
    p.add_argument("--json", dest="json_", action="store_true",
                   help="Machine-readable output (findings, audit reports, "
                        "the protocol report).")
    p.add_argument("--list-rules", action="store_true",
                   help="Print the rule catalogue and exit.")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Only print errors and the summary line.")
    return p


def _parse_rule_prefixes(spec: str, flag: str, known: set) -> List[str]:
    """Parse a ``--select``/``--ignore`` prefix list. Each entry must be a
    rule-id prefix (``SL``, ``SL1``, ``SL101``) matching at least one known
    rule: a mistyped family that silently selects nothing would make a gate
    vacuous (an unknown id such as SL001 among them)."""
    from sartsolver_tpu_torch.config import SartInputError

    out: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if not (part.startswith("SL") and part[2:].isdigit()
                or part == "SL"):
            raise SartInputError(
                f"Unable to parse {flag} entry {part!r}; expected a rule-"
                "id prefix like 'SL1' or 'SL101'."
            )
        if not any(rule_id.startswith(part) for rule_id in known):
            raise SartInputError(
                f"{flag} prefix {part!r} matches no known rule; known: "
                f"{', '.join(sorted(known))}."
            )
        out.append(part)
    return out


def _protocol_tmpdir() -> None:
    """The checker spins up hundreds of fsync-heavy scratch dirs; tmpfs
    makes that cheap without weakening the check (the crash states are
    constructed, not produced by real power loss)."""
    if not os.environ.get("TMPDIR") and os.path.isdir("/dev/shm"):
        import tempfile

        os.environ["TMPDIR"] = "/dev/shm"
        tempfile.tempdir = None  # re-read TMPDIR


def lint_main(argv: Optional[List[str]] = None) -> int:
    args = build_lint_parser().parse_args(argv)

    from sartsolver_tpu_torch.analysis.rules import ALL_RULES, lint_paths
    from sartsolver_tpu_torch.config import SartInputError, parse_severity_overrides

    known = {rule.id for rule in ALL_RULES}
    try:
        overrides = parse_severity_overrides(args.severity)
        unknown = sorted(set(overrides) - known)
        if unknown:
            raise SartInputError(
                f"Unknown rule id(s) in --severity: {', '.join(unknown)}; "
                f"known rules: {', '.join(sorted(known))}."
            )
        select = _parse_rule_prefixes(args.select, "--select", known)
        ignore = _parse_rule_prefixes(args.ignore, "--ignore", known)
    except SartInputError as err:
        print(err, file=sys.stderr)
        return 1

    active_rules = tuple(
        rule for rule in ALL_RULES
        if (not select or any(rule.id.startswith(p) for p in select))
        and not any(rule.id.startswith(p) for p in ignore)
    )
    if (select or ignore) and not active_rules:
        print("sartsolve lint: --select/--ignore left no rules to run "
              f"(select={','.join(select) or '-'} "
              f"ignore={','.join(ignore) or '-'}).", file=sys.stderr)
        return 1

    if args.list_rules:
        for rule in active_rules:
            print(f"{rule.id} [{rule.severity}] {rule.title}")
            print(f"       fix: {rule.hint}")
        return 0

    for flag, on in (("--update-goldens", args.update_goldens),
                     ("--update-cost-goldens", args.update_cost_goldens)):
        if on:
            print(GOLDENS_REFUSAL.format(flag=flag), file=sys.stderr)
            return 1

    if not (args.paths or args.self_ or args.audit_only or args.protocol):
        print("sartsolve lint: pass paths to lint, or --self for the "
              "installed package (see --help).", file=sys.stderr)
        return 1

    # ---- AST lint --------------------------------------------------------
    findings = []
    if not args.audit_only:
        paths = list(args.paths)
        if args.self_:
            import sartsolver_tpu_torch

            paths.append(os.path.dirname(os.path.abspath(sartsolver_tpu_torch.__file__)))
        if paths:
            findings = lint_paths(paths, rules=active_rules, severity_overrides=overrides)

    # ---- launch audit ----------------------------------------------------
    reports = []
    if (args.self_ or args.audit_only) and not args.no_audit:
        from sartsolver_tpu_torch.analysis.audit import run_launch_audit

        entries = args.entries.split(",") if args.entries else None
        reports = run_launch_audit(entries=entries)

    # ---- crash-point model checker ---------------------------------------
    protocol_report = None
    if args.protocol:
        from sartsolver_tpu_torch.analysis.protocol import run_protocol_check

        _protocol_tmpdir()
        protocol_report = run_protocol_check(byte_stride=args.protocol_stride)

    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = sum(1 for f in findings if f.severity == "warning")
    n_info = len(findings) - n_err - n_warn
    failed_reports = [r for r in reports if r.failed]

    if args.json_:
        import dataclasses

        print(json.dumps({
            "findings": [dataclasses.asdict(f) for f in findings],
            "audit": [dataclasses.asdict(r) for r in reports],
            "protocol": (dataclasses.asdict(protocol_report)
                         if protocol_report else None),
            "errors": n_err,
            "warnings": n_warn,
            # which rules ran, and why (the --select/--ignore filters)
            "rules": [r.id for r in active_rules],
            "select": select,
            "ignore": ignore,
        }, indent=1))
    else:
        for f in findings:
            if args.quiet and f.severity != "error":
                continue
            print(f.format())
            if f.hint and not args.quiet:
                print(f"       fix: {f.hint}")
        for r in reports:
            if args.quiet and not r.failed:
                continue
            print(r.format())
        if protocol_report:
            rep = protocol_report
            for v in rep.violations:
                print(f"protocol: VIOLATION {v}")
            if not args.quiet:
                for name in sorted(rep.scenarios_by_effect):
                    print(f"protocol:   {name}: {rep.scenarios_by_effect[name]} crash "
                          f"state(s)")
            print(f"protocol: {rep.scenarios_total} crash state(s) "
                  f"over {rep.effects_armed} durable effects "
                  f"({rep.effect_points} declared effect points, "
                  f"byte stride {rep.byte_stride}): "
                  f"{len(rep.violations)} violation(s), commit order "
                  f"{'ok' if rep.commit_order_ok else 'VIOLATED'}")
        summary = (f"lint: {n_err} error(s), {n_warn} warning(s), "
                   f"{n_info} info finding(s)")
        if reports:
            refused = sum(1 for r in reports if r.status == "refused")
            summary += (f"; audit: {sum(1 for r in reports if r.status == 'ok')}/"
                        f"{len(reports)} entries ok, {refused} refused")
        print(summary)

    return 1 if (n_err or failed_reports
                 or (protocol_report and not protocol_report.ok)) else 0
