"""Durability lint rules (SL201-SL205) for the exactly-once engine.

Counterpart of ``sartsolver_tpu/analysis/durability.py``, rule for rule.
The engine's crash contract rests on a few written disciplines: durable
bytes go through ``utils/atomicio.py`` (append = flush and fsync, publish =
tmp, fsync and rename), the ``completed`` journal marker commits before the
response publishes, replay and restore re-derive state deterministically,
and checkpointed soft state never changes without a ``_save_state``
boundary on the path. These rules check them at lint time; the crash-point
model checker (``analysis/protocol.py``) then proves the runtime contract
over every effect prefix.

Conventions the rules read:

- ``# durable: <family>`` on a path attribute's initializing assignment
  (``self.path = path  # durable: journal``) declares every write to
  that path durable; SL201 then requires the blessed helper, and SL203
  treats families whose text mentions ``response`` as publish targets.
- ``# checkpointed by: <func>`` on an attribute's initializing
  assignment declares its mutations checkpoint-bound; SL205 then checks
  every mutating path reaches a ``<func>`` call afterwards.

Like SL0xx/SL1xx these are precision-tuned single-file heuristics:
SL203/SL204/SL205 walk the same-module call graph only (name calls and
``self.method()`` calls), and a rule with no declarations in a module
stays silent there.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from sartsolver_tpu_torch.analysis.rules import (
    Finding,
    ModuleModel,
    Rule,
    _attr_path,
    _scoped_walk,
)

_DURABLE_RE = re.compile(r"#\s*durable:\s*(.+?)\s*$")
_CHECKPOINTED_RE = re.compile(r"#\s*checkpointed by:\s*([A-Za-z_]\w*)")
_ATTR_ASSIGN_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=[^=]")
_WRITE_MODE_CHARS = set("wax+")
# AdmissionController-style mutator verbs: a call like
# ``self.<marked>.note_outcome(...)`` counts as mutating the marked
# object (reads — export_state, tenant_view, quarantined_tenants — do
# not match)
_MUTATOR_RE = re.compile(r"^(admit|shed|note|set|restore|inc|observe|"
                         r"clear|pop|update|append)")
_REPLAY_ROOT_RE = re.compile(r"^_?(replay|restore_state)$")


def _marker_decls(model: ModuleModel,
                  marker_re: re.Pattern) -> Dict[str, str]:
    """Attribute declarations carrying ``marker_re``: attr name ->
    marker payload. The marker sits on the initializing assignment's
    own line or, when that line runs long, on the comment line directly
    above it."""
    out: Dict[str, str] = {}
    for i, line in enumerate(model.lines, start=1):
        attr = _ATTR_ASSIGN_RE.search(line)
        if not attr:
            continue
        m = marker_re.search(line)
        if not m and i >= 2:
            prev = model.lines[i - 2].strip()
            if prev.startswith("#"):
                m = marker_re.search(prev)
        if m:
            out[attr.group(1)] = m.group(1)
    return out


def _self_attr(expr: ast.AST) -> Optional[str]:
    """The attribute name at the base of a ``self.<attr>...`` chain
    (``self.admission._depth_gauge.set`` -> ``admission``), else None."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return expr.attr
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return None


def _durable_locals(func: ast.AST, durable_attrs: Set[str]) -> Set[str]:
    """Local names derived from a durable path attribute within
    ``func`` (``path = os.path.join(self.responses_dir, ...)``;
    ``tmp = f"{path}..."``). Two passes pick up one chained step."""
    local: Set[str] = set()

    def mentions(expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) \
                    and isinstance(sub.value, ast.Name) \
                    and sub.value.id == "self" \
                    and sub.attr in durable_attrs:
                return True
            if isinstance(sub, ast.Name) and sub.id in local:
                return True
        return False

    for _ in range(2):
        for node in _scoped_walk(func):
            if not isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                continue
            value = node.value
            if value is None or not mentions(value):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    local.add(t.id)
    return local


def _path_arg_durable(expr: ast.AST, durable_attrs: Set[str],
                      local: Set[str]) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "self" and sub.attr in durable_attrs:
            return True
        if isinstance(sub, ast.Name) and sub.id in local:
            return True
    return False


def _open_write_mode(call: ast.Call) -> Optional[str]:
    """The mode string of an ``open(...)`` call when it writes
    (contains w/a/x/+), else None. A non-constant mode is ignored —
    precision over recall."""
    if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
        return None
    mode: Optional[str] = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            mode = kw.value.value
    if mode and set(mode) & _WRITE_MODE_CHARS:
        return mode
    return None


def _callee_name(call: ast.Call,
                 functions: Dict[str, ast.AST]) -> Optional[str]:
    """Same-module callee of ``call``: a plain ``f(...)`` or a
    ``self.f(...)`` method call (SL103's edges plus the ``self.``
    form the engine's request path is written in)."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in functions:
        return fn.id
    if isinstance(fn, ast.Attribute) \
            and isinstance(fn.value, ast.Name) and fn.value.id == "self" \
            and fn.attr in functions:
        return fn.attr
    return None


def _call_edges(model: ModuleModel) -> Dict[str, Set[str]]:
    edges: Dict[str, Set[str]] = {}
    for name, func in model.functions.items():
        callees: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                callee = _callee_name(node, model.functions)
                if callee is not None:
                    callees.add(callee)
        edges[name] = callees
    return edges


def _reachable(start: str, edges: Dict[str, Set[str]]) -> Set[str]:
    seen = {start}
    frontier = [start]
    while frontier:
        for nxt in edges.get(frontier.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


class RawDurableWrite(Rule):
    """SL201 — a raw ``open(..., "w"/"a")`` targeting a path declared
    ``# durable: <family>``: the write skips the blessed helper's
    flush+fsync / tmp+rename contract, so a crash can tear a journal
    record or publish a truncated file. ``utils/atomicio.py`` is the
    one home for raw durable I/O."""

    id = "SL201"
    severity = "error"
    title = "raw write to a durable path outside utils/atomicio"
    hint = ("route the write through utils/atomicio (append_line for "
            "JSONL records, write_atomic/write_json_atomic for "
            "whole-file publishes); annotate a deliberate exception "
            "with `# sart-lint: disable=SL201` and a why-comment")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        durable = _marker_decls(model, _DURABLE_RE)
        if not durable:
            return
        attrs = set(durable)
        for func in model.functions.values():
            local = _durable_locals(func, attrs)
            for node in _scoped_walk(func):
                if not isinstance(node, ast.Call):
                    continue
                mode = _open_write_mode(node)
                if mode is None or not node.args:
                    continue
                if _path_arg_durable(node.args[0], attrs, local):
                    yield self.finding(
                        model, node,
                        f"raw `open(..., {mode!r})` on a `# durable:` "
                        "path (bypasses the atomicio flush+fsync/"
                        "atomic-rename contract)",
                    )


class ReplaceWithoutFsync(Rule):
    """SL202 — an ``os.replace`` publish in a function that opens its
    tmp file for writing but never fsyncs it: the rename can land while
    the data is still in the page cache, so a crash publishes a
    zero-length or torn "atomic" file (the exact hazard the engine's
    response publish carried before atomicio)."""

    id = "SL202"
    severity = "error"
    title = "os.replace publish without fsync on the tmp handle"
    hint = ("fsync the tmp file before the rename (or use "
            "utils/atomicio.write_atomic, which owns the ordering); "
            "advisory files may pass fsync=False there explicitly")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        for func in model.functions.values():
            replaces: List[ast.Call] = []
            has_open_w = False
            has_fsync = False
            for node in _scoped_walk(func):
                if not isinstance(node, ast.Call):
                    continue
                path = _attr_path(node.func) or ""
                if path == "os.replace":
                    replaces.append(node)
                elif path.rsplit(".", 1)[-1] == "fsync":
                    has_fsync = True
                elif _open_write_mode(node):
                    has_open_w = True
            if replaces and has_open_w and not has_fsync:
                yield self.finding(
                    model, replaces[0],
                    "`os.replace` publish in a function that writes its "
                    "tmp file without an fsync (a crash can publish a "
                    "truncated file)",
                )


class CommitOrderViolation(Rule):
    """SL203 — a response publish reachable BEFORE the ``completed``
    journal append in the same request-handler function. The completed
    marker is the exactly-once commit point; publishing the done
    response first means a crash between the two hands the submitter a
    result the journal will re-run (duplicate side effects). Only the
    handler that DIRECTLY appends the completed marker is checked —
    the serve loop legitimately publishes other requests' responses
    (replay, acceptance verdicts) before any given completion — and a
    callee that reaches both (publish *and* completed append) orders
    them internally and is checked there, not at its call site."""

    id = "SL203"
    severity = "error"
    title = "response publish ordered before the completed journal append"
    hint = ("append the `completed` marker (journal.completed) before "
            "publishing the done response; replay republishes from the "
            "journaled outcome if the crash lands between them")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        durable = _marker_decls(model, _DURABLE_RE)
        response_attrs = {a for a, fam in durable.items()
                          if "response" in fam.lower()}
        if not response_attrs:
            return
        edges = _call_edges(model)
        publishers = {
            name for name, func in model.functions.items()
            if self._publishes_response(func, response_attrs)
        }
        completers = {
            name for name, func in model.functions.items()
            if any(self._is_completed_append(n) for n in ast.walk(func)
                   if isinstance(n, ast.Call))
        }
        for name, func in model.functions.items():
            pubs: List[Tuple[int, ast.AST, str]] = []
            completed_lines: List[int] = []
            for node in _scoped_walk(func):
                if not isinstance(node, ast.Call):
                    continue
                if self._is_completed_append(node):
                    completed_lines.append(node.lineno)
                    continue
                callee = _callee_name(node, model.functions)
                if callee is None:
                    continue
                reach = _reachable(callee, edges)
                if reach & completers:
                    continue  # orders publish vs completed internally
                if reach & publishers:
                    pubs.append((node.lineno, node, callee))
            if not completed_lines:
                continue  # not the direct completed-append handler
            first_completed = min(completed_lines)
            for lineno, node, callee in pubs:
                if lineno < first_completed:
                    yield self.finding(
                        model, node,
                        f"response publish (via `{callee}`) at line "
                        f"{lineno} precedes the `completed` journal "
                        f"append at line {first_completed} — a crash "
                        "between them double-runs the request",
                    )

    @staticmethod
    def _publishes_response(func: ast.AST,
                            response_attrs: Set[str]) -> bool:
        local = _durable_locals(func, response_attrs)
        for node in _scoped_walk(func):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            path = _attr_path(node.func) or ""
            writer = (path.rsplit(".", 1)[-1] in
                      ("write_atomic", "write_json_atomic")
                      or _open_write_mode(node) is not None)
            if writer and _path_arg_durable(node.args[0],
                                            response_attrs, local):
                return True
        return False

    @staticmethod
    def _is_completed_append(call: ast.Call) -> bool:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return False
        recv = _attr_path(fn.value) or ""
        if "journal" not in recv.lower():
            return False
        if fn.attr == "completed":
            return True
        if fn.attr == "append" and call.args:
            first = call.args[0]
            if isinstance(first, ast.Constant) \
                    and first.value == "completed":
                return True
            if isinstance(first, ast.Name) \
                    and first.id == "MARKER_COMPLETED":
                return True
        return False


class ReplayNondeterminism(Rule):
    """SL204 — wall-clock, uuid, random, or unsorted-``os.listdir``
    dependence in a function reachable from ``_replay``/
    ``restore_state``. Replay's contract is that a restart re-derives
    the same state from the same durable bytes; nondeterminism there
    means two recoveries of the same crash disagree (and the crash-
    point model checker's invariants stop being checkable)."""

    id = "SL204"
    severity = "warning"
    title = "nondeterminism on a replay/restore path"
    hint = ("derive replay-side values from the journaled records "
            "(journal_unix, stored ids), sort directory listings, and "
            "annotate deliberate wall-clock use (age gates, publish "
            "stamps) with `# sart-lint: disable=SL204` and a why")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        roots = [n for n in model.functions
                 if _REPLAY_ROOT_RE.match(n)]
        if not roots:
            return
        edges = _call_edges(model)
        seen: Set[Tuple[int, int]] = set()
        for root in roots:
            for fname in _reachable(root, edges):
                func = model.functions.get(fname)
                if func is None:
                    continue
                for node in ast.walk(func):
                    if not isinstance(node, ast.Call):
                        continue
                    key = (node.lineno, node.col_offset)
                    if key in seen:
                        continue
                    what = self._nondeterministic(node)
                    if what:
                        seen.add(key)
                        yield self.finding(
                            model, node,
                            f"{what} on a path reachable from "
                            f"`{root}` (replay must re-derive the "
                            "same state from the same bytes)",
                        )

    @staticmethod
    def _nondeterministic(call: ast.Call) -> Optional[str]:
        path = _attr_path(call.func) or ""
        if path in ("time.time", "time.time_ns"):
            return f"wall-clock `{path}()`"
        head = path.split(".")[0] if path else ""
        if head == "uuid":
            return f"`{path}()`"
        if head == "random" or ".random." in f".{path}." \
                or path.rsplit(".", 1)[-1] == "default_rng":
            return f"RNG call `{path}()`"
        if path == "os.listdir":
            parent = getattr(call, "_sart_parent", None)
            if isinstance(parent, ast.Call) \
                    and isinstance(parent.func, ast.Name) \
                    and parent.func.id == "sorted":
                return None
            return "unsorted `os.listdir()` (filesystem order)"
        return None


class UncheckpointedMutation(Rule):
    """SL205 — a mutation of ``# checkpointed by: <func>`` state
    (quarantine/ladder/dedup/SLO families, the counted-outcome
    watermark) on a path with no ``<func>`` boundary after it: the
    mutation exists only in memory, so the next crash silently rolls it
    back (un-quarantining a noisy tenant, forgetting a counted
    outcome). The check follows same-module callers recursively — a
    boundary in the caller after the call site covers the callee."""

    id = "SL205"
    severity = "warning"
    title = "checkpointed-state mutation without a checkpoint boundary"
    hint = ("call the declared checkpoint function (`_save_state`) on "
            "the mutating path — locally or in every caller after the "
            "call site; annotate deliberate journal-backed exceptions "
            "with `# sart-lint: disable=SL205` and a why")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        decls = _marker_decls(model, _CHECKPOINTED_RE)
        if not decls:
            return
        callers = self._call_sites(model)
        for name, func in model.functions.items():
            if name == "__init__" or name in set(decls.values()):
                continue
            for node, attr, what in self._mutations(func, set(decls)):
                ckpt = decls[attr]
                if self._covered(model, callers, name, node.lineno,
                                 ckpt, set()):
                    continue
                yield self.finding(
                    model, node,
                    f"{what} mutates `self.{attr}` (checkpointed by "
                    f"`{ckpt}`) with no `{ckpt}` boundary on the path "
                    "— the next crash rolls it back",
                )

    @staticmethod
    def _mutations(func: ast.AST, attrs: Set[str]):
        """(node, attr, description) for mutations of marked attrs in
        ``func``: direct/aug/subscript assignment rooted at the attr,
        and mutator-verb method calls on it."""
        for node in _scoped_walk(func):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr in attrs:
                        yield node, attr, "assignment"
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                fn = node.func
                attr = _self_attr(fn.value)
                if attr in attrs and _MUTATOR_RE.match(fn.attr):
                    yield node, attr, f"`.{fn.attr}()`"

    @staticmethod
    def _call_sites(model: ModuleModel) -> Dict[str, List[Tuple[str, int]]]:
        """callee name -> [(caller name, call line)] over the same
        module (name calls and ``self.method()`` calls)."""
        sites: Dict[str, List[Tuple[str, int]]] = {}
        for caller, func in model.functions.items():
            for node in _scoped_walk(func):
                if isinstance(node, ast.Call):
                    callee = _callee_name(node, model.functions)
                    if callee is not None:
                        sites.setdefault(callee, []).append(
                            (caller, node.lineno))
        return sites

    def _covered(self, model: ModuleModel, callers, fname: str,
                 after_line: int, ckpt: str, visited: Set[str]) -> bool:
        # `visited` guards the CURRENT recursion path only (a cycle is
        # uncovered); sibling call sites each get their own branch, so
        # two sites in one caller are both judged on their own line
        if fname in visited:
            return False
        func = model.functions.get(fname)
        if func is None:
            return False
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and node.lineno > after_line \
                    and _callee_name(node, model.functions) == ckpt:
                return True
        sites = callers.get(fname, [])
        if not sites:
            return False  # e.g. a thread target: nobody checkpoints it
        return all(
            self._covered(model, callers, caller, line, ckpt,
                          visited | {fname})
            for caller, line in sites
        )


DURABILITY_RULES: Tuple[Rule, ...] = (
    RawDurableWrite(), ReplaceWithoutFsync(), CommitOrderViolation(),
    ReplayNondeterminism(), UncheckpointedMutation(),
)
