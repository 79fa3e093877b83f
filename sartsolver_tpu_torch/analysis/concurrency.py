"""Concurrency lint rules (SL101-SL105) for the host-side threads.

Counterpart of ``sartsolver_tpu/analysis/concurrency.py``, rule for rule.
The host side runs a prefetch worker, an async writer, the watchdog
monitor, the serving engine's threads and signal handlers over a handful of
locked stores (the metrics registry, the trace buffer, the flight ring, the
fault registry, the integrity layer). These rules encode the lock
discipline that code relies on, so a violation fails ``lint`` instead of
becoming a rare deadlock in production. They complement the runtime
lock-order detector (``utils/locking.py``, ``SART_LOCK_DEBUG=1``): the lint
proves the written discipline, the detector catches what its heuristics
cannot see.

Conventions the rules read:

- ``# guarded by: self._lock`` on an attribute's initializing assignment
  declares it lock-protected; SL101 then checks every access.
- A method whose name ends in ``_locked`` asserts "caller holds the
  lock" and is exempt from SL101 (the callers are checked instead, at
  their call sites' own accesses).
- ``if <lock>.acquire(blocking=False):`` guards count as holding the
  lock inside the ``if`` body: the signal-context snapshot pattern.
- "Lock-ish" expressions are attribute paths whose last component
  contains ``lock`` (``self._lock``, ``_default_lock``); naming a lock
  anything else hides it from SL102/SL103.

SL102's blocking calls are the JAX rule's with the device syncs of PyTorch
in place of a JAX dispatch: ``torch.cuda.synchronize()``, ``.item()`` and
``.cpu()``. Like the SL0xx family these are precision-tuned heuristics:
single-file analysis, structurally explicit patterns only. SL103's call
graph is same-module (a cross-module handler chain needs the runtime
detector); SL104 only engages in modules that define a module-level lock.
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
    _parents,
    _scoped_walk,
)

_GUARDED_RE = re.compile(r"#\s*guarded by:\s*([A-Za-z_][\w.]*)")
_ATTR_ASSIGN_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=[^=]")


def _is_lockish(expr: ast.AST) -> Optional[str]:
    """Dotted path of ``expr`` when its last component names a lock
    (``self._lock``, ``_graph_lock``), else None."""
    path = _attr_path(expr)
    if path is None:
        return None
    last = path.rsplit(".", 1)[-1]
    return path if "lock" in last.lower() else None


def _with_lock_paths(node: ast.AST) -> List[str]:
    """Lock paths a ``with`` statement holds (empty for non-With)."""
    out: List[str] = []
    if isinstance(node, (ast.With, ast.AsyncWith)):
        for item in node.items:
            path = _is_lockish(item.context_expr)
            if path is not None:
                out.append(path)
    return out


def _acquire_guard_paths(node: ast.AST) -> List[str]:
    """Lock paths guarded by an ``if <lock>.acquire(...):`` test.

    Only the DIRECT form counts — the acquire call must BE the test
    expression. A negated test (``if not lock.acquire(...):``) selects
    its body on the *failed* acquire, and in a compound test (``if flag
    and lock.acquire():``) the call may not even evaluate — treating
    either body as lock-held would invert SL101/SL102 semantics."""
    out: List[str] = []
    if isinstance(node, ast.If):
        test = node.test
        if isinstance(test, ast.Call) and isinstance(test.func,
                                                     ast.Attribute) \
                and test.func.attr == "acquire":
            path = _is_lockish(test.func.value)
            if path is not None:
                out.append(path)
    return out


def _holds_lock(node: ast.AST, lock_path: str, scope: ast.AST) -> bool:
    """Whether ``node`` sits under a ``with <lock_path>`` (or an
    acquire-``if`` guard on it) within ``scope``. For the acquire-``if``
    form only the ``if`` BODY counts — the ``else`` branch is exactly
    the failed-acquire path, where the lock is NOT held."""
    prev: ast.AST = node
    for p in _parents(node):
        if lock_path in _with_lock_paths(p):
            return True
        if lock_path in _acquire_guard_paths(p) \
                and prev in getattr(p, "body", ()):
            return True
        if p is scope:
            return False
        prev = p
    return False


class GuardedByViolation(Rule):
    """SL101 — an attribute declared ``# guarded by: <lock>`` accessed
    outside a ``with`` on that lock (or an ``if <lock>.acquire(...)``
    guard). ``__init__`` and ``*_locked`` methods are exempt (happens-
    before publication; caller-holds-the-lock convention)."""

    id = "SL101"
    severity = "error"
    title = "guarded attribute accessed outside its declared lock"
    hint = ("wrap the access in `with <lock>:` (or an `if "
            "<lock>.acquire(blocking=False):` guard), move it into a "
            "`*_locked` helper, or annotate a deliberate lock-free read "
            "with `# sart-lint: disable=SL101` and a why-comment")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        for cls in model.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            guarded = self._declarations(model, cls)
            if not guarded:
                continue
            for func in ast.walk(cls):
                if not isinstance(func, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if func.name == "__init__" or func.name.endswith("_locked"):
                    continue
                if self._owning_class(func) is not cls:
                    continue  # a nested class's method: its own pass
                yield from self._check_method(model, cls, func, guarded)

    @staticmethod
    def _owning_class(func: ast.AST) -> Optional[ast.AST]:
        """The nearest enclosing ClassDef — declarations must not bleed
        across nested-class boundaries (`self` is a different object)."""
        for p in _parents(func):
            if isinstance(p, ast.ClassDef):
                return p
        return None

    @staticmethod
    def _declarations(model: ModuleModel,
                      cls: ast.ClassDef) -> Dict[str, str]:
        """``# guarded by:`` comments on attribute-initializing lines in
        the class body (nested classes' line spans excluded — their
        declarations belong to their own pass): attr name -> lock path."""
        nested = [
            (n.lineno, getattr(n, "end_lineno", n.lineno))
            for n in ast.walk(cls)
            if isinstance(n, ast.ClassDef) and n is not cls
        ]
        out: Dict[str, str] = {}
        end = getattr(cls, "end_lineno", None) or len(model.lines)
        for lineno in range(cls.lineno, min(end, len(model.lines)) + 1):
            if any(a <= lineno <= b for a, b in nested):
                continue
            line = model.lines[lineno - 1]
            m = _GUARDED_RE.search(line)
            if not m:
                continue
            attr = _ATTR_ASSIGN_RE.search(line)
            if attr:
                out[attr.group(1)] = m.group(1)
        return out

    def _check_method(self, model, cls, func, guarded) -> Iterator[Finding]:
        # _scoped_walk: a nested function is its own pass (it appears in
        # ast.walk(cls) and reports under its own name) — descending
        # here would report the same access twice
        for node in _scoped_walk(func):
            if not isinstance(node, ast.Attribute):
                continue
            if not (isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                continue
            lock_path = guarded.get(node.attr)
            if lock_path is None:
                continue
            if _holds_lock(node, lock_path, func):
                continue
            yield self.finding(
                model, node,
                f"`self.{node.attr}` is declared guarded by `{lock_path}` "
                f"but `{cls.name}.{func.name}` accesses it without "
                "holding that lock",
            )


class BlockingCallUnderLock(Rule):
    """SL102 — a blocking call inside a lock body: queue get/put,
    ``Thread.join``, file/HDF5 I/O, ``time.sleep``, a device sync
    (``torch.cuda.synchronize()``, ``.item()``, ``.cpu()``). Every
    waiter on that lock now waits on the slow operation too — and if the
    blocking call itself needs the lock's owner to progress (a worker
    that must take the lock to drain the queue), it is a deadlock."""

    id = "SL102"
    severity = "warning"
    title = "blocking call while holding a lock"
    hint = ("move the blocking work outside the `with <lock>:` body "
            "(copy state out under the lock, then operate); annotate a "
            "deliberate hold (e.g. a serialize-the-build latch) with a "
            "why-comment")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        seen: Set[Tuple[int, int]] = set()  # one finding per call site,
        # however many locks are nested around it
        for node in model.nodes:
            locks = _with_lock_paths(node)
            if locks:
                held, roots = f"with {locks[0]}:", [node]
            else:
                # the acquire-`if` guard form holds the lock in the `if`
                # BODY only (the else branch is the failed acquire);
                # blocking work there convoys waiters just like a `with`
                locks = _acquire_guard_paths(node)
                if not locks:
                    continue
                held, roots = f"if {locks[0]}.acquire(...):", list(node.body)
            for root in roots:
                for sub in _scoped_walk(root):
                    if not isinstance(sub, ast.Call):
                        continue
                    key = (sub.lineno, sub.col_offset)
                    if key in seen:
                        continue
                    what = self._blocking_kind(model, sub)
                    if what:
                        seen.add(key)
                        yield self.finding(
                            model, sub,
                            f"{what} inside `{held}`",
                        )

    @staticmethod
    def _blocking_kind(model: ModuleModel, call: ast.Call) -> Optional[str]:
        fn = call.func
        path = _attr_path(fn) or ""
        if path == "time.sleep":
            return "`time.sleep()`"
        if isinstance(fn, ast.Name) and fn.id == "open":
            return "file `open()`"
        if path.endswith("h5py.File") or path.startswith("h5py."):
            return f"HDF5 call `{path}()`"
        if isinstance(fn, ast.Attribute):
            recv = _attr_path(fn.value) or ""
            if fn.attr == "join" and "thread" in recv.lower():
                return f"`{recv}.join()`"
            if fn.attr in ("get", "put") and "queue" in recv.lower():
                return f"queue `.{fn.attr}()` on `{recv}`"
            if fn.attr in ("item", "cpu") and not call.args:
                return f"`.{fn.attr}()` (device sync)"
        if path.rsplit(".", 1)[-1] == "synchronize" \
                and path.split(".")[0] in model.torch_aliases:
            return f"`{path}()` (device sync)"
        return None


class SignalHandlerLock(Rule):
    """SL103 — a blocking lock acquire reachable (same module) from a
    function registered via ``signal.signal``. A handler runs between
    bytecodes of the main thread; if the interrupted bytecode holds that
    lock, the blocking acquire waits on an owner that cannot run until
    the handler returns — a guaranteed self-deadlock, the exact hazard
    the SIGUSR1 status snapshot had before its non-blocking rewrite."""

    id = "SL103"
    severity = "error"
    title = "blocking lock acquire reachable from a signal handler"
    hint = ("use a non-blocking acquire with a stale-state fallback "
            "(`if lock.acquire(blocking=False): ... else: <stale>`), or "
            "only set a flag in the handler and do the work at a poll "
            "point")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        handlers = self._registered_handlers(model)
        if not handlers:
            return
        edges = self._call_edges(model)
        seen: Set[Tuple[int, int]] = set()
        for handler_name, reg_line in handlers:
            for fname in self._reachable(handler_name, edges):
                func = model.functions.get(fname)
                if func is None:
                    continue
                for node, what in self._blocking_acquires(func):
                    key = (node.lineno, node.col_offset)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield self.finding(
                        model, node,
                        f"{what} is reachable from signal handler "
                        f"`{handler_name}` (registered at line "
                        f"{reg_line}); a signal landing while the lock "
                        "is held self-deadlocks",
                    )

    @staticmethod
    def _registered_handlers(model: ModuleModel) -> List[Tuple[str, int]]:
        # resolve the stdlib `signal` module's aliases from the imports
        # (like ModuleModel does for jax): a user-defined or pubsub-style
        # `signal(name, receiver)` helper must not turn every receiver
        # into a "signal handler" with error-severity findings
        mod_aliases: Set[str] = set()
        func_aliases: Set[str] = set()
        for node in model.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "signal":
                        mod_aliases.add(a.asname or "signal")
            elif isinstance(node, ast.ImportFrom) and node.module == "signal":
                for a in node.names:
                    if a.name == "signal":
                        func_aliases.add(a.asname or "signal")
        out: List[Tuple[str, int]] = []
        for node in model.nodes:
            if not isinstance(node, ast.Call) or len(node.args) < 2:
                continue
            fn = node.func
            is_reg = (
                isinstance(fn, ast.Attribute) and fn.attr == "signal"
                and _attr_path(fn.value) in mod_aliases
            ) or (
                isinstance(fn, ast.Name) and fn.id in func_aliases
            )
            if not is_reg:
                continue
            target = node.args[1]
            if isinstance(target, ast.Name) \
                    and target.id in model.functions:
                out.append((target.id, node.lineno))
        return out

    @staticmethod
    def _call_edges(model: ModuleModel) -> Dict[str, Set[str]]:
        edges: Dict[str, Set[str]] = {}
        for name, func in model.functions.items():
            callees: Set[str] = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in model.functions:
                    callees.add(node.func.id)
            edges[name] = callees
        return edges

    @staticmethod
    def _reachable(start: str, edges: Dict[str, Set[str]]) -> Set[str]:
        seen = {start}
        frontier = [start]
        while frontier:
            for nxt in edges.get(frontier.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    @staticmethod
    def _blocking_acquires(func: ast.AST):
        """(node, description) pairs for blocking lock acquisition in
        ``func``: ``with <lock>`` bodies and blocking ``.acquire()``
        calls (no ``blocking=False`` / positional ``False``)."""
        for node in ast.walk(func):
            for path in _with_lock_paths(node):
                yield node, f"`with {path}:`"
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                path = _is_lockish(node.func.value)
                if path is None:
                    continue
                nonblocking = any(
                    isinstance(a, ast.Constant) and a.value is False
                    for a in node.args[:1]
                ) or any(
                    kw.arg == "blocking" and isinstance(kw.value,
                                                       ast.Constant)
                    and kw.value.value is False
                    for kw in node.keywords
                )
                if not nonblocking:
                    yield node, f"blocking `{path}.acquire()`"


class GlobalMutationWithoutLock(Rule):
    """SL104 — a module global rebound (``global X; X = ...``) outside
    the module's lock, in a module that *has* a module-level lock. The
    lock's existence declares the module's globals shared; a rebind that
    skips it races every reader the lock was protecting. Modules with no
    module-level lock are exempt (single-threaded or deliberately
    lock-free, like the watchdog's beacon tuple)."""

    id = "SL104"
    severity = "warning"
    title = "module global rebound outside the module lock"
    hint = ("rebind under `with <module lock>:` (double-checked reads "
            "stay lock-free); annotate a deliberately unlocked rebind "
            "with a why-comment")

    _LOCK_CTORS = ("Lock", "RLock", "named_lock")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        locks = self._module_locks(model)
        if not locks:
            return
        module_names = self._module_globals(model)
        # _scoped_walk throughout: a nested function is its own scope —
        # its same-named locals are not globals (no false positive), and
        # its own `global` rebinds are reported once, from its own entry
        # in model.functions (no duplicate from the enclosing pass)
        for func in model.functions.values():
            declared: Set[str] = set()
            for node in _scoped_walk(func):
                if isinstance(node, ast.Global):
                    declared.update(node.names)
            if not declared:
                continue
            targets = declared & module_names
            for node in _scoped_walk(func):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    node_targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in node_targets:
                        if isinstance(t, ast.Name) and t.id in targets \
                                and not self._under_any(node, locks, func):
                            yield self.finding(
                                model, node,
                                f"module global `{t.id}` rebound outside "
                                f"`with {sorted(locks)[0]}:` in a module "
                                "with a module-level lock",
                            )

    def _module_locks(self, model: ModuleModel) -> Set[str]:
        locks: Set[str] = set()
        for node in model.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                path = _attr_path(node.value.func) or ""
                if path.rsplit(".", 1)[-1] in self._LOCK_CTORS:
                    locks.add(node.targets[0].id)
        return locks

    @staticmethod
    def _module_globals(model: ModuleModel) -> Set[str]:
        names: Set[str] = set()
        for node in model.tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    @staticmethod
    def _under_any(node: ast.AST, locks: Set[str], scope: ast.AST) -> bool:
        return any(_holds_lock(node, lock, scope) for lock in locks)


class ThreadWithoutDaemon(Rule):
    """SL105 — ``threading.Thread(...)`` without an explicit ``daemon=``
    and no watchdog registration in the creating scope. An implicit
    non-daemon worker silently blocks interpreter exit (the killdrill /
    graceful-stop paths hang on join-at-exit), and a thread the watchdog
    cannot interrupt is invisible to the stage-2 escalation sweep."""

    id = "SL105"
    severity = "warning"
    title = "Thread without explicit daemon= or watchdog registration"
    hint = ("pass daemon= explicitly (a conscious lifetime choice), "
            "and register long-lived workers with "
            "watchdog.register_interruptible so the stage-2 sweep can "
            "reach them")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        for node in model.nodes:
            if not isinstance(node, ast.Call):
                continue
            path = _attr_path(node.func) or ""
            is_thread = path.endswith("threading.Thread") or (
                isinstance(node.func, ast.Name)
                and node.func.id == "Thread"
            )
            if not is_thread:
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            if self._scope_registers(node):
                continue
            yield self.finding(
                model, node,
                "`threading.Thread(...)` without an explicit `daemon=` "
                "(and no watchdog registration in this scope)",
            )

    @staticmethod
    def _scope_registers(node: ast.AST) -> bool:
        scope: Optional[ast.AST] = None
        for p in _parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = p
                break
        if scope is None:
            return False
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Call):
                path = _attr_path(sub.func) or ""
                if path.rsplit(".", 1)[-1] == "register_interruptible":
                    return True
        return False


CONCURRENCY_RULES: Tuple[Rule, ...] = (
    GuardedByViolation(), BlockingCallUnderLock(), SignalHandlerLock(),
    GlobalMutationWithoutLock(), ThreadWithoutDaemon(),
)
