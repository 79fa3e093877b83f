"""AST lint rules for PyTorch hazards (``lint``).

Counterpart of ``sartsolver_tpu/analysis/rules.py``: the same machinery
(:class:`Finding`, :class:`ModuleModel`, the suppressions, :class:`Rule`,
:func:`lint_source`, :func:`lint_paths`) and the SL0xx family recast for
eager PyTorch. Each rule is a small class with a stable id, a default
severity and a fix hint; the engine parses each file once into a
:class:`ModuleModel` (import aliases, the hand kernels' wrappers, the
function table) that every rule reads.

- SL002: a host sync inside a loop (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()`` of a
  torch-produced value, ``torch.cuda.synchronize()``, a tensor's truth
  value as a ``while`` test);
- SL003: a torch constructor that takes the default dtype;
- SL006: a bare ``except:``, or ``except Exception`` around device code (a
  torch call, or a hand kernel's wrapper): the lint for "no fallback that
  hides the kernel";
- SL007: a dense product against the RTM outside the operator layer.

The JAX package's SL001, SL004 and SL005 (tracer control flow, buffer
donation, static arguments) have no meaning in eager PyTorch and are not in
:data:`ALL_RULES`. The SL1xx concurrency (``analysis/concurrency.py``) and
SL2xx durability (``analysis/durability.py``) families are.

These are heuristics tuned for precision over recall: a rule fires only
where the hazard is structurally explicit, so a clean run means something
and a finding can be acted on. Deliberate exceptions are annotated inline::

    risky_line()  # sart-lint: disable=SL002

(also accepted on the line above; ``disable=all`` silences every rule, and
``# sart-lint: disable-file=SL003`` in the first ten lines silences a rule
for the whole file). Every suppression carries a comment saying why, so
they stay auditable by grep.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

SEVERITIES = ("error", "warning", "info")

_SUPPRESS_RE = re.compile(r"#\s*sart-lint:\s*disable=([\w,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*sart-lint:\s*disable-file=([\w,]+)")

# torch constructors whose result takes the default dtype unless dtype= is
# given (dtype is keyword-only in each)
_DTYPE_CTORS = ("zeros", "ones", "full", "empty", "arange", "linspace")
# value-preserving converters: only a Python literal defaults its dtype (a
# numpy array or a tensor brings its own), so only literals are flagged;
# as_tensor also takes dtype as its second positional argument
_VALUE_CTORS = {"tensor": None, "as_tensor": 1}

# the hand kernels' wrappers (ops/fused_sweep.py, operators/implicit.py):
# device code for SL006 wherever they are imported
KERNEL_WRAPPERS = frozenset({
    "fused_sweep", "sharded_sweep_bp", "sharded_sweep_finish",
    "implicit_forward", "implicit_back", "sweep_fn",
})


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str  # "error" | "warning" | "info"
    path: str
    line: int
    col: int
    message: str
    hint: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.severity}: {self.message}")


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------


def _walk_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._sart_parent = node  # type: ignore[attr-defined]


def _parents(node: ast.AST) -> Iterator[ast.AST]:
    while True:
        node = getattr(node, "_sart_parent", None)
        if node is None:
            return
        yield node


def _root_name(expr: ast.AST) -> Optional[str]:
    """Base Name of an attribute/subscript/call chain (``a.b[0].c()``->a)."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            expr = expr.value
        elif isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        else:
            return None


def _attr_path(expr: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute chain (``torch.cuda.synchronize``),
    or None for anything more dynamic."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


class ModuleModel:
    """Everything the rules need from one parsed source file."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.tree = ast.parse(src, filename=path)
        _walk_parents(self.tree)
        self.lines = src.splitlines()

        # ---- suppressions ------------------------------------------------
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.line_suppressions[i] = set(m.group(1).split(","))
            if i <= 10:
                mf = _SUPPRESS_FILE_RE.search(line)
                if mf:
                    self.file_suppressions |= set(mf.group(1).split(","))

        # ---- import aliases ---------------------------------------------
        self.torch_aliases: Set[str] = set()  # import torch [as th]
        self.functional_aliases: Set[str] = set()  # torch.nn.functional
        self.kernel_names: Set[str] = set()  # the hand kernels' wrappers
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or (a.name.startswith("torch.") and not a.asname):
                        self.torch_aliases.add(a.asname or "torch")
                    elif a.name == "torch.nn.functional":
                        self.functional_aliases.add(a.asname)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    name = a.asname or a.name
                    if node.module == "torch.nn" and a.name == "functional":
                        self.functional_aliases.add(name)
                    elif a.name in KERNEL_WRAPPERS and (node.module or "").endswith(
                            ("ops.fused_sweep", "operators.implicit")):
                        self.kernel_names.add(name)

        # ---- function table ---------------------------------------------
        self.functions: Dict[str, ast.AST] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)

    # ---- shared queries --------------------------------------------------

    def torch_call_name(self, call: ast.Call) -> Optional[str]:
        """Function name of a ``torch.<name>(...)`` call, else None."""
        path = _attr_path(call.func)
        if path is None:
            return None
        head, _, tail = path.rpartition(".")
        return tail if head in self.torch_aliases else None

    def is_torch_call(self, call: ast.Call) -> bool:
        """A call rooted at torch (``torch.*``, ``F.*``): its result is a
        tensor or it runs on the tensors' device."""
        path = _attr_path(call.func)
        if path is None:
            return False
        head = path.split(".")[0]
        return (head in self.torch_aliases and "." in path) or head in self.functional_aliases

    def is_kernel_call(self, call: ast.Call) -> bool:
        """A call of a hand kernel's wrapper (imported by name, or the
        solver's ``self.sweep_fn``)."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id in self.kernel_names
        return isinstance(fn, ast.Attribute) and fn.attr in KERNEL_WRAPPERS

    def is_device_call(self, call: ast.Call) -> bool:
        """Device code: a torch call or a hand kernel's wrapper."""
        return self.is_torch_call(call) or self.is_kernel_call(call)

    def suppressed(self, rule_id: str, line: int) -> bool:
        if rule_id in self.file_suppressions or "all" in self.file_suppressions:
            return True
        for ln in (line, line - 1):
            sup = self.line_suppressions.get(ln)
            if sup and (rule_id in sup or "all" in sup):
                return True
        return False


def _scoped_walk(root: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that stays in ``root``'s scope: does not descend into
    nested function definitions or lambdas (they get their own pass)."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


class Rule:
    """Base class: subclasses define id/severity/title/hint and ``run``."""

    id: str = ""
    severity: str = "warning"
    title: str = ""
    hint: str = ""

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self, model: ModuleModel, node: ast.AST, message: str,
        severity: Optional[str] = None,
    ) -> Finding:
        return Finding(
            rule=self.id, severity=severity or self.severity,
            path=model.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message,
            hint=self.hint,
        )


class HostSyncInLoop(Rule):
    """SL002: a host sync on a device value inside a Python loop. ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()``
    of a torch-produced value, ``torch.cuda.synchronize()`` and a tensor's
    truth value as a ``while`` test each wait for the device's queue to
    drain, once per loop step, so the host cannot run ahead of the card."""

    id = "SL002"
    severity = "error"
    title = "host sync on device value inside a loop"
    hint = ("hoist the transfer out of the loop, batch the fetches, or keep "
            "the value on the device (torch.where); annotate the one flag a "
            "loop must read with a why")

    _CASTS = ("float", "int", "bool")
    _FETCHES = ("item", "tolist", "cpu", "numpy")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        funcs = [
            n for n in ast.walk(model.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module))
        ]
        for func in funcs:
            device = self._device_names(model, func)
            for node in _scoped_walk(func):
                if isinstance(node, ast.While) and self._is_device_expr(model, node.test,
                                                                        device, bare=True):
                    yield self.finding(model, node.test,
                                       "a tensor's truth value as a `while` test "
                                       "(implicit blocking transfer per step)")
                if not isinstance(node, ast.Call) or not self._in_loop(node, func):
                    continue
                msg = self._sync_message(model, node, device)
                if msg:
                    yield self.finding(model, node, msg)

    @staticmethod
    def _in_loop(node: ast.AST, scope: ast.AST) -> bool:
        for p in _parents(node):
            if p is scope:
                return False
            if isinstance(p, (ast.For, ast.While, ast.AsyncFor)):
                return True
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return False  # a nested def's body isn't run by this loop
        return False

    @staticmethod
    def _device_names(model: ModuleModel, func: ast.AST) -> Set[str]:
        """Names assigned (anywhere in the function) from an expression
        holding a torch call or a kernel wrapper's call, one step
        transitive."""
        device: Set[str] = set()
        for _ in range(2):  # two passes pick up x = torch...; y = x + 1
            for node in _scoped_walk(func):
                if not isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    continue
                value = node.value
                if value is None:
                    continue
                is_dev = any(
                    isinstance(sub, ast.Call) and model.is_device_call(sub)
                    for sub in ast.walk(value)
                ) or any(
                    isinstance(sub, ast.Name) and sub.id in device
                    for sub in ast.walk(value)
                )
                if not is_dev:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        device.add(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        for e in t.elts:
                            if isinstance(e, ast.Name):
                                device.add(e.id)
        return device

    @staticmethod
    def _is_device_expr(model: ModuleModel, expr: ast.AST, device: Set[str],
                        bare: bool = False) -> bool:
        """``expr`` holds a device value. ``bare``: ``expr`` is itself a
        truth test, so only a direct tensor (a device name, a torch call, a
        method or comparison on one) counts, not a ``bool()``/``and`` of it
        (those report through the call rule)."""
        if bare:
            if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
                expr = expr.operand
            if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
                return False  # bool(x), len(x): reported, or not a sync
            if isinstance(expr, ast.BoolOp):
                return False
        if any(isinstance(sub, ast.Call) and model.is_device_call(sub)
               for sub in ast.walk(expr)):
            return True
        root = _root_name(expr)
        return root is not None and root in device

    def _sync_message(self, model: ModuleModel, call: ast.Call,
                      device: Set[str]) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in self._FETCHES \
                and not call.args and self._is_device_expr(model, fn.value, device):
            return f"`.{fn.attr}()` on a device value inside a loop"
        if isinstance(fn, ast.Name) and fn.id in self._CASTS and call.args \
                and self._is_device_expr(model, call.args[0], device):
            return (f"`{fn.id}()` on a device value inside a loop "
                    "(implicit blocking transfer)")
        path = _attr_path(fn) or ""
        head, _, tail = path.rpartition(".")
        if tail == "synchronize" and head.split(".")[0] in model.torch_aliases:
            return f"`{path}()` inside a loop (waits for the device's queue)"
        return None


class ImplicitDtype(Rule):
    """SL003: a torch constructor that takes the default dtype. ``torch.zeros
    (n)`` is fp32 under the default dtype and something else the moment a
    caller changes it; the fp64 parity profile and the fp32 device profile
    must each say which they build."""

    id = "SL003"
    severity = "warning"
    title = "torch constructor without explicit dtype"
    hint = "pass dtype= explicitly (the solver's compute dtype, or the index dtype)"

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            name = model.torch_call_name(node)
            # dtype= given, or possibly inside a **kwargs mapping
            if name is None or any(kw.arg in ("dtype", None) for kw in node.keywords):
                continue
            if name in _DTYPE_CTORS:
                yield self.finding(model, node,
                                   f"`torch.{name}(...)` without an explicit dtype")
            elif name in _VALUE_CTORS and node.args:
                pos = _VALUE_CTORS[name]
                if pos is not None and len(node.args) > pos:
                    continue  # dtype passed positionally
                arg = node.args[0]
                literal = isinstance(arg, ast.Constant) or (
                    isinstance(arg, (ast.List, ast.Tuple)) and all(
                        isinstance(e, ast.Constant) for e in arg.elts))
                if literal:
                    yield self.finding(
                        model, node,
                        f"`torch.{name}()` of a Python literal without an explicit "
                        "dtype (takes the default dtype)")


class BroadExceptDeviceCode(Rule):
    """SL006: a bare ``except:`` (error), or ``except Exception``/``except
    BaseException`` whose try body runs device code, a torch call or a hand
    kernel's wrapper (warning). A kernel that fails to build, launch or
    agree must fail loudly; a broad handler turns it into a quiet fallback
    onto the plain version, or into a silently wrong result."""

    id = "SL006"
    severity = "error"
    title = "bare/broad except around device code"
    hint = ("catch the specific exceptions the device call raises, or "
            "re-raise after cleanup; annotate deliberate handlers (one that "
            "re-raises, a best-effort report) with a why")

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Try):
                continue
            body_has_device = any(
                isinstance(sub, ast.Call) and model.is_device_call(sub)
                for stmt in node.body for sub in ast.walk(stmt)
            )
            for handler in node.handlers:
                if handler.type is None:
                    yield self.finding(
                        model, handler,
                        "bare `except:` (swallows KeyboardInterrupt and every "
                        "device error)",
                    )
                elif body_has_device and isinstance(handler.type, ast.Name) \
                        and handler.type.id in ("Exception", "BaseException"):
                    yield self.finding(
                        model, handler,
                        f"`except {handler.type.id}` around device code "
                        "(swallows CUDA and kernel errors)",
                        severity="warning",
                    )


class DenseRtmContraction(Rule):
    """SL007: a dense product against the RTM (``rtm @ x``,
    ``torch.matmul(problem.rtm, ...)``, ``F.linear`` on an rtm-named
    operand) outside the operator layer (``ops/projection.py``,
    ``ops/fused_sweep.py``, ``ops/os_subsets.py`` and ``operators/``). New
    code routes its products through the projections, the fused sweep or an
    operator: a raw product bypasses the block-sparse column compaction and
    the hand kernel, so the sparse path silently turns dense."""

    id = "SL007"
    severity = "error"
    title = "dense RTM contraction outside the operator layer"
    hint = ("route the product through ops/projection.py (forward_project/"
            "back_project), the fused sweep (ops/fused_sweep.py) or an "
            "operator (operators/); annotate deliberate exceptions with "
            "sart-lint: disable=SL007 and a why")

    _ALLOWED_SUFFIXES = ("ops/fused_sweep.py", "ops/projection.py", "ops/os_subsets.py")
    _ALLOWED_DIRS = ("sartsolver_tpu_torch/operators/",)
    _MATMUL_FNS = ("matmul", "mm", "mv", "einsum", "linear")
    _RTM_NAME_RE = re.compile(r"(^|_)rtm($|_)", re.IGNORECASE)
    # rtm-prefixed metadata that is not the matrix (the int8 scale vector,
    # the dtype and name strings)
    _RTM_META_RE = re.compile(
        r"(^|_)rtm_(scale|dtype|name|names|stats|files|frame_masks)s?$",
        re.IGNORECASE,
    )

    def _names_rtm(self, ident: str) -> bool:
        return bool(self._RTM_NAME_RE.search(ident)
                    and not self._RTM_META_RE.search(ident)
                    and ident != "sparse_rtm")

    def _mentions_rtm(self, expr: ast.AST) -> bool:
        """True when the direct operand is the matrix: a Name or an
        attribute/subscript chain whose links name it (``rtm``,
        ``problem.rtm``, ``self.rtm.T``, ``rtm[0]``). A call's result (a
        projection of the operator layer) is not."""
        while isinstance(expr, (ast.Attribute, ast.Subscript)):
            if isinstance(expr, ast.Attribute) and self._names_rtm(expr.attr):
                return True
            expr = expr.value
        return isinstance(expr, ast.Name) and self._names_rtm(expr.id)

    def run(self, model: ModuleModel) -> Iterator[Finding]:
        path = model.path.replace("\\", "/")
        if any(path.endswith(sfx) for sfx in self._ALLOWED_SUFFIXES):
            return
        if any(d in path for d in self._ALLOWED_DIRS):
            return
        for node in ast.walk(model.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                if self._mentions_rtm(node.left) or self._mentions_rtm(node.right):
                    yield self.finding(
                        model, node,
                        "dense `@` contraction against the RTM outside the operator "
                        "layer (bypasses the sparse and fused dispatch)",
                    )
            elif isinstance(node, ast.Call):
                fn_path = _attr_path(node.func)
                if fn_path is None:
                    continue
                head, _, tail = fn_path.rpartition(".")
                is_matmul = tail in self._MATMUL_FNS and (
                    head in model.torch_aliases | model.functional_aliases)
                if is_matmul and any(self._mentions_rtm(a) for a in node.args):
                    yield self.finding(
                        model, node,
                        f"dense `{fn_path}` contraction against the RTM outside the "
                        "operator layer (bypasses the sparse and fused dispatch)",
                    )


TORCH_RULES: Tuple[Rule, ...] = (
    HostSyncInLoop(), ImplicitDtype(), BroadExceptDeviceCode(), DenseRtmContraction(),
)

# Filled in at the bottom of this module: TORCH_RULES plus the SL1xx and
# SL2xx families (their modules import the engine from here).
ALL_RULES: Tuple[Rule, ...] = TORCH_RULES


def lint_source(
    path: str, src: str, *,
    rules: Optional[Sequence[Rule]] = None,
    severity_overrides: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Lint one file's source; returns the unsuppressed findings in line
    order. ``severity_overrides`` maps rule id -> severity (or "off");
    ``rules=None`` runs the full catalogue."""
    if rules is None:
        rules = ALL_RULES
    overrides = severity_overrides or {}
    try:
        model = ModuleModel(path, src)
    except SyntaxError as err:
        return [Finding(
            rule="SL000", severity="error", path=path,
            line=err.lineno or 1, col=err.offset or 0,
            message=f"syntax error: {err.msg}", hint="fix the syntax error",
        )]
    except ValueError as err:  # e.g. a null byte in the source
        return [Finding(
            rule="SL000", severity="error", path=path, line=1, col=0,
            message=f"unparseable source: {err}",
            hint="fix or exclude the file",
        )]
    findings: List[Finding] = []
    for rule in rules:
        if overrides.get(rule.id) == "off":
            continue
        for f in rule.run(model):
            if model.suppressed(f.rule, f.line):
                continue
            sev = overrides.get(f.rule)
            if sev:
                f = dataclasses.replace(f, severity=sev)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(paths: Sequence[str], **kw) -> List[Finding]:
    """Lint files and directories (recursively, ``*.py``)."""
    import os

    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    findings: List[Finding] = []
    for f in sorted(set(files)):
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
        except (OSError, UnicodeDecodeError) as err:
            # one unreadable file must not end the whole run
            findings.append(Finding(
                rule="SL000", severity="error", path=f, line=1, col=0,
                message=f"unreadable source: {err}",
                hint="fix the encoding or exclude the file",
            ))
            continue
        findings.extend(lint_source(f, src, **kw))
    return findings


# ---- concurrency (SL101..) / durability (SL201..) families ---------------
# Imported last: both need Rule/ModuleModel/Finding from above.
from sartsolver_tpu_torch.analysis.concurrency import CONCURRENCY_RULES  # noqa: E402
from sartsolver_tpu_torch.analysis.durability import DURABILITY_RULES  # noqa: E402

ALL_RULES = TORCH_RULES + CONCURRENCY_RULES + DURABILITY_RULES
