"""Static analysis for the port: AST lint rules, the launch audit and the
crash-point model checker, surfaced as the ``lint`` subcommand
(:mod:`~sartsolver_tpu_torch.analysis.cli`).

Counterpart of ``sartsolver_tpu/analysis/``:

- :mod:`~sartsolver_tpu_torch.analysis.rules`: the AST lint (SL0xx for
  PyTorch hazards), with the SL1xx concurrency
  (:mod:`~sartsolver_tpu_torch.analysis.concurrency`) and SL2xx durability
  (:mod:`~sartsolver_tpu_torch.analysis.durability`) families;
- :mod:`~sartsolver_tpu_torch.analysis.audit`: the per-iteration launch
  audit of the registered hot entry points
  (:mod:`~sartsolver_tpu_torch.analysis.registry`), the twin of the XLA
  compile audit;
- :mod:`~sartsolver_tpu_torch.analysis.protocol`: the crash-point model
  checker of the serving engine's exactly-once protocol.
"""

from sartsolver_tpu_torch.analysis.registry import (  # noqa: F401
    AUDIT_REGISTRY,
    AuditEntry,
    register_audit_entry,
)
from sartsolver_tpu_torch.analysis.rules import (  # noqa: F401
    ALL_RULES,
    Finding,
    lint_paths,
    lint_source,
)
