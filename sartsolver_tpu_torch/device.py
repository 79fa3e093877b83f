"""Device selection for every public entry point of the package.

Entry points take ``device=`` and default to ``"cuda"``. Without a CUDA
device they raise instead of carrying on on the CPU: a CPU run is asked for
explicitly (``device="cpu"``, ``--device cpu`` or ``--use_cpu``).

Resolving a CUDA device also turns TF32 off for float32 matrix products and
convolutions: the out-of-loop projections (initial guess, log-variant
``obs``, setup ``H f``) must be full fp32 to agree with the reference.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available. Pass device=\"cpu\" (the CLI: "
                "--device cpu, or --use_cpu for the fp64 profile) to run on "
                "the CPU."
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}; use 'cuda' or 'cpu'.")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise if any given tensor does not live on ``device``."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} lives on {t.device}, but device={device} was asked "
                "for; build the problem on the same device."
            )
