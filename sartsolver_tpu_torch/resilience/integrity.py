"""End-to-end numerical integrity: ABFT checks, ingest digests, SDC policy.

Counterpart of ``sartsolver_tpu/resilience/integrity.py``: the same
tolerances, digests and escalation, on host values (numpy) and — for the
ingest's ray stats — on the stored matrix's rows where they lie.

Silent data corruption announces itself with no exception, hang or
non-finite value: a flipped bit in the device-resident RTM, a torn read of
an RTM stripe or a bad product gives a finite, merely wrong solution, which
then warm-starts every following frame. Three mechanisms detect it, all off
by default (``SolverOptions.integrity`` / ``--integrity`` /
``SART_INTEGRITY=1``; off, the solve and the ingest are the same as without
the layer):

1. **In-solve ABFT** (``models/sart.py``): ``sum(H f) == rho . f`` (rho the
   ray density, the column sums) and ``sum(H^T w) == lambda . w`` (lambda
   the ray length, the row sums) hold exactly for the stored matrix and any
   vector. Each iteration compares the first on the fused sweep's output
   ``fitted`` (the Hopper kernel's own product) and, on the two-matmul
   path, the second on the back projection, against
   :func:`abft_tolerance`.
2. **Ingest double reads**: with the layer on every RTM row chunk is read
   twice and the two reads compared (byte for byte; the JAX package
   compares their :func:`stripe_digest`); a mismatch raises
   :class:`StripeDigestError` (:func:`digest_mismatch`) inside the ingest's
   retry policy, and the chunk is read again. After the upload the solver's
   rho/lambda are held against sums the ingest accumulated over the stored
   values (:class:`IngestStats`, :func:`verify_ray_stats`).
3. **Resident re-audit**: rho/lambda recomputed from the resident matrix
   every ``SART_INTEGRITY_REAUDIT`` frames (default 64) and compared bit for
   bit with the upload-time snapshot
   (``DistributedSARTSolver.reaudit_ray_stats``).

Escalation (:class:`SdcEscalation`): a detected frame is re-solved once,
through the same kernel and plan; a frame that trips again is written
FAILED (status -3, the run goes on, exit 2); once
``SART_SDC_ABORT_THRESHOLD`` frames (default 2) failed so — or a re-audit or
the post-upload check mismatches — the run stops with
:class:`~sartsolver_tpu_torch.resilience.failures.PersistentCorruptionError`
(exit 3, the file resumable) after a quarantine event.

Telemetry: ``sdc_detected_total``, ``integrity_recomputes_total`` and
``stripe_digest_mismatch_total``.
"""

from __future__ import annotations

import math
import os
import zlib
from typing import List, Optional

import numpy as np

from sartsolver_tpu_torch.resilience.failures import (  # noqa: F401 (re-exported)
    IntegrityError,
    PersistentCorruptionError,
)
from sartsolver_tpu_torch.utils.locking import named_lock

#: the one diagnostic of a reproduced in-solve detection, whichever loop hit it
SDC_REPRODUCED = (
    "silent data corruption detected in-solve and reproduced "
    "by the recompute"
)


class StripeDigestError(OSError):
    """The two reads of one RTM row chunk disagreed byte for byte: a torn or
    corrupted read. An ``OSError``, so the ``hdf5.rtm_ingest`` retry policy
    reads the chunk again."""


_state = {"enabled": None}  # None: not configured, read SART_INTEGRITY
_lock = named_lock("resilience.integrity")


def configure(enabled: bool) -> None:
    """Set the process-wide ingest-integrity switch (the CLI's
    ``--integrity``; the in-solve check is per ``SolverOptions``)."""
    with _lock:
        _state["enabled"] = bool(enabled)


def env_enabled() -> bool:
    """The ``SART_INTEGRITY`` switch alone (``1``, ``true`` or ``on``)."""
    return os.environ.get("SART_INTEGRITY", "") in ("1", "true", "on")


def enabled() -> bool:
    """Whether ingest-side integrity (the double reads) is on: the
    :func:`configure` setting, else ``SART_INTEGRITY``."""
    val = _state["enabled"]
    return env_enabled() if val is None else val


def abft_tolerance(compute_dtype, rtm_dtype: Optional[str], npixel: int,
                   nvoxel: int) -> float:
    """Relative tolerance of the in-solve ABFT residual: ``64 eps
    sqrt(P + V + 1)``, times 4 for bf16 and int8 storage — the JAX
    package's band (the square-root law of blocked sums of non-negative
    products, with a 64x margin)."""
    eps = float(np.finfo(np.dtype(str(compute_dtype))).eps)
    factor = 4.0 if rtm_dtype in ("bfloat16", "int8") else 1.0
    return 64.0 * factor * eps * math.sqrt(float(npixel + nvoxel) + 1.0)


def stripe_digest(array: np.ndarray) -> int:
    """CRC32 of an array's bytes (contiguous C layout)."""
    return zlib.crc32(np.ascontiguousarray(array).tobytes()) & 0xFFFFFFFF


def digest_mismatch(what: str) -> None:
    """Count a double-read mismatch (``stripe_digest_mismatch_total``) and
    raise :class:`StripeDigestError`, which the retry policy takes."""
    from sartsolver_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.get_registry().counter("stripe_digest_mismatch_total").inc()
    raise StripeDigestError(
        f"{what} read twice with different bytes (torn or corrupted read); retrying")


def _bf16_round(values: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bfloat16 (nearest, ties to even), as fp32."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32)
    rounded = bits + (np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1)))
    # NaN stays NaN (its payload's top bit kept)
    rounded = np.where(np.isnan(values), bits | np.uint32(0x00400000), rounded)
    return (rounded & np.uint32(0xFFFF0000)).view(np.float32)


def storage_round(values: np.ndarray, rtm_dtype) -> np.ndarray:
    """fp64 view of ``values`` after rounding through the stored dtype
    (fp32, bf16 or fp64) — what the device's ray-stat reductions sum."""
    name = "float32" if rtm_dtype is None else str(rtm_dtype)
    if name == "bfloat16":
        return _bf16_round(np.asarray(values, np.float32)).astype(np.float64)
    return np.asarray(values, np.dtype(name)).astype(np.float64)


class IngestStats:
    """rho/lambda accumulated during the chunked ingest over the stored
    values (storage-rounded, or dequantized int8 codes).

    ``add(values, r0, c0)`` takes one block of the matrix at offset ``(r0,
    c0)``; every element is added once. ``values`` is a numpy array (the
    sums run on the host in fp64) or a tensor (the sums run where it lies,
    in fp64, and :meth:`finish` brings them to the host). The absolute sums
    scale :func:`verify_ray_stats`' band."""

    def __init__(self, npixel: int, nvoxel: int):
        self.npixel, self.nvoxel = int(npixel), int(nvoxel)
        self.colsum = np.zeros(nvoxel, np.float64)
        self.rowsum = np.zeros(npixel, np.float64)
        self.colabs = np.zeros(nvoxel, np.float64)
        self.rowabs = np.zeros(npixel, np.float64)
        self._dev = None  # the device accumulators, where tensors were added

    def add(self, values, r0: int, c0: int) -> None:
        if not isinstance(values, np.ndarray):
            self._add_tensor(values, r0, c0)
            return
        v = np.asarray(values, np.float64)
        n, m = v.shape
        self.colsum[c0:c0 + m] += v.sum(axis=0)
        self.rowsum[r0:r0 + n] += v.sum(axis=1)
        av = np.abs(v)
        self.colabs[c0:c0 + m] += av.sum(axis=0)
        self.rowabs[r0:r0 + n] += av.sum(axis=1)

    def _add_tensor(self, values, r0: int, c0: int) -> None:
        import torch

        if self._dev is None:
            kw = dict(dtype=torch.float64, device=values.device)
            self._dev = [torch.zeros(self.nvoxel, **kw), torch.zeros(self.npixel, **kw),
                         torch.zeros(self.nvoxel, **kw), torch.zeros(self.npixel, **kw)]
        col, row, cabs, rabs = self._dev
        v = values.to(torch.float64)
        n, m = v.shape
        col[c0:c0 + m] += v.sum(dim=0)
        row[r0:r0 + n] += v.sum(dim=1)
        v.abs_()
        cabs[c0:c0 + m] += v.sum(dim=0)
        rabs[r0:r0 + n] += v.sum(dim=1)

    def finish(self) -> "IngestStats":
        """Fold the device sums into the host arrays (one copy each)."""
        if self._dev is not None:
            for host, dev in zip((self.colsum, self.rowsum, self.colabs, self.rowabs),
                                 self._dev):
                host += dev.cpu().numpy()
            self._dev = None
        return self


def verify_ray_stats(stats: IngestStats, ray_density: np.ndarray,
                     ray_length: np.ndarray, *, rtm_dtype: Optional[str] = None
                     ) -> List[str]:
    """The solver's rho/lambda against the ingest's sums: a description of
    each mismatch (empty: verified). The band is relative to the absolute
    column/row mass and grows with the reduction length as the device's
    fp32 sums' error does: ``max(floor, 32 eps32 sqrt(n + 1))``, the floor
    1e-4 (1e-3 for int8)."""
    stats.finish()
    floor = 1e-3 if rtm_dtype == "int8" else 1e-4
    eps32 = float(np.finfo(np.float32).eps)
    out: List[str] = []
    for name, host, habs, dev, length in (
        ("ray_density", stats.colsum, stats.colabs,
         np.asarray(ray_density, np.float64)[: stats.nvoxel], stats.npixel),
        ("ray_length", stats.rowsum, stats.rowabs,
         np.asarray(ray_length, np.float64)[: stats.npixel], stats.nvoxel),
    ):
        rel = max(floor, 32.0 * eps32 * math.sqrt(float(length) + 1.0))
        err = np.abs(host - dev)
        bad = err > rel * (habs + 1.0)
        if bad.any():
            worst = int(np.argmax(err / (habs + 1.0)))
            out.append(
                f"{name}: {int(bad.sum())} element(s) beyond the "
                f"{rel:g}-relative band (worst at index {worst}: host "
                f"{host[worst]:.9g} vs device {dev[worst]:.9g})")
    return out


class SdcEscalation:
    """Host-side escalation of in-solve SDC detections: re-solve once, then
    a FAILED row, then a quarantine abort after ``SART_SDC_ABORT_THRESHOLD``
    terminal frames (default 2). ``summary`` (a
    :class:`~sartsolver_tpu_torch.resilience.failures.RunSummary`) counts
    the detections and recomputes too. The three integrity counters are
    registered at zero up front, so an artifact tells "nothing detected"
    from "layer off"."""

    def __init__(self, *, on_event=None, abort_threshold: Optional[int] = None,
                 summary=None):
        from sartsolver_tpu_torch.obs import metrics as obs_metrics

        registry = obs_metrics.get_registry()
        self._detected = registry.counter("sdc_detected_total")
        self._recomputes = registry.counter("integrity_recomputes_total")
        registry.counter("stripe_digest_mismatch_total")
        self._on_event = on_event
        self._summary = summary
        self._terminal = 0
        self._terminal_times: List[float] = []
        self.threshold = (int(os.environ.get("SART_SDC_ABORT_THRESHOLD", "2"))
                          if abort_threshold is None else int(abort_threshold))

    def _event(self, message: str) -> None:
        if self._on_event is not None:
            self._on_event(message)

    def detected(self, n: int = 1) -> None:
        """Record n in-solve SDC detections (before escalation)."""
        self._detected.inc(n)
        if self._summary is not None:
            self._summary.record_sdc(detected=n)

    def note_recompute(self, n_frames: int = 1) -> None:
        """A detected frame (or group) is being re-solved once."""
        self._recomputes.inc(n_frames)
        if self._summary is not None:
            self._summary.record_sdc(recomputed=n_frames)

    def record_terminal(self, frame_time: float) -> None:
        """A frame stayed corrupt through its recompute (a FAILED row);
        raises :class:`PersistentCorruptionError` at the threshold."""
        self._terminal += 1
        self._terminal_times.append(float(frame_time))
        if self.threshold > 0 and self._terminal >= self.threshold:
            shown = ", ".join(f"{t:g}" for t in self._terminal_times[:8])
            if self._terminal > 8:
                shown += ", ..."
            msg = (f"quarantine: {self._terminal} frame(s) failed their SDC "
                   f"recompute (t = {shown}; persistent silent data "
                   "corruption — resident matrix or device state); aborting "
                   "the session")
            self._event(msg)
            raise PersistentCorruptionError(msg)

    def resident_failure(self, detail: str) -> None:
        """A resident re-audit or the post-upload check mismatched:
        quarantine at once, no recompute can help."""
        msg = f"quarantine: resident integrity verification failed ({detail})"
        self._event(msg)
        raise PersistentCorruptionError(msg)
