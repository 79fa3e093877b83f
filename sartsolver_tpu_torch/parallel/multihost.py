"""The chunked RTM ingest: row chunks from the files into a device buffer.

Counterpart of the one-process side of ``sartsolver_tpu/parallel/multihost.py``
(named after it, so a reader finds one from the other): the JAX module's
``mesh`` becomes an explicit ``device``, and the striped multi-process read
and its ``serialize=`` turns come with the multi-GPU slice.

- :func:`read_and_shard_rtm` streams the matrix into a buffer of the stored
  dtype (fp32, bf16, or fp64 on the CPU), allocated on the device with
  ``torch.empty`` and never assembled on the host;
- :func:`read_and_quantize_rtm` is the two-pass int8 ingest: pass 1 takes
  the column maxima, pass 2 quantizes each chunk into the 1-byte codes;
- :func:`_read_stripe_retried` reads one row chunk under the
  ``hdf5.rtm_ingest`` retry policy and counts its bytes in
  ``bytes_ingested_total{source="rtm"}``.

Each pass reads ``SART_INGEST_CHUNK_ROWS`` rows at a time (default the
JAX package's ``(256 << 20) // (4 V)``: 256 MB of fp32) into one of two
host staging buffers (one where the pass has one chunk), reused across
chunks: pinned on the card, so the upload is a non-blocking copy on a side
stream; torch's pinned-memory cache keeps them for the next pass. A reader thread fills the
next buffer while the current one uploads (``SART_INGEST_PREFETCH``: 1 on,
0 off; default on where the host has more than one core); a buffer is
refilled only once its upload has finished. So the host holds at most two
fp32 chunks of the matrix (and the sparse segments' cache,
``io/raytransfer.py``), and the device the stored matrix plus one fp32
chunk, the staging of the bf16 rounding and of both int8 passes. Those run
on the device on the uploaded fp32 chunk: bf16 rounds to nearest even (the
host's rounding, bit for bit); int8 takes ``amax |x|`` per column, then
``clip(rint(x / s), -127, 127)``, fp32 division and half-to-even rounding
being correctly rounded on both, so the codes equal the JAX package's host
codes byte for byte. On the CPU (``device="cpu"``, the tests' plain
version and the fp64 profile) the same passes run with plain host buffers.
Nothing gives way: a failed pinned allocation or stream fails the ingest.

With the integrity layer on (``resilience/integrity.py:enabled``) each row
chunk is read twice, the second time into a third host buffer, and the two
reads compared byte for byte (the JAX package compares their CRC32s; the
direct comparison sees every mismatch those see, at memory speed): a
mismatch is a ``StripeDigestError`` (an ``OSError``), which the retry
policy answers by reading the chunk again. ``ingest_stats=`` (an
``IngestStats``) takes the ray stats' sums over the stored rows where they
lie (fp64 sums on the card; for int8 the dequantized codes). Each chunk
read is a hang-watchdog ``prefetch`` beacon.

Each pass is an ``ingest.pass`` trace span (``what=`` ``store``,
``colmax`` or ``quantize``). ``timings=`` (a dict) receives each pass's
seconds, its read seconds (the reader's), its upload seconds (the side
stream's copies, by CUDA events) and its chunk count.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sartsolver_tpu_torch.device import resolve_device
from sartsolver_tpu_torch.io.raytransfer import read_rtm_block
from sartsolver_tpu_torch.obs import metrics as obs_metrics
from sartsolver_tpu_torch.obs import trace as obs_trace

# the JAX package's pixel-row alignment, the chunk's lower bound
ROW_ALIGN = 8


def default_chunk_rows(nvoxel: int) -> int:
    """``SART_INGEST_CHUNK_ROWS``, else 256 MB of fp32 rows."""
    return int(os.environ.get("SART_INGEST_CHUNK_ROWS",
                              max(ROW_ALIGN, (256 << 20) // max(nvoxel * 4, 1))))


def prefetch_enabled() -> bool:
    """``SART_INGEST_PREFETCH`` (1 or 0), else on with more than one core."""
    env = os.environ.get("SART_INGEST_PREFETCH", "")
    return (env == "1") if env else (os.cpu_count() or 1) > 1


def _read_stripe_retried(sorted_matrix_files, rtm_name, n, nvoxel, r0,
                         check_out: Optional[np.ndarray] = None, **kwargs) -> np.ndarray:
    """One RTM row chunk read as fp32 under the ``hdf5.rtm_ingest`` retry
    policy. The read is idempotent (it fills its buffer whole), so a
    transient I/O failure costs one backoff, not the ingest; exhaustion
    raises ``RetriesExhausted`` (the CLI's infrastructure exit). ``nan`` and
    ``corrupt`` faults perturb the chunk read. With the integrity layer on
    the chunk is read twice (the second time into ``check_out``, a buffer
    of at least its rows, where one is given) and the reads compared byte
    for byte."""
    from sartsolver_tpu_torch.resilience import faults, integrity, watchdog
    from sartsolver_tpu_torch.resilience.retry import retry_call

    out = kwargs.get("out")

    def read_once(**kw) -> np.ndarray:
        stripe = read_rtm_block(sorted_matrix_files, rtm_name, n, nvoxel, r0,
                                dtype=np.float32, **kw)
        hit = faults.corrupt(faults.SITE_RTM_INGEST, stripe)
        if hit is not stripe and kw.get("out") is not None:
            kw["out"][...] = hit
            return kw["out"]
        return hit

    def attempt() -> np.ndarray:
        watchdog.beacon(watchdog.PHASE_PREFETCH)  # chunk turnover is progress
        faults.fire(faults.SITE_RTM_INGEST)
        stripe = read_once(**kwargs)
        if integrity.enabled():
            # the dense rows read again (the sparse segments' cache serves
            # its rows from memory, as the first read's)
            check = read_once(**dict(kwargs, out=None if check_out is None else check_out[:n]))
            # the fp32 words' bits (NaN payloads included), 4 bytes a compare
            if not np.array_equal(np.ascontiguousarray(stripe).view(np.uint32),
                                  np.ascontiguousarray(check).view(np.uint32)):
                integrity.digest_mismatch(f"RTM stripe [{r0}:{r0 + n})")
        return stripe

    stripe = retry_call(attempt, site=faults.SITE_RTM_INGEST)
    obs_metrics.get_registry().counter("bytes_ingested_total", source="rtm").inc(stripe.nbytes)
    return stripe


def _refuse_hooks(tile_stats) -> None:
    if tile_stats is not None:
        raise NotImplementedError("tile_stats= (the block-sparse tile index) comes "
                                  "with --sparse_rtm")


def _stream(sorted_matrix_files, rtm_name: str, npixel: int, nvoxel: int,
            dev: torch.device, chunk: int, *, what: str, sparse_cache: dict,
            direct: Optional[Callable] = None, consume: Optional[Callable] = None,
            timings: Optional[dict] = None) -> None:
    """One pass over the matrix's row chunks. Each chunk is read into a
    host staging buffer, copied to ``direct(r0, n)`` (a device view of the
    stored matrix's rows) or to the device staging chunk, and
    ``consume(r0, n, chunk)`` (on the copy's stream) then turns it into the
    stored rows or reads them."""
    from sartsolver_tpu_torch.resilience import integrity

    cuda = dev.type == "cuda"
    n0 = min(chunk, npixel)
    starts = list(range(0, npixel, chunk))
    # the integrity layer's second read of each chunk (one reader at a time)
    check = np.empty((n0, nvoxel), np.float32) if integrity.enabled() else None
    # one host buffer per slot the pass uses (one where it has one chunk),
    # allocated at its first read
    host: List = [None, None]
    stage = (torch.empty((n0, nvoxel), dtype=torch.float32, device=dev)
             if consume is not None and cuda else None)
    side = torch.cuda.Stream(dev) if cuda else None
    copied: List = [None, None]  # per host buffer: its last upload's end event
    uploads = []
    read_s = [0.0]

    def read(k: int) -> None:
        r0, slot = starts[k], k % 2
        n = min(chunk, npixel - r0)
        if copied[slot] is not None:
            copied[slot].synchronize()  # the buffer's previous upload is done
        t0 = time.perf_counter()
        if host[slot] is None:
            host[slot] = torch.empty((n0, nvoxel), dtype=torch.float32, pin_memory=cuda)
        _read_stripe_retried(sorted_matrix_files, rtm_name, n, nvoxel, r0, check_out=check,
                             out=host[slot].numpy()[:n], sparse_cache=sparse_cache,
                             cache_rows=(0, npixel), cache_cols=(0, nvoxel))
        read_s[0] += time.perf_counter() - t0

    if cuda:  # the side stream's writes follow the buffers' allocation
        side.wait_stream(torch.cuda.current_stream(dev))
    prefetch = prefetch_enabled()
    t_pass = time.perf_counter()
    with obs_trace.span("ingest.pass", what=what, chunk_rows=chunk, chunks=len(starts)), \
            ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(read, 0) if prefetch else None
        for k, r0 in enumerate(starts):
            n, slot = min(chunk, npixel - r0), k % 2
            if prefetch:
                pending.result()
                pending = pool.submit(read, k + 1) if k + 1 < len(starts) else None
            else:
                read(k)
            dst = direct(r0, n) if direct is not None else (
                stage[:n] if cuda else host[slot][:n])
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                if cuda:
                    start, end = torch.cuda.Event(enable_timing=True), \
                        torch.cuda.Event(enable_timing=True)
                    start.record(side)
                    dst.copy_(host[slot][:n], non_blocking=True)
                    end.record(side)
                    copied[slot] = end
                    uploads.append((start, end))
                elif direct is not None:
                    t0 = time.perf_counter()
                    dst.copy_(host[slot][:n])
                    uploads.append(time.perf_counter() - t0)
                if consume is not None:
                    consume(r0, n, dst)
        if cuda:
            side.synchronize()
    if timings is not None:
        upload_s = (sum(a.elapsed_time(b) for a, b in uploads) / 1e3 if cuda
                    else sum(uploads))
        timings[what] = dict(seconds=time.perf_counter() - t_pass, read_seconds=read_s[0],
                             upload_seconds=upload_s, chunks=len(starts), chunk_rows=chunk,
                             prefetch=prefetch, bytes=npixel * nvoxel * 4)


def _chunk(chunk_rows: Optional[int], npixel: int, nvoxel: int) -> int:
    chunk = default_chunk_rows(nvoxel) if chunk_rows is None else int(chunk_rows)
    if chunk < 1:
        raise ValueError(f"SART_INGEST_CHUNK_ROWS must be >= 1, {chunk} given.")
    return max(1, min(chunk, npixel))


def read_and_shard_rtm(
    sorted_matrix_files: Dict[str, List[str]],
    rtm_name: str,
    npixel: int,
    nvoxel: int,
    device="cuda",
    *,
    dtype,
    chunk_rows: Optional[int] = None,
    rows: Optional[int] = None,
    ingest_stats=None,
    tile_stats=None,
    timings: Optional[dict] = None,
) -> torch.Tensor:
    """The RTM ``[rows, nvoxel]`` on ``device`` in ``dtype`` (``"float32"``,
    ``"bfloat16"`` or ``"float64"``, or the torch dtype), read in row chunks.
    ``rows`` (default ``npixel``) pads the matrix with zero rows, the
    ordered-subsets padding of ``parallel/sharded.py``. ``ingest_stats``
    takes the stored values' sums (module docstring)."""
    _refuse_hooks(tile_stats)
    dev = resolve_device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else {
        "float32": torch.float32, "bfloat16": torch.bfloat16,
        "float64": torch.float64, "int8": torch.int8}[str(dtype)]
    if dt == torch.int8:
        raise ValueError("int8 staging needs the quantization pass; call "
                         "read_and_quantize_rtm (a bare cast would truncate).")
    rows = npixel if rows is None else int(rows)
    buf = torch.empty((rows, nvoxel), dtype=dt, device=dev)
    buf[npixel:].zero_()
    chunk = _chunk(chunk_rows, npixel, nvoxel)
    stored = None
    if ingest_stats is not None:
        def stored(r0, n):
            ingest_stats.add(buf[r0:r0 + n], r0, 0)

    if dt == torch.float32:  # the upload lands in the matrix's rows
        _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                sparse_cache={}, direct=lambda r0, n: buf[r0:r0 + n],
                consume=None if stored is None else lambda r0, n, _x: stored(r0, n),
                timings=timings)
    else:  # rounded (bf16) or widened (fp64) from the fp32 chunk
        def consume(r0, n, x):
            buf[r0:r0 + n].copy_(x)
            if stored is not None:
                stored(r0, n)

        _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                sparse_cache={}, consume=consume, timings=timings)
    return buf


def read_and_quantize_rtm(
    sorted_matrix_files: Dict[str, List[str]],
    rtm_name: str,
    npixel: int,
    nvoxel: int,
    device="cuda",
    *,
    chunk_rows: Optional[int] = None,
    rows: Optional[int] = None,
    ingest_stats=None,
    tile_stats=None,
    timings: Optional[dict] = None,
):
    """Two-pass chunked int8 ingest: ``(codes int8 [rows, nvoxel], scale fp32
    [nvoxel])`` on ``device``, the recipe of ``models/sart.py:quantize_rtm``
    (and of the JAX package's ``read_and_quantize_rtm``). Pass 1 streams the
    chunks for the per-voxel column maxima; pass 2 streams them again,
    quantizing each into the codes. The sparse segments are read once for
    both passes; the dense rows twice. ``ingest_stats`` takes the
    dequantized codes' sums in pass 2 (the JAX package's ``stats_dequant``)."""
    _refuse_hooks(tile_stats)
    from sartsolver_tpu_torch.ops.projection import _sym_scale

    dev = resolve_device(device)
    rows = npixel if rows is None else int(rows)
    chunk = _chunk(chunk_rows, npixel, nvoxel)
    cache: dict = {}
    colmax = torch.zeros(nvoxel, dtype=torch.float32, device=dev)

    def take_max(_r0, _n, x):
        torch.maximum(colmax, x.abs_().amax(dim=0), out=colmax)

    _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="colmax",
            sparse_cache=cache, consume=take_max, timings=timings)
    scale = _sym_scale(colmax)
    codes = torch.empty((rows, nvoxel), dtype=torch.int8, device=dev)
    codes[npixel:].zero_()

    def quantize(r0, n, x):
        # ops/projection.py:_sym_codes in place on the staging chunk: the
        # same correctly rounded division, half-to-even rounding and clip
        torch.div(x, scale, out=x)
        codes[r0:r0 + n].copy_(x.round_().clamp_(-127, 127))
        if ingest_stats is not None:
            ingest_stats.add(codes[r0:r0 + n].to(torch.float64)
                             * scale.to(torch.float64), r0, 0)

    _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="quantize",
            sparse_cache=cache, consume=quantize, timings=timings)
    return codes, scale
