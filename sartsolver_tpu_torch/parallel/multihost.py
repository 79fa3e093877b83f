"""The chunked RTM ingest: row chunks from the files into a device buffer.

Counterpart of the one-process side of ``sartsolver_tpu/parallel/multihost.py``
(named after it, so a reader finds one from the other): the JAX module's
``mesh`` becomes an explicit ``device``, and on a grid of ranks
(``parallel/mesh.py``) its ``grid=``: each rank then reads only its own
block's rows and columns, in turns where ``serialize=`` asks for them.

- :func:`read_and_shard_rtm` streams the matrix into a buffer of the stored
  dtype (fp32, bf16, or fp64 on the CPU), allocated on the device with
  ``torch.empty`` and never assembled on the host;
- :func:`read_and_quantize_rtm` is the two-pass int8 ingest: pass 1 takes
  the column maxima, pass 2 quantizes each chunk into the 1-byte codes;
- :func:`lowrank_operator_or_decline` reads the whole matrix on the host
  and factors it (``--lowrank_rtm``), or declines;
- :func:`initialize`, :func:`is_primary`, :func:`broadcast_resume_state`
  and the rank's pixel rows (:func:`process_pixel_range`,
  :func:`process_pixel_runs`, :func:`all_processes_local_capable`) serve a
  run over a grid of ranks;
- the pod section (:func:`pod_barrier`, :func:`agree_stop`,
  :func:`deadline_allgather`, the identity and the liveness beacons) bounds
  every rendezvous of a pod's hosts by a deadline, over a shared directory
  for the fake pod of N one-process workers or over the process group of a
  grid, so a dead or wedged peer ends its survivors' runs with
  :class:`PodBarrierTimeout` naming the missing host instead of a hang;
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

``tile_stats=`` (a :class:`~sartsolver_tpu_torch.ops.sparse.TileMaxStats`
from :func:`make_tile_stats`) takes the block-sparse tile index's maxima of
the stored values, where they lie, one chunk at a time: the fp32 or bf16
rows as stored, for int8 the codes times their scales in pass 2 (the JAX
recipe's storage-rounded index). Each chunk is reduced on the device to its
``[rows/8, V/128]`` tile maxima, a few KB that join the grid on the host.

Each pass is an ``ingest.pass`` trace span (``what=`` ``store``,
``colmax`` or ``quantize``). ``timings=`` (a dict) receives each pass's
seconds, its read seconds (the reader's), its upload seconds (the side
stream's copies, by CUDA events) and its chunk count.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

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


# the JAX package's voxel-column alignment: the tile index covers the
# matrix padded to whole 128-column tiles
COL_ALIGN = 128
# rows of a chunk reduced to tile maxima at once: the reduction's output
# stays at a few tens of KB beside the stored matrix
_TILE_BLOCK_ROWS = 256


def _padded(n: int, align: int) -> int:
    return -(-n // align) * align


def make_tile_stats(npixel: int, nvoxel: int):
    """A :class:`~sartsolver_tpu_torch.ops.sparse.TileMaxStats` sized as the
    JAX package's (``sartsolver_tpu/parallel/multihost.py:make_tile_stats``
    on one device): the grid of the matrix padded to whole 8 x 128 tiles,
    whose padding never receives a value, so the padded panels are born
    unoccupied. Feed it through :func:`read_and_shard_rtm` or
    :func:`read_and_quantize_rtm` as ``tile_stats=``, then cut it into an
    index (``stats.occupancy(eps)``)."""
    from sartsolver_tpu_torch.ops.sparse import TileMaxStats

    return TileMaxStats(_padded(npixel, ROW_ALIGN), _padded(nvoxel, COL_ALIGN))


def sparse_tile_stats_or_decline(opts, npixel: int, nvoxel: int, process_count: int = 1):
    """The block-sparse ingest gate
    (``sartsolver_tpu/parallel/multihost.py:sparse_tile_stats_or_decline``):
    a :class:`~sartsolver_tpu_torch.ops.sparse.TileMaxStats` to feed through
    the chunked read, or None when sparse mode is off or declines on a flag
    ('auto', with the JAX package's stderr warning). An explicit threshold
    raises ``SartInputError`` with the reason instead. ``process_count`` is
    the grid's ranks (the JAX gate's ``jax.process_count()``): past one,
    'auto' declines and the grid runs the dense matrix."""
    import sys

    from sartsolver_tpu_torch.config import SartInputError
    from sartsolver_tpu_torch.ops.sparse import static_decline_reason

    if opts.sparse_epsilon() is None:
        return None
    reason = static_decline_reason(opts, process_count)
    if reason is not None:
        if opts.sparse_explicit():
            raise SartInputError(f"Argument sparse_rtm={opts.sparse_rtm}: {reason}.")
        print(f"Warning: sparse_rtm declines here ({reason}); running dense.",
              file=sys.stderr)
        return None
    return make_tile_stats(npixel, nvoxel)


def lowrank_operator_or_decline(opts, sorted_matrix_files, rtm_name, npixel: int,
                                nvoxel: int, laplacian=None, device="cuda",
                                timings: Optional[dict] = None, process_count: int = 1,
                                n_voxel_shards: int = 1):
    """The factored-RTM ingest gate
    (``sartsolver_tpu/parallel/multihost.py:lowrank_operator_or_decline``):
    a :class:`~sartsolver_tpu_torch.operators.lowrank.LowRankOperator` for
    the solver, or None when lowrank mode is off or declines ('auto', with
    the JAX package's stderr warning). An explicit rank raises
    ``SartInputError`` with the reason, for a static obstacle and for a
    failed quality gate, before anything is staged. The whole matrix is
    read on the host by the retried row reader; the gate's parity solves
    run on ``device``. ``timings``, where given, receives the read's
    seconds beside the factorization's (``build_lowrank_operator``).
    ``process_count`` and ``n_voxel_shards`` are the grid's (ranks, voxel
    shards), as the JAX gate takes ``jax.process_count()`` and the mesh's."""
    import sys

    from sartsolver_tpu_torch.config import SartInputError
    from sartsolver_tpu_torch.operators.lowrank import (
        build_lowrank_operator, lowrank_static_decline_reason,
    )

    rank = opts.lowrank_rank()
    if rank is None:
        return None
    reason = lowrank_static_decline_reason(opts, process_count, n_voxel_shards=n_voxel_shards,
                                           has_laplacian=laplacian is not None)
    op = None
    if reason is None:
        t0 = time.perf_counter()
        H = _read_stripe_retried(sorted_matrix_files, rtm_name, npixel, nvoxel, 0)
        if timings is not None:
            timings["read_s"] = time.perf_counter() - t0
        # an explicit rank's gate failures raise SartInputError inside
        op, reason = build_lowrank_operator(H, rank=rank, device=device, timings=timings)
        del H
    if reason is not None:
        if opts.lowrank_explicit():
            raise SartInputError(f"Argument lowrank_rtm={opts.lowrank_rtm}: {reason}.")
        print(f"Warning: lowrank_rtm declines here ({reason}); running dense.",
              file=sys.stderr)
        return None
    return op


def _tile_maxima(x: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """``max |x|`` over each tile of ``x`` ``[k * m, V]`` viewed as ``k`` tile
    rows of ``m`` rows: ``[k, ceil(V / tile_cols)]`` fp32, the last tile
    column cut at V. Reductions over views: no copy of ``x`` is made."""
    k = x.shape[0] // tile_rows if x.shape[0] >= tile_rows else 1
    rows = x.unflatten(0, (k, x.shape[0] // k))
    V = x.shape[1]
    main = V // tile_cols * tile_cols
    parts = []
    if main:
        parts.append(torch.linalg.vector_norm(
            rows[:, :, :main].unflatten(2, (main // tile_cols, tile_cols)),
            ord=float("inf"), dim=(1, 3)))
    if main < V:
        parts.append(torch.linalg.vector_norm(rows[:, :, main:], ord=float("inf"),
                                              dim=(1, 2))[:, None])
    return torch.cat(parts, dim=1).float() if len(parts) > 1 else parts[0].float()


def _fold_max_(t: torch.Tensor, dim: int) -> None:
    """Reduce ``|t|`` along ``dim`` into its index 0 in place (``t`` already
    holds absolute values): halves folded onto each other with
    ``torch.maximum``, which keeps a NaN."""
    m = t.shape[dim]
    while m > 1:
        h = m // 2
        torch.maximum(t.narrow(dim, 0, h), t.narrow(dim, m - h, h), out=t.narrow(dim, 0, h))
        m -= h


def _tile_maxima_in_place(x: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """The tile maxima of ``x`` ``[k * tile_rows, V]`` (whole tile rows, a
    staging chunk whose values are not needed after) reduced in place in
    ``x`` itself: ``[k, ceil(V / tile_cols)]``, a contiguous view into the
    second row of ``x``, which holds nothing else by then. No device memory
    is allocated."""
    k, V = x.shape[0] // tile_rows, x.shape[1]
    main = V // tile_cols * tile_cols
    nct = -(-V // tile_cols)
    x.abs_()
    rows = x.unflatten(0, (k, tile_rows))
    _fold_max_(rows, 1)
    first = rows[:, 0]  # [k, V]: each tile row's column maxima
    if main:
        _fold_max_(first[:, :main].unflatten(1, (main // tile_cols, tile_cols)), 2)
    if main < V:
        _fold_max_(first[:, main:], 1)
    out = rows[0, 1, :k * nct].view(k, nct)  # a row the folds emptied
    if main:
        out[:, :main // tile_cols].copy_(first[:, :main:tile_cols])
    if main < V:
        out[:, -1].copy_(first[:, main])
    return out


def _feed_tile_stats(tile_stats, x: torch.Tensor, r0: int, scratch: bool = False) -> None:
    """Fold the stored rows ``x`` ``[n, V]`` (rows ``r0 ..`` of the matrix)
    into ``tile_stats``: their tile maxima taken where they lie, a block of
    whole tile rows at a time, then copied to the host grid. ``scratch``:
    ``x`` is a staging chunk whose values are not needed after, and its
    whole tile rows are reduced in place (:func:`_tile_maxima_in_place`),
    so the feed allocates no device memory beside the ingest's own."""
    tr, tc = tile_stats.tile_rows, tile_stats.tile_cols
    n = x.shape[0]
    head = min(n, (-r0) % tr)  # the rows of a tile the previous chunk began
    body = head + (n - head) // tr * tr
    step = max(tr, _TILE_BLOCK_ROWS // tr * tr)
    cuts = [(0, head)] + [(s, min(s + step, body)) for s in range(head, body, step)] \
        + [(body, n)]
    for s, e in cuts:
        if e > s:
            whole = (e - s) % tr == 0 and (s + r0) % tr == 0
            if scratch and whole and (e - s) // tr * -(-x.shape[1] // tc) <= x.shape[1]:
                grid = _tile_maxima_in_place(x[s:e], tr, tc)
            else:
                grid = _tile_maxima(x[s:e], tr, tc)
            tile_stats.add_grid(grid.cpu().numpy(), (r0 + s) // tr)


def _stream(sorted_matrix_files, rtm_name: str, npixel: int, nvoxel: int,
            dev: torch.device, chunk: int, *, what: str, sparse_cache: dict,
            direct: Optional[Callable] = None, consume: Optional[Callable] = None,
            timings: Optional[dict] = None, window=None) -> None:
    """One pass over the matrix's row chunks. Each chunk is read into a
    host staging buffer, copied to ``direct(r0, n)`` (a device view of the
    stored matrix's rows) or to the device staging chunk, and
    ``consume(r0, n, chunk)`` (on the copy's stream) then turns it into the
    stored rows or reads them. ``window`` ``(row0, rows, col0, cols)``
    (default the whole matrix) reads only those logical rows and columns,
    a rank's block on a grid; ``r0`` counts from ``row0``."""
    from sartsolver_tpu_torch.resilience import integrity

    row0, nrows, col0, ncols = (0, npixel, 0, nvoxel) if window is None else window
    cuda = dev.type == "cuda"
    n0 = min(chunk, nrows)
    starts = list(range(0, nrows, chunk))
    # the integrity layer's second read of each chunk (one reader at a time)
    check = np.empty((n0, ncols), np.float32) if integrity.enabled() else None
    # one host buffer per slot the pass uses (one where it has one chunk),
    # allocated at its first read
    host: List = [None, None]
    stage = (torch.empty((n0, ncols), dtype=torch.float32, device=dev)
             if consume is not None and cuda else None)
    side = torch.cuda.Stream(dev) if cuda else None
    copied: List = [None, None]  # per host buffer: its last upload's end event
    uploads = []
    read_s = [0.0]

    def read(k: int) -> None:
        r0, slot = starts[k], k % 2
        n = min(chunk, nrows - r0)
        if copied[slot] is not None:
            copied[slot].synchronize()  # the buffer's previous upload is done
        t0 = time.perf_counter()
        if host[slot] is None:
            host[slot] = torch.empty((n0, ncols), dtype=torch.float32, pin_memory=cuda)
        _read_stripe_retried(sorted_matrix_files, rtm_name, n, nvoxel, row0 + r0,
                             check_out=check, out=host[slot].numpy()[:n],
                             sparse_cache=sparse_cache, cache_rows=(row0, row0 + nrows),
                             cache_cols=(col0, col0 + ncols), offset_voxel=col0,
                             nvoxel_local=ncols)
        read_s[0] += time.perf_counter() - t0

    if cuda:  # the side stream's writes follow the buffers' allocation
        side.wait_stream(torch.cuda.current_stream(dev))
    prefetch = prefetch_enabled()
    t_pass = time.perf_counter()
    with obs_trace.span("ingest.pass", what=what, chunk_rows=chunk, chunks=len(starts)), \
            ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(read, 0) if prefetch else None
        for k, r0 in enumerate(starts):
            n, slot = min(chunk, nrows - r0), k % 2
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
                             prefetch=prefetch, bytes=nrows * ncols * 4)


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
    grid=None,
    serialize: bool = False,
) -> torch.Tensor:
    """The RTM ``[rows, nvoxel]`` on ``device`` in ``dtype`` (``"float32"``,
    ``"bfloat16"`` or ``"float64"``, or the torch dtype), read in row chunks.
    ``rows`` (default ``npixel``) pads the matrix with zero rows, the
    ordered-subsets padding of ``parallel/sharded.py``. ``ingest_stats``
    takes the stored values' sums and ``tile_stats`` their tile maxima
    (module docstring).

    ``grid`` (a ``parallel/mesh.py:RankGrid`` of more than one rank): this
    rank's padded block ``[rows, cols]`` of the grid's partition, read from
    its own logical rows and columns only (the reference's per-rank block
    read, raytransfer.cpp:49); the padding is zero. ``serialize`` reads in
    turns, rank after rank with a barrier between turns (the reference's
    HDD-friendly round robin, main.cpp:78-86); ``--parallel_read`` turns it
    off."""
    dev = resolve_device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else {
        "float32": torch.float32, "bfloat16": torch.bfloat16,
        "float64": torch.float64, "int8": torch.int8}[str(dtype)]
    if dt == torch.int8:
        raise ValueError("int8 staging needs the quantization pass; call "
                         "read_and_quantize_rtm (a bare cast would truncate).")
    if grid is not None and grid.world > 1:
        return _in_turns(grid, serialize, lambda: _read_block(
            sorted_matrix_files, rtm_name, npixel, nvoxel, dev, dt, grid,
            _chunk(chunk_rows, npixel, nvoxel), ingest_stats, tile_stats, timings))
    rows = npixel if rows is None else int(rows)
    buf = torch.empty((rows, nvoxel), dtype=dt, device=dev)
    buf[npixel:].zero_()
    chunk = _chunk(chunk_rows, npixel, nvoxel)
    stored = None
    if ingest_stats is not None or tile_stats is not None:
        def stored(r0, n):
            if ingest_stats is not None:
                ingest_stats.add(buf[r0:r0 + n], r0, 0)
            if tile_stats is not None:
                _feed_tile_stats(tile_stats, buf[r0:r0 + n], r0)

    if dt == torch.float32:  # the upload lands in the matrix's rows
        _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                sparse_cache={}, direct=lambda r0, n: buf[r0:r0 + n],
                consume=None if stored is None else lambda r0, n, _x: stored(r0, n),
                timings=timings)
    else:  # rounded (bf16) or widened (fp64) from the fp32 chunk
        def consume(r0, n, x):
            buf[r0:r0 + n].copy_(x)
            if ingest_stats is not None:
                ingest_stats.add(buf[r0:r0 + n], r0, 0)
            if tile_stats is not None:
                # the stored values, back in the staging chunk: the maxima
                # reduced there, in place
                _feed_tile_stats(tile_stats, x.copy_(buf[r0:r0 + n]), r0, scratch=True)

        _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                sparse_cache={}, consume=consume, timings=timings)
    return buf


def _in_turns(grid, serialize: bool, read: Callable):
    """``read()`` on every rank, at once, or with ``serialize`` one rank a
    turn in rank order, every rank meeting at the pod barrier
    ``rtm_read_turn_<turn>`` after each turn: a rank that dies in its turn
    ends its peers' runs at that barrier's deadline. With
    ``SART_TEST_POD_MARKERS`` a rank announces ``SART_POD_POINT ingest
    turn=<k>`` on stderr as its turn starts (the drills' kill window)."""
    if not serialize:
        return read()
    out = None
    for turn in range(grid.world):
        if turn == grid.rank:
            if os.environ.get("SART_TEST_POD_MARKERS"):
                sys.stderr.write(f"SART_POD_POINT ingest turn={turn}\n")
                sys.stderr.flush()
            out = read()
        pod_barrier(f"rtm_read_turn_{turn}")
    return out


def _grid_window(grid, npixel: int, nvoxel: int):
    """``(block rows, block cols, window)`` of this rank's block: the window
    ``(row0, rows, col0, cols)`` of its logical rows and columns."""
    rb, cb = grid.blocks(npixel, nvoxel)
    r0, nr = grid.row_range(npixel)
    c0, nc = grid.col_range(nvoxel)
    return rb, cb, (r0, nr, c0, nc)


def _no_grid_stats(ingest_stats, tile_stats) -> None:
    if ingest_stats is not None or tile_stats is not None:
        raise ValueError("A grid's striped ingest takes no ingest sums or tile "
                         "index (the integrity layer and the block-sparse RTM run "
                         "on one rank).")


def _read_block(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, dt, grid, chunk,
                ingest_stats, tile_stats, timings) -> torch.Tensor:
    """This rank's padded block of the stored matrix, in ``dt``."""
    _no_grid_stats(ingest_stats, tile_stats)
    rb, cb, window = _grid_window(grid, npixel, nvoxel)
    buf = torch.zeros((rb, cb), dtype=dt, device=dev)
    _, nr, _, nc = window
    if nr and nc:
        chunk = max(1, min(chunk, nr))
        if dt == torch.float32:
            _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                    sparse_cache={}, direct=lambda r0, n: buf[r0:r0 + n, :nc],
                    timings=timings, window=window)
        else:
            def consume(r0, n, x):
                buf[r0:r0 + n, :nc].copy_(x)

            _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="store",
                    sparse_cache={}, consume=consume, timings=timings, window=window)
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
    grid=None,
    serialize: bool = False,
):
    """Two-pass chunked int8 ingest: ``(codes int8 [rows, nvoxel], scale fp32
    [nvoxel])`` on ``device``, the recipe of ``models/sart.py:quantize_rtm``
    (and of the JAX package's ``read_and_quantize_rtm``). Pass 1 streams the
    chunks for the per-voxel column maxima; pass 2 streams them again,
    quantizing each into the codes. The sparse segments are read once for
    both passes; the dense rows twice. ``ingest_stats`` takes the
    dequantized codes' sums in pass 2 (the JAX package's ``stats_dequant``),
    ``tile_stats`` their tile maxima (the codes times the scales, in place
    on the staging chunk once the codes are stored).

    ``grid`` (a voxel-major grid of more than one rank; the solver refuses
    int8 on a pixel-sharded one): this rank's block ``(codes [rows, cols],
    scale [cols])``, both passes reading every row of its own columns, so
    the column maxima are the whole columns' and need no reduction
    (``sartsolver_tpu/parallel/multihost.py:130-228``); padded columns have
    scale 1. ``serialize`` as for :func:`read_and_shard_rtm`."""
    dev = resolve_device(device)
    window = None
    if grid is not None and grid.world > 1:
        if grid.n_pix > 1:
            raise ValueError("int8 on a grid needs its pixel axis unsharded (whole "
                             "columns a rank).")
        _no_grid_stats(ingest_stats, tile_stats)
        rows, width, window = _grid_window(grid, npixel, nvoxel)
        return _in_turns(grid, serialize, lambda: _quantize_pass(
            sorted_matrix_files, rtm_name, npixel, nvoxel, dev, rows, width, window,
            _chunk(chunk_rows, npixel, nvoxel), None, None, timings))
    rows = npixel if rows is None else int(rows)
    return _quantize_pass(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, rows, nvoxel,
                          None, _chunk(chunk_rows, npixel, nvoxel), ingest_stats,
                          tile_stats, timings)


def _quantize_pass(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, rows, width, window,
                   chunk, ingest_stats, tile_stats, timings):
    """The two passes of :func:`read_and_quantize_rtm` into ``(codes [rows,
    width], scale [width])``, over ``window`` (the whole matrix where
    None)."""
    from sartsolver_tpu_torch.ops.projection import _sym_scale

    nr, nc = (npixel, nvoxel) if window is None else (window[1], window[3])
    cache: dict = {}
    colmax = torch.zeros(width, dtype=torch.float32, device=dev)
    if not (nr and nc):
        return torch.zeros((rows, width), dtype=torch.int8, device=dev), _sym_scale(colmax)
    chunk = max(1, min(chunk, nr))

    def take_max(_r0, _n, x):
        torch.maximum(colmax[:nc], x.abs_().amax(dim=0), out=colmax[:nc])

    _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="colmax",
            sparse_cache=cache, consume=take_max, timings=timings, window=window)
    scale = _sym_scale(colmax)
    sc = scale[:nc]
    codes = torch.empty((rows, width), dtype=torch.int8, device=dev)
    codes[nr:].zero_()
    codes[:nr, nc:].zero_()

    def quantize(r0, n, x):
        # ops/projection.py:_sym_codes in place on the staging chunk: the
        # same correctly rounded division, half-to-even rounding and clip
        torch.div(x, sc, out=x)
        codes[r0:r0 + n, :nc].copy_(x.round_().clamp_(-127, 127))
        if ingest_stats is not None:
            ingest_stats.add(codes[r0:r0 + n].to(torch.float64)
                             * scale.to(torch.float64), r0, 0)
        if tile_stats is not None:
            _feed_tile_stats(tile_stats, x.mul_(scale), r0, scratch=True)

    _stream(sorted_matrix_files, rtm_name, npixel, nvoxel, dev, chunk, what="quantize",
            sparse_cache=cache, consume=quantize, timings=timings, window=window)
    return codes, scale


# ---- a run over a grid of ranks ------------------------------------------------


def initialize(device_type: str) -> str:
    """The process group of a ``--multihost`` run (``parallel/comm.py:
    initialize``, from the launcher's environment); returns its backend.

    Fault site ``multihost.init``, under its retry policy: on a pod's
    bring-up the rendezvous is often not listening yet when a rank starts,
    so a failed start (an ``OSError``, a ``RuntimeError`` from the store)
    is retried with backoff; exhaustion raises ``RetriesExhausted``, which
    the CLI answers with exit 3. A missing launcher environment is the
    user's (``SartInputError``) and is not retried."""
    from sartsolver_tpu_torch.parallel import comm
    from sartsolver_tpu_torch.resilience import faults
    from sartsolver_tpu_torch.resilience.retry import retry_call

    def attempt() -> str:
        faults.fire(faults.SITE_MULTIHOST_INIT)
        return comm.initialize(device_type)

    return retry_call(attempt, site=faults.SITE_MULTIHOST_INIT,
                      retry_on=(OSError, RuntimeError))


def is_primary() -> bool:
    """Whether this process owns user-facing output: rank 0 of the process
    group, or a process without one (the reference's rank 0)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def process_pixel_range(grid, npixel: int):
    """``(offset, count)`` of the logical pixel rows this rank holds (its
    one row block; ``count`` 0 for a block of padding only), ``(0,
    npixel)`` without a grid."""
    if grid is None or grid.world <= 1:
        return (0, npixel)
    return grid.row_range(npixel)


def process_pixel_runs(grid, npixel: int) -> list:
    """This rank's pixel rows as contiguous ``(offset, count)`` runs: its
    one row block, or nothing where it holds padding only."""
    off, count = process_pixel_range(grid, npixel)
    return [(off, count)] if count else []


def all_processes_local_capable(grid, npixel: int) -> bool:
    """Whether every rank holds a logical pixel row, the gate of per-rank
    measurement staging: a rule of the grid's shape alone, so every rank
    gives the same answer without a collective."""
    if grid is None or grid.world <= 1:
        return False
    rb = grid.blocks(npixel, 1)[0]
    return (grid.n_pix - 1) * rb < npixel


def broadcast_resume_state(state, nvoxel: int, error: Optional[str] = None):
    """Rank 0's resume view (``io/solution.py:ResumeState`` or None), on
    every rank of the world.

    With ``--multihost --resume`` only rank 0 reads the output file (it may
    lie where only rank 0 sees it); ranks that read it each on their own
    could skip different frames and leave their collectives out of step.
    ``error`` (rank 0 only) is the message of a failed read: it crosses
    first and is raised as ``SartInputError`` on every rank, so the whole
    grid exits 1 instead of rank 0 alone while its peers wait. Then the
    written times and the last solution, fp64 bit for bit
    (``parallel/comm.py:broadcast_host`` moves raw bytes). Without a process
    group of more than one rank: ``state`` itself, or the error raised."""
    import torch.distributed as dist

    from sartsolver_tpu_torch.config import SartInputError

    if not dist.is_initialized() or dist.get_world_size() == 1:
        if error is not None:
            raise SartInputError(error)
        return state
    from sartsolver_tpu_torch.io.solution import ResumeState
    from sartsolver_tpu_torch.parallel import comm

    primary = dist.get_rank() == 0
    err_bytes = (error or "").encode() if primary else b""
    meta = np.zeros(4, np.int64)
    if primary:
        meta[:] = (0 if state is None else 1,
                   0 if state is None else len(state.times),
                   1 if state is not None and state.last_solution is not None else 0,
                   len(err_bytes))
    meta = comm.broadcast_host(meta)
    if meta[3] > 0:
        buf = (np.frombuffer(err_bytes, np.uint8) if primary
               else np.zeros(int(meta[3]), np.uint8))
        raise SartInputError(comm.broadcast_host(buf).tobytes().decode())
    if meta[0] == 0:
        return None
    times = comm.broadcast_host(np.asarray(state.times, np.float64) if primary
                                else np.zeros(int(meta[1]), np.float64))
    last = None
    if meta[2]:
        last = comm.broadcast_host(np.asarray(state.last_solution, np.float64) if primary
                                   else np.zeros(nvoxel, np.float64))
    return ResumeState(times, last)


# ---------------------------------------------------------------------------
# the pod: identity, liveness, deadline-bounded rendezvous
# (sartsolver_tpu/parallel/multihost.py:795-1100)

# the watchdog beacon phase of a wait in a pod barrier: the hang watchdog
# stays quiet through a slow peer's turn (the barrier's own deadline
# decides a dead peer), and the heartbeat line says where the run waits
PHASE_POD_BARRIER = "pod.barrier"

# seconds between refreshes of a host's liveness beacon: deadlines are tens
# of seconds, and the beacon tap stays at most 1 Hz of file writes
_ALIVE_THROTTLE = 1.0

# the file-mode stop agreement's sequence: every host polls at the same
# boundaries, so the same count names the same exchange on each
_stop_seq = 0


class PodBarrierTimeout(RuntimeError):
    """A pod rendezvous gave up on one or more peers.

    ``missing`` holds the pod indices that never arrived (empty where a
    collective of the process group failed or wedged: no per-host
    attribution there). The message, the crash bundle's reason, names the
    missing hosts; ``cause`` is the collective's own error where it failed
    rather than timed out (gloo reports a killed peer at once)."""

    def __init__(self, name: str, missing, timeout: float, cause: Optional[str] = None):
        self.name = name
        self.missing = list(missing)
        self.timeout = timeout
        self.cause = cause
        who = (", ".join(f"h{j}" for j in self.missing) if self.missing
               else f"unknown (collective {'wedged' if cause is None else 'failed'})")
        what = (f"timed out after {timeout:g}s" if cause is None
                else f"failed ({cause})")
        super().__init__(f"pod barrier {name!r} {what}; missing host(s): {who}")


def pod_identity() -> Tuple[int, int]:
    """``(index, count)`` of this process in the pod: ``SART_POD_PROCESS``
    (``k/n``, or ``k`` for a count of 1) where set and well formed, else
    the process group's ``(rank, world)``, else ``(0, 1)``."""
    raw = os.environ.get("SART_POD_PROCESS", "")
    if raw:
        try:
            k, _sep, n = raw.partition("/")
            return int(k), max(int(n) if n else 1, 1)
        except ValueError:
            pass  # malformed: the process group's answer
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def export_pod_identity() -> Tuple[int, int]:
    """Publish this process's pod identity as ``SART_POD_PROCESS=k/n``
    where the process group gives one of more than one rank: the modules
    that import no torch (the heartbeat's ``host=``, the crash bundle's
    ``host``, ``faults.pod_index`` for the ``site@i`` qualifier) read the
    environment. The fault registry is re-read, so a qualified entry arms
    on its own host only."""
    index, count = pod_identity()
    if count > 1 and not os.environ.get("SART_POD_PROCESS"):
        os.environ["SART_POD_PROCESS"] = f"{index}/{count}"
        from sartsolver_tpu_torch.resilience import faults

        faults.reset()
    return index, count


def barrier_timeout() -> float:
    """The pod barriers' deadline in seconds: ``SART_POD_BARRIER_TIMEOUT``,
    default 300 (above every rendezvous gap of a healthy run); 0 waits
    without a deadline. A malformed value is reported and ignored."""
    raw = os.environ.get("SART_POD_BARRIER_TIMEOUT", "300")
    try:
        return max(float(raw), 0.0)
    except ValueError:
        print(f"sartsolve: ignoring malformed SART_POD_BARRIER_TIMEOUT={raw!r} "
              "(using 300)", file=sys.stderr)
        return 300.0


def _timeout_error(name: str, missing, timeout: float,
                   cause: Optional[str] = None) -> PodBarrierTimeout:
    """The barrier's error, counted in ``pod_barrier_timeouts_total``."""
    obs_metrics.get_registry().counter("pod_barrier_timeouts_total").inc()
    return PodBarrierTimeout(name, missing, timeout, cause)


def _touch_alive(bdir: str, index: int) -> None:
    from sartsolver_tpu_torch.utils import atomicio

    try:
        # advisory (the arrival file decides), so no fsync: the JAX
        # package's choice
        atomicio.write_atomic(os.path.join(bdir, f"alive.h{index}"),
                              f"{time.time():.3f}\n", fsync=False)
    except OSError:
        pass


def _alive_age(bdir: str, j: int) -> Optional[float]:
    """Seconds since host ``j`` last refreshed its liveness beacon, None
    where it never wrote one."""
    try:
        return max(time.time() - os.path.getmtime(os.path.join(bdir, f"alive.h{j}")), 0.0)
    except OSError:
        return None


def install_pod_liveness() -> None:
    """Refresh this host's liveness beacon (``<SART_POD_BARRIER_DIR>/
    alive.h<k>``) from the watchdog's beacon stream, at most once each
    :data:`_ALIVE_THROTTLE` seconds: a host busy in a long turn (the ingest,
    a stride) stays alive to its peers' barriers. File-mode pods only."""
    bdir = os.environ.get("SART_POD_BARRIER_DIR")
    if not bdir:
        return
    index, count = pod_identity()
    if count <= 1:
        return
    from sartsolver_tpu_torch.resilience import watchdog

    last = [0.0]

    def tap(_phase: str, _serial: int, now: float, _ident: int) -> None:
        if now - last[0] >= _ALIVE_THROTTLE:
            last[0] = now
            _touch_alive(bdir, index)

    os.makedirs(bdir, exist_ok=True)
    _touch_alive(bdir, index)
    watchdog.add_beacon_tap("pod.liveness", tap)


def _file_barrier(bdir: str, name: str, index: int, count: int, payload,
                  timeout: float) -> list:
    """The directory barrier: arrive (an atomic per-host file carrying
    ``payload`` as JSON), then wait for every peer's, polling after 1 ms,
    then at twice the last interval up to every 50 ms: a peer a stride
    behind by a millisecond costs about that, not a whole 50 ms poll.

    Past the deadline a missing peer whose liveness beacon is at least a
    deadline old (or absent) is dead, and the barrier raises naming it. A
    missing peer whose beacon stays fresh (alive, slow: a long ingest
    turn) extends the wait, up to 4x the deadline, so two hosts waiting in
    different barriers still both end. A peer's torn payload gives a
    ``None`` row."""
    from sartsolver_tpu_torch.resilience import watchdog
    from sartsolver_tpu_torch.utils import atomicio

    os.makedirs(bdir, exist_ok=True)
    safe = name.replace(os.sep, "_")
    # advisory bytes, as the liveness beacon's: a crash loses the whole
    # incarnation, whose barrier directory is never reused
    atomicio.write_atomic(os.path.join(bdir, f"{safe}.h{index}.json"), json.dumps(payload),
                          fsync=False)
    _touch_alive(bdir, index)
    start = time.monotonic()
    last_note = start
    poll = 0.001
    while True:
        missing = [j for j in range(count) if j != index and not os.path.exists(
            os.path.join(bdir, f"{safe}.h{j}.json"))]
        if not missing:
            break
        now = time.monotonic()
        if now - last_note >= _ALIVE_THROTTLE:
            last_note = now
            _touch_alive(bdir, index)
            watchdog.beacon(PHASE_POD_BARRIER)
        if timeout > 0 and now - start >= timeout:
            dead = [j for j in missing
                    if (_alive_age(bdir, j) or float("inf")) >= timeout]
            if dead or now - start >= 4 * timeout:
                raise _timeout_error(name, dead or missing, timeout)
        time.sleep(poll)
        poll = min(2 * poll, 0.05)
    rows: list = []
    for j in range(count):
        if j == index:
            rows.append(payload)
            continue
        try:
            with open(os.path.join(bdir, f"{safe}.h{j}.json")) as f:
                rows.append(json.loads(f.read()))
        except (OSError, ValueError):
            rows.append(None)  # arrived, payload torn: benign
    return rows


def _deadline_collective(name: str, fn: Callable, timeout: float):
    """``fn()`` (a collective of the process group) with a deadline: it
    blocks in the backend, where nothing can interrupt it, so it runs in a
    daemon thread the caller waits on. Past the deadline, or where the
    collective fails (gloo reports a killed peer at once), the caller gets
    :class:`PodBarrierTimeout`; a thread still blocked is left to the
    process's exit. The CUDA current device is per thread, so the thread
    takes the caller's (``cuda:LOCAL_RANK`` under NCCL, not ``cuda:0``)."""
    result: dict = {}
    done = threading.Event()
    device = torch.cuda.current_device() if torch.cuda.is_initialized() else None

    def run() -> None:
        try:
            if device is not None:
                torch.cuda.set_device(device)
            result["value"] = fn()
        # not swallowed: every error, the device's too, is re-raised in
        # the caller below
        except BaseException as err:  # sart-lint: disable=SL006
            result["err"] = err
        finally:
            done.set()

    if timeout <= 0:
        run()
    else:
        threading.Thread(target=run, name=f"sart-pod-{name}", daemon=True).start()
        if not done.wait(timeout):
            raise _timeout_error(name, [], timeout)
    err = result.get("err")
    if isinstance(err, RuntimeError):  # the backend's: a peer gone
        raise _timeout_error(name, [], timeout, f"{type(err).__name__}: {err}") from err
    if err is not None:
        raise err
    return result.get("value")


def pod_barrier(name: str, payload=None, timeout: Optional[float] = None) -> list:
    """A deadline-bounded rendezvous of the pod's hosts; returns every
    host's ``payload`` in index order (``None`` rows where one is not
    available).

    A pod of one process returns ``[payload]`` with no I/O. With
    ``SART_POD_BARRIER_DIR`` the directory barrier runs (and exchanges the
    payloads); on a process group a one-int all-gather under the deadline
    (no payloads there); with neither (an identity of more than one host
    and nothing to meet over) the host answers alone. Names must be unique
    per rendezvous within one incarnation (stride and sequence numbers).
    Fault site ``pod.barrier``."""
    index, count = pod_identity()
    if count <= 1:
        return [payload]
    from sartsolver_tpu_torch.resilience import faults

    faults.fire(faults.SITE_POD_BARRIER)
    if timeout is None:
        timeout = barrier_timeout()
    bdir = os.environ.get("SART_POD_BARRIER_DIR")
    if bdir:
        return _file_barrier(bdir, name, index, count, payload, timeout)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return [payload if j == index else None for j in range(count)]
    from sartsolver_tpu_torch.parallel import comm

    _deadline_collective(name, lambda: comm.all_gather_host(np.zeros(1, np.int64)), timeout)
    return [None] * count


def deadline_allgather(grid):
    """The end-of-run telemetry's ``allgather`` (``obs/run.py:
    aggregate_snapshots``): a uint8 buffer [N] from every rank of the
    world, ``[world, N]`` in rank order, under the pod barriers' deadline
    (a rank that died after its last frame must not hold its peers'
    artifact); None without a grid (no aggregation)."""
    if grid is None or grid.world <= 1:
        return None
    from sartsolver_tpu_torch.parallel import comm

    timeout = barrier_timeout()

    def gather(buf):
        return _deadline_collective(
            "metrics_allgather", lambda: comm.all_gather_host(np.ascontiguousarray(buf)),
            timeout)
    return gather


def agree_stop(local_stop: bool) -> bool:
    """The stop agreement of a graceful stop: every host polls at the same
    group or stride boundary, and any host's flag stops them all there
    (the signals land at different instants; a host that stopped alone
    would leave its peers waiting). A file-mode pod exchanges the flags in
    the barrier ``agree_stop.<seq>``; a process group in a one-int
    all-gather under the deadline; a lone process answers with its own
    flag. A peer dead between boundaries is :class:`PodBarrierTimeout`."""
    global _stop_seq
    _index, count = pod_identity()
    if count <= 1:
        return bool(local_stop)
    if os.environ.get("SART_POD_BARRIER_DIR"):
        _stop_seq += 1
        rows = pod_barrier(f"agree_stop.{_stop_seq}", payload=1 if local_stop else 0)
        return any(bool(r) for r in rows if r is not None)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return bool(local_stop)
    from sartsolver_tpu_torch.parallel import comm

    flags = _deadline_collective(
        "agree_stop",
        lambda: comm.all_gather_host(np.asarray([1 if local_stop else 0], np.int64)),
        barrier_timeout())
    return bool(flags.any())
