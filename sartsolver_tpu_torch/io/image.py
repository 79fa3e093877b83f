"""Composite measurement streamer: multi-camera time alignment + frame cache.

A copy of ``sartsolver_tpu/io/image.py`` for one contiguous pixel range,
without the fault-injection sites.

Re-implements the reference's ``CompositeImage`` (image.cpp): N cameras with
asynchronous clocks are merged into composite frames on a regular time grid —
a composite frame exists only when *every* camera has a frame within the sync
threshold of the grid tick. Frames are streamed with a block cache, applying
each camera's RTM ``frame_mask`` and slicing only this block's pixel range.

The alignment algorithm (``frame_indices_from_timepairs``,
image.cpp:110-196) is ported with its exact tie-breaking semantics:

- grid step auto-derived as max over cameras of min frame spacing,
- each camera frame bids on its nearest grid tick and both neighbors,
  a closer frame winning a tick (with TIME_EPSILON preferring the earlier
  frame on exact ties),
- consecutive identical index tuples are deduplicated, keeping the grid time
  whose total per-camera offset is smallest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from sartsolver_tpu_torch.io import h5
import numpy as np

from sartsolver_tpu_torch.config import SartInputError

TIME_EPSILON = 1.0e-10  # image.cpp:17


class CompositeImage:
    def __init__(
        self,
        image_files: Dict[str, str],
        rtm_frame_masks: Dict[str, np.ndarray],
        time_intervals: Sequence[Tuple[float, float, float, float]],
        npixel: int,
        offset_pixel: int = 0,
        max_cache_size: int = 100,
    ):
        """``(npixel, offset_pixel)`` selects one contiguous pixel range
        (the reference's per-rank slice, image.cpp:282-321)."""
        if npixel <= 0:
            raise ValueError("Argument npixel must be positive.")
        self.offset = int(offset_pixel)
        self.npix = int(npixel)
        self.files = dict(image_files)
        self.rtm_frame_masks = {k: np.asarray(v).ravel() for k, v in rtm_frame_masks.items()}
        self.max_cache_size = max_cache_size
        self.cache_offset = 0
        self._cached_frames: Optional[np.ndarray] = None  # [n_cached, npix]

        # composite frame tables
        self.frame_indices: List[List[int]] = []  # per frame: file index per camera
        self.camera_time: List[List[float]] = []
        self.time: List[float] = []

        self._read_frame_indices(time_intervals)
        self.cframe_index = len(self.time)  # "initial state" (image.cpp:38)

    # -- alignment --------------------------------------------------------
    def _read_frame_indices(self, time_intervals) -> None:
        """Load per-camera timelines and align (image.cpp:53-107)."""
        timelines = []
        for camera, filename in self.files.items():
            with h5.File(filename, "r") as f:
                timeline = np.asarray(f["image/time"], np.float64)
            if not np.all(np.diff(timeline) >= 0):
                raise SartInputError(
                    f"Image frames are not sorted by time in {filename}."
                )
            timelines.append(timeline)

        for (start, stop, step, threshold) in time_intervals:
            timepairs = []
            for tline in timelines:
                sel = (tline >= start) & (tline <= stop)
                idx = np.nonzero(sel)[0]
                timepairs.append([(float(tline[i]), int(i)) for i in idx])
            if any(len(tp) == 0 for tp in timepairs):
                continue
            self._frame_indices_from_timepairs(timepairs, step, threshold)

        if not self.frame_indices:
            raise SartInputError(
                "No composite images can be created for given time intervals."
            )

    def _frame_indices_from_timepairs(
        self,
        timepairs: List[List[Tuple[float, int]]],
        step: float,
        threshold: float,
    ) -> None:
        """Exact port of image.cpp:110-196."""
        min_time = min(tp[0][0] for tp in timepairs)
        max_time = max(tp[-1][0] for tp in timepairs)

        if step == 0:
            if (max_time - min_time) < TIME_EPSILON:
                step = 1.0  # all timepairs contain a single time moment
            else:
                for tp in timepairs:
                    min_diff = tp[-1][0] - tp[0][0]
                    for (t0, _), (t1, _) in zip(tp, tp[1:]):
                        min_diff = min(t1 - t0, min_diff)
                    step = max(min_diff, step)

        if step <= 0:
            # Every camera contributed a degenerate timeline (single frame or
            # duplicate timestamps) while the spread exceeds TIME_EPSILON —
            # no step can be derived. The reference would divide by zero
            # here; fail fast instead.
            raise SartInputError(
                "Unable to derive a composite time step; specify the step "
                "explicitly in the time range."
            )

        if threshold == 0:
            threshold = step

        # widen range by one step to avoid border checks (image.cpp:141-142)
        min_time -= step
        max_time += step

        ratio = (max_time - min_time) / step
        if not np.isfinite(ratio):
            # a denormal-scale step over a finite range: the tick indices
            # themselves overflow float arithmetic — an input error, not a
            # crash (the sparse grid below otherwise handles any finite
            # tiny step in O(frames))
            raise SartInputError(
                f"Time step {step} is too small for the time interval; "
                "specify a larger step in the time range."
            )
        max_num_frames = int(round(ratio)) + 1
        num_cam = len(timepairs)

        # SPARSE composite grid: slots exist only where a frame actually
        # bid (each frame bids on its nearest tick and both neighbors, so
        # slots are O(total frames), never O(time range / step)). The
        # reference allocates the DENSE grid (image.cpp:143-145), which
        # (a) explodes for a tiny step over a wide range (a user typo like
        # step=1e-9 would attempt a multi-TiB allocation here) and (b)
        # initializes unbid slots to the sentinel 1.01*threshold, which for
        # thresholds below ~100*TIME_EPSILON passes the completeness check
        # and emits bogus frame-0 indices — with absent-means-incomplete
        # slots both defects vanish. Every bid/tie/dedup rule below is the
        # reference's exactly: an absent slot competes as the sentinel
        # value (so an over-threshold first bid is rejected, never
        # retained to shadow a later closer bid), and TIME_EPSILON
        # prefers the earlier frame on exact ties (the table-driven
        # tie-break tests pin this).
        slots: Dict[Tuple[int, int], Tuple[float, int]] = {}
        sentinel = 1.01 * threshold  # image.cpp:145 initial slot value

        for icam, tp in enumerate(timepairs):
            for t, frame_idx in tp:
                iframe = int(round((t - min_time) / step))
                for i in (-1, 0, 1):  # bid on previous/this/next tick
                    key = (iframe + i, icam)
                    delta = t - min_time - (iframe + i) * step
                    cur = slots.get(key)
                    base = sentinel if cur is None else abs(cur[0])
                    if abs(delta) + TIME_EPSILON < base:
                        slots[key] = (delta, frame_idx)

        candidates = sorted({f for f, _ in slots})
        last_time_delta = 0.0
        for iframe in candidates:
            if not (1 <= iframe <= max_num_frames - 2):
                continue  # widened border ticks (image.cpp:141-142)
            iframe_indices: List[int] = []
            icamera_time: List[float] = []
            ftime = min_time + iframe * step
            time_delta = 0.0

            complete = True
            for icam in range(num_cam):
                slot = slots.get((iframe, icam))
                if slot is None or abs(slot[0]) > threshold + TIME_EPSILON:
                    complete = False
                    break
                delta, frame_idx = slot
                iframe_indices.append(int(frame_idx))
                icamera_time.append(ftime + delta)
                time_delta += abs(delta)

            if complete and len(iframe_indices) == num_cam:
                if not self.frame_indices or iframe_indices != self.frame_indices[-1]:
                    self.frame_indices.append(iframe_indices)
                    self.camera_time.append(icamera_time)
                    self.time.append(ftime)
                elif time_delta + TIME_EPSILON < last_time_delta:
                    # same frames, but closer to this tick: move the time
                    self.time[-1] = ftime
                last_time_delta = time_delta

    # -- streaming --------------------------------------------------------
    def __len__(self) -> int:
        return len(self.time)

    def is_cached(self, i: int) -> bool:
        return (
            self._cached_frames is not None
            and self.cache_offset <= i < self.cache_offset + self._cached_frames.shape[0]
        )

    def frame(self, i: Optional[int] = None) -> np.ndarray:
        if i is None:
            i = 0 if self.cframe_index == len(self.time) else self.cframe_index
        if i >= len(self.time):
            raise IndexError(f"Index {i} is out of bounds ({len(self.time)}).")
        if not self.is_cached(i):
            self._cache_hdf5(i)
        self.cframe_index = i
        return self._cached_frames[i - self.cache_offset].copy()

    def next_frame(self) -> Optional[np.ndarray]:
        """Advance and return the next composite frame, or None at the end
        (image.cpp:226-233 returns bool + out-arg)."""
        if self.cframe_index + 1 == len(self.time):
            return None
        nxt = 0 if self.cframe_index == len(self.time) else self.cframe_index + 1
        return self.frame(nxt)

    def frame_time(self, i: Optional[int] = None) -> float:
        return self.time[self.cframe_index if i is None else i]

    def camera_frame_time(self, i: Optional[int] = None) -> List[float]:
        return self.camera_time[self.cframe_index if i is None else i]

    def _cache_hdf5(self, itime: int) -> None:
        """Fill the block cache starting at composite frame ``itime``
        (image.cpp:268-331): per overlapping camera, hyperslab-read each
        needed frame once, compress via the RTM frame mask, and keep this
        instance's pixel range.

        Named fault site ``hdf5.frame_read`` (``resilience/faults.py``): the
        whole cache fill is the retry unit of the prefetcher's frame-read
        retry loop, and a failed fill leaves the cache untouched; a ``nan``
        or ``corrupt`` fault perturbs the block read."""
        from sartsolver_tpu_torch.resilience import faults

        faults.fire(faults.SITE_FRAME_READ)
        cache_size_t = min(self.max_cache_size, len(self.time) - itime)
        cached = np.zeros((cache_size_t, self.npix))
        lo_need, hi_need = self.offset, self.offset + self.npix

        start_pixel = 0
        for icam, (camera, mask) in enumerate(self.rtm_frame_masks.items()):
            npixel_masked = int(np.sum(mask != 0))
            cam_end = start_pixel + npixel_masked
            lo, hi = max(lo_need, start_pixel), min(hi_need, cam_end)
            if hi > lo:
                mask_indices = np.nonzero(mask != 0)[0].astype(np.int64)
                sl = mask_indices[lo - start_pixel:hi - start_pixel]
                with h5.File(self.files[camera], "r") as f:
                    dset = f["image/frame"]
                    for it in range(cache_size_t):
                        frame_idx = self.frame_indices[itime + it][icam]
                        full = np.asarray(dset[frame_idx], np.float64).ravel()
                        cached[it, lo - lo_need:hi - lo_need] = full[sl]
            start_pixel = cam_end
            if hi_need <= start_pixel:
                break

        self._cached_frames = faults.corrupt(faults.SITE_FRAME_READ, cached)
        self.cache_offset = itime
