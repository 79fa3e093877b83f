"""The tile-skip operator: dense storage + block-sparse tile index. A copy
of ``sartsolver_tpu/operators/tileskip.py`` over this package's
``ops/sparse.py``.

Identical staging and resident footprint to :class:`DenseOperator` —
the matrix IS materialized — plus the
:class:`~sartsolver_tpu_torch.ops.sparse.TileOccupancy` index that lets the
fused panel sweep skip all-zero (pixel-block x voxel-panel) tiles. The
index rides the operator so the cache key distinguishes a tile-skip
program family from the dense one (they compile differently), and the
byte accounting charges the packed bitmap on top of the matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sartsolver_tpu_torch.operators.dense import DenseOperator
from sartsolver_tpu_torch.ops.sparse import TileOccupancy


class TileSkipOperator(DenseOperator):
    """Materialized ``H`` with a block-sparse tile-occupancy index."""

    kind = "tileskip"

    def __init__(self, rtm: Optional[np.ndarray],
                 occupancy: TileOccupancy, *,
                 npixel: Optional[int] = None,
                 nvoxel: Optional[int] = None, dtype=None):
        super().__init__(
            rtm, npixel=npixel, nvoxel=nvoxel, dtype=dtype
        )
        if not isinstance(occupancy, TileOccupancy):
            raise TypeError(
                f"TileSkipOperator needs a TileOccupancy, got "
                f"{type(occupancy).__name__}"
            )
        self._occupancy = occupancy

    def tile_occupancy(self) -> TileOccupancy:
        return self._occupancy

    def resident_nbytes(self) -> int:
        return super().resident_nbytes() + len(self._occupancy.packed)

    def cache_key(self) -> str:
        occ = self._occupancy
        return (
            f"tileskip:{self.npixel}x{self.nvoxel}:{self._dtype.name}:"
            f"occ={occ.digest:08x}"
        )


__all__ = ["TileSkipOperator"]
