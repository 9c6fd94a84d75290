"""Row-block partitioning (SURVEY.md §2 C21: the reference's contiguous
MPI row partition, re-expressed for a 1-D device mesh).

Every grid (fine and coarse, every level) is split into ``nd`` contiguous
row blocks of identical padded size ``n_loc`` (a multiple of 128 so local
arrays are lane-aligned).  Because ``block == n_loc`` exactly, a global
column index ``c`` maps to shard ``c // n_loc`` at local offset
``c % n_loc`` — uniform across shards, which keeps every shard_map body
shape-identical and lets DIA offsets stay global (see dist.py).

Small levels may leave trailing shards empty (all-padding); those shards
still participate in collectives with zero contributions, which is exactly
how the reference handles idle ranks on tiny coarse grids.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous row-block partition of a size-``n`` index space over
    ``nd`` shards, each padded to ``n_loc`` (block == n_loc)."""
    n: int
    nd: int
    n_loc: int

    @classmethod
    def make(cls, n: int, nd: int, pad_multiple: int = 128) -> "Partition":
        n_loc = _round_up(max(-(-n // nd), 1), pad_multiple)
        return cls(n=n, nd=nd, n_loc=n_loc)

    @property
    def n_pad(self) -> int:
        """Total padded (blocked) global size."""
        return self.nd * self.n_loc

    def count(self, i: int) -> int:
        """Number of valid rows on shard i."""
        return int(np.clip(self.n - i * self.n_loc, 0, self.n_loc))

    def owner(self, c) -> np.ndarray:
        return np.asarray(c) // self.n_loc

    def pad_vec(self, v: np.ndarray) -> np.ndarray:
        """(n,) -> (nd, n_loc) blocked-padded layout.  Because block ==
        n_loc this is just zero-pad + reshape (the blocked layout IS the
        padded global ordering)."""
        return np.pad(np.asarray(v), (0, self.n_pad - self.n)).reshape(
            self.nd, self.n_loc)

    def unpad_vec(self, vp: np.ndarray) -> np.ndarray:
        """(nd, n_loc) -> (n,)."""
        return np.asarray(vp).reshape(-1)[: self.n]
