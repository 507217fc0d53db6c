"""Sweep-axis sharding: mesh, cell placement and migration (port of
``repro.sweeps.sharding`` onto ``torch.distributed``).

The sweep subsystem's cells are independent simulations, so they
partition over the round mesh's axis ``"s"`` with no cross-cell
communication: each s-rank runs the round of its own block of cells
(``repro_torch.sim.pipeline``).

``sweep_mesh``
    The round mesh with every rank of the default process group on the
    sweep axis (one rank without a group: the sharded code path still
    runs).  ``repro_torch.sim.participant_sharding`` owns the 2-D
    builders; ``SweepRunner(shard_participants=)`` composes the two.

``Placement``
    The cell -> (shard, local slot) assignment.  Cells are split into
    balanced contiguous blocks (ascending cell index); every shard's local
    rows are padded to one shared power-of-two bucket ``s_loc`` plus one
    scratch row (the padding target of empty aggregation groups).

Shard-aware repacking: when early-stopped cells shrink the live set
enough that the bucketed per-shard capacity drops, the pipeline builds a
smaller ``Placement``: live cells compact across shard boundaries, so
every rank's live rows shrink together (the busiest rank sets a lockstep
round's wall time).  Migration is pure row movement between ranks
(``reshard_rows``: one all-gather over the sweep axis, then a row gather),
so repacking never changes any cell's bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.aggregation import bucket_pow2
from repro_torch.sim.participant_sharding import (SWEEP_AXIS, all_gather,
                                                  n_ranks, round_mesh)


def sweep_mesh():
    """Round mesh over the sweep axis: every rank of the default process
    group on "s" (one without a group)."""
    return round_mesh(n_ranks(), 1)


def local_capacity(n_cells: int, n_shards: int) -> int:
    """Bucketed per-shard cell capacity: the power-of-two bucket of the
    balanced split's largest shard (>= 1 even for an empty live set)."""
    return bucket_pow2(max(-(-max(n_cells, 1) // n_shards), 1))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Cell -> (shard, local slot) assignment over the sweep axis.

    ``s_loc`` is the shared per-shard cell capacity (scratch row excluded);
    the global row of a cell in the flattened ``(n_shards * (s_loc+1), D)``
    view is ``shard * (s_loc + 1) + slot``, and each shard's scratch row
    (index ``s_loc`` locally) is the write target of padding aggregation
    groups — never a real cell.
    """
    n_shards: int
    s_loc: int
    shard_of: dict
    slot_of: dict
    shards: tuple           # shard -> tuple of its cells, ascending

    @staticmethod
    def build(cells, n_shards: int) -> "Placement":
        cells = sorted(cells)
        n = len(cells)
        s_loc = local_capacity(n, n_shards)
        sizes = [n // n_shards + (1 if j < n % n_shards else 0)
                 for j in range(n_shards)]
        shard_of, slot_of, shards, off = {}, {}, [], 0
        for j, size in enumerate(sizes):
            block = cells[off:off + size]
            off += size
            shards.append(tuple(block))
            for slot, c in enumerate(block):
                shard_of[c] = j
                slot_of[c] = slot
        return Placement(n_shards, s_loc, shard_of, slot_of, tuple(shards))

    @property
    def scratch_slot(self) -> int:
        return self.s_loc

    @property
    def rows_per_shard(self) -> int:
        return self.s_loc + 1

    @property
    def total_rows(self) -> int:
        return self.n_shards * (self.s_loc + 1)

    def flat_row(self, cell) -> int:
        return self.shard_of[cell] * (self.s_loc + 1) + self.slot_of[cell]

    def scratch_flat(self, shard: int) -> int:
        return shard * (self.s_loc + 1) + self.s_loc


# ---------------------------------------------------------------------------
# Migration: gather rows of the shards' (rows_loc, ...) blocks into a new
# layout.  Used for repacking (placement shrink) and for moving the sharded
# stale cache with it; both are pure data movement.
# ---------------------------------------------------------------------------


def reshard_rows(local: torch.Tensor, rows_idx, group) -> torch.Tensor:
    """Rows ``rows_idx`` of the s-group's old row space: every shard's
    (rows_loc, ...) block of ``group`` (an all-gather over it, in
    group-rank order; ``group`` None: ``local`` alone) stacked into one
    (n_shards * rows_loc, ...) space, and the rows a rank needs of it
    gathered.  The pipeline passes its own block's map of a new layout
    (the reference's ``new_to_old`` restricted to this shard) and the rows
    it must save; a new tensor, no arithmetic touches a row."""
    flat = torch.cat(all_gather(local, group))
    idx = torch.as_tensor(np.asarray(rows_idx, np.int64), device=local.device)
    return flat[idx]


__all__ = ["SWEEP_AXIS", "Placement", "local_capacity", "reshard_rows",
           "sweep_mesh"]
