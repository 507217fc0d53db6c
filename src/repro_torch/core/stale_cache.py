"""Device-resident stale-update cache (SAA straggler store); port of the
single-tensor half of ``repro.core.stale_cache``.

The rows live on the device: a ``(capacity + 1, D)`` fp32 tensor whose last
row is a scratch slot, plus host-side slot accounting (free list + insertion
order).  The round pipeline scatters a round's straggler deltas into their
slots and gathers landing slots straight into the aggregation operand, so a
delta never leaves the device.

Slot discipline (``_SlotSpace``):

- ``alloc(k)`` reserves ``k`` slots; a full cache doubles its capacity, so
  nothing is ever dropped (the reference engine's ``grow=True`` mode).
- ``free(slots)`` releases landed/expired slots for reuse, LIFO.  Slot
  choice never affects values: a slot's row is always scatter-written in
  the round its entry is created, before any gather reads it.
- growth appends slots: existing ids stay valid, and the old scratch row
  becomes a data slot whose stale content is irrelevant.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class _SlotSpace:
    """Free-list + insertion-order accounting for one slot space
    ``[0, capacity)``."""

    def __init__(self, capacity: int):
        # pop() hands out ascending slot ids for a fresh space
        self.free = list(range(capacity - 1, -1, -1))
        self.order: "OrderedDict[int, int]" = OrderedDict()   # slot -> seq

    def __len__(self) -> int:
        return len(self.order)

    def extend(self, old_capacity: int, new_capacity: int) -> None:
        """Append the minted slot ids; existing free slots are consumed
        before the new ones (they sit deeper in the LIFO free list)."""
        self.free[:0] = range(new_capacity - 1, old_capacity - 1, -1)

    def take(self, seq: int) -> int:
        s = self.free.pop()
        self.order[s] = seq
        return s

    def release(self, slot: int) -> None:
        del self.order[slot]          # KeyError on double-free: a real bug
        self.free.append(slot)


class DeviceStaleCache:
    def __init__(self, d: int, capacity: int = 64, *, device):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.d = int(d)
        self.capacity = int(capacity)
        self.rows = torch.zeros((self.capacity + 1, self.d), dtype=torch.float32,
                                device=device)
        self._space = _SlotSpace(self.capacity)
        self._seq = 0
        self.grow_events = 0

    def __len__(self) -> int:
        return len(self._space)

    @property
    def trash_slot(self) -> int:
        """The scratch row."""
        return self.capacity

    def occupied(self) -> list:
        """Occupied slot ids in insertion order."""
        return list(self._space.order)

    def _grow(self):
        old_c = self.capacity
        # the old scratch row (index old_c) becomes data slot old_c
        self.rows = torch.cat([self.rows, self.rows.new_zeros((old_c, self.d))])
        self.capacity = 2 * old_c
        self._space.extend(old_c, self.capacity)
        self.grow_events += 1

    def alloc(self, k: int) -> list:
        """Reserve ``k`` slots; returns them in allocation order."""
        while len(self._space.free) < k:
            self._grow()
        slots = []
        for _ in range(k):
            slots.append(self._space.take(self._seq))
            self._seq += 1
        return slots

    def free(self, slots) -> None:
        for s in slots:
            self._space.release(s)

    # host-facing row IO (tests); the round pipeline scatters and gathers
    # on the device instead
    def put(self, slots, rows) -> None:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.rows.device)
        self.rows[idx] = torch.as_tensor(rows, dtype=torch.float32,
                                         device=self.rows.device)

    def gather(self, slots) -> np.ndarray:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.rows.device)
        return self.rows[idx].cpu().numpy()
