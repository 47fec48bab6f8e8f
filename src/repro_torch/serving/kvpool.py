"""Slot-based KV-cache pool for continuous batching: the port of the JAX
package's ``repro.serving.kvpool``.

The pool owns one fixed **arena**: the model cache tree built for
``max_slots`` sequences (every leaf carries the slot dimension at axis 1,
after the layer-stack axis: ``(layers, max_slots, ...)``).  Requests are
mapped onto slots by a free-list allocator; each slot tracks its own
position counter, so sequences at different depths share one batched
decode (``models.decode.decode_step_ragged``).

Slot lifecycle:

* ``alloc()``: pop the lowest free slot id (deterministic ordering) and
  **zero its cache**.  Attention KV beyond a slot's position is masked out
  anyway, but recurrent (SSM) state is not, so a stale occupant would
  corrupt the next request;
* ``read_slot`` / ``write_slot``: copy one slot's cache slice out as a
  batch-1 tree / back in, for chunked prefill;
* ``write_slots``: copy the given slots of a whole-arena tree in (the
  commit of a masked decode);
* ``free()``: return the slot to the free list (eviction on request
  completion; the next ``alloc`` re-zeros it).

The arena's tensors are written in place (``narrow``, ``index_copy_``).
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D

Tree = Any

#: the slot (sequence) axis of every arena leaf; axis 0 is the layer stack
SLOT_AXIS = 1


class PoolExhausted(RuntimeError):
    """``alloc`` was called with no free slot (admission should gate on
    ``n_free`` instead of trying)."""


class KVSlotPool:
    """Fixed arena + free-list slot allocator + per-slot position counters.

    Construct with a prebuilt arena (tests) or via :meth:`create` (the
    scheduler path, which builds the arena with ``models.decode.init_cache``
    so each family gets its native cache layout: ring-buffer KV, MLA
    latent, SSM state, and for audio the self KV beside every layer's cross
    K/V, each leaf with the slot axis).
    """

    def __init__(self, arena: Tree, max_slots: int):
        leaves = TR.leaves(arena)
        if not leaves:
            raise ValueError("arena must have at least one leaf")
        for l in leaves:
            if l.dim() <= SLOT_AXIS or l.shape[SLOT_AXIS] != max_slots:
                raise ValueError(
                    f"arena leaf {tuple(l.shape)} does not carry {max_slots} "
                    f"slots at axis {SLOT_AXIS}")
        self.arena = arena
        self.max_slots = int(max_slots)
        self.positions = np.zeros(self.max_slots, np.int32)
        self._free: List[int] = list(range(self.max_slots))
        self._used: set = set()

    @classmethod
    def create(cls, cfg: ModelConfig, max_slots: int, max_len: int,
               window_override: Optional[int] = None,
               device=None) -> "KVSlotPool":
        if max_slots <= 0:
            raise ValueError("max_slots must be positive")
        arena = D.init_cache(cfg, max_slots, max_len, window_override,
                             device=device)
        return cls(arena, max_slots)

    # ------------------------------------------------------------ free list

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    @property
    def occupancy(self) -> float:
        return self.n_used / self.max_slots

    def alloc(self) -> int:
        """Claim the lowest free slot, zeroing its cache and position."""
        if not self._free:
            raise PoolExhausted(
                f"all {self.max_slots} slots in use (gate admission on "
                "n_free)")
        slot = self._free.pop(0)
        self._used.add(slot)
        self.positions[slot] = 0
        for l in TR.leaves(self.arena):
            l.narrow(SLOT_AXIS, slot, 1).zero_()
        return slot

    def free(self, slot: int) -> None:
        """Evict a completed request's slot back to the free list."""
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self.positions[slot] = 0
        # keep the free list sorted so allocation order is deterministic
        self._free = sorted(self._free + [slot])

    # -------------------------------------------------------- slot slicing

    def _check(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")

    def read_slot(self, slot: int) -> Tree:
        """A batch-1 copy of one slot's cache (for chunked prefill)."""
        self._check(slot)
        return TR.tree_map(lambda l: l.narrow(SLOT_AXIS, slot, 1).clone(),
                           self.arena)

    def write_slot(self, slot: int, slot_cache: Tree) -> None:
        self._check(slot)
        for l, s in zip(TR.leaves(self.arena), TR.leaves(slot_cache)):
            l.narrow(SLOT_AXIS, slot, 1).copy_(s)

    def write_slots(self, slots: torch.Tensor, arena: Tree) -> None:
        """Copy the rows ``slots`` (an index tensor on the arena's device)
        of a whole-arena tree ``arena`` into the pool's arena; every other
        slot keeps its bytes.  A leaf that is the pool's own tensor (the
        audio cross K/V, which a decode step passes through) is skipped."""
        for l, n in zip(TR.leaves(self.arena), TR.leaves(arena)):
            if n is not l:
                l.index_copy_(SLOT_AXIS, slots,
                              n.index_select(SLOT_AXIS, slots))
