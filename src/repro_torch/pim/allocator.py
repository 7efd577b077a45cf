"""Row allocation for the PIM runtime (the Section 5.2 driver, grown up).

The seed `AmbitDevice.alloc_rows` was a bump cursor: rows could never be
freed or reused, so any workload with operand churn (the Section 8
database queries allocate intermediates per query) exhausted the device.
`RowAllocator` replaces it with a free-list allocator over
``(bank, subarray, row)`` slots that supports

  * ``free`` / reallocation - freed slots are reused lowest-address-first,
    deterministically;
  * per-subarray occupancy accounting (the planner's placement signal);
  * pluggable placement policies:
      - ``"striped"``   - round-robin banks fastest, then subarrays, then
        rows: corresponding rows of successive allocations land in the
        same subarray (the co-location contract) while the whole vector
        stripes across banks for bank-level parallelism (Fig. 21). This
        reproduces the seed bump-cursor order exactly when nothing has
        been freed, which keeps `AmbitDevice.alloc_rows` back-compatible.
      - ``"colocated"`` - fill one subarray before spilling to the next:
        operands allocated near each other share a subarray, so every
        staging copy is RowClone-FPM instead of PSM (affinity beats
        parallelism when chains of dependent ops dominate).
  * ``near=`` affinity - allocate in the subarrays already holding the
    given slots (the store's migration planner and the query planner use
    this to co-locate results with their operands).

The top ``scratch_rows`` rows of every subarray can be reserved so PSM
staging (which the device model writes into the top of the D-group) can
never clobber allocated data.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.simulator import AmbitError

Slot = Tuple[int, int, int]  # (bank, subarray, row)

STRIPED = "striped"
COLOCATED = "colocated"
POLICIES = (STRIPED, COLOCATED)


class RowAllocator:
    """Free-list allocator over the D-group rows of an Ambit device."""

    def __init__(self, banks: int, subarrays: int, data_rows: int,
                 scratch_rows: int = 0, policy: str = STRIPED):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r} (use {POLICIES})")
        if banks < 1 or subarrays < 1:
            raise ValueError("need at least one bank and subarray")
        self.banks = banks
        self.subarrays = subarrays
        self.data_rows = data_rows
        self.scratch_rows = scratch_rows
        self.usable_rows = data_rows - scratch_rows
        if self.usable_rows < 1:
            raise ValueError("scratch reservation leaves no allocatable rows")
        self.policy = policy
        # Per-subarray state: rows [0, _virgin) have been handed out at
        # least once; freed rows below the virgin cursor sit in a min-heap.
        self._virgin: Dict[Tuple[int, int], int] = {}
        self._freed: Dict[Tuple[int, int], List[int]] = {}
        self._occupancy: Dict[Tuple[int, int], int] = {}
        for b in range(banks):
            for s in range(subarrays):
                self._virgin[(b, s)] = 0
                self._freed[(b, s)] = []
                self._occupancy[(b, s)] = 0
        self._live: set = set()
        # Quarantined slots are retired for the life of the allocator:
        # never handed out again, subtracted from capacity, and listed
        # in report() so CI can prove zero leaks (reliability layer).
        self._quarantined: set = set()
        self._q_by_sub: Dict[Tuple[int, int], int] = {}

    @classmethod
    def for_device(cls, device, scratch_rows: int = 0,
                   policy: str = STRIPED) -> "RowAllocator":
        return cls(len(device.banks), len(device.banks[0].subarrays),
                   device.geom.data_rows, scratch_rows, policy)

    # -- introspection -------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.banks * self.subarrays * self.usable_rows \
            - len(self._quarantined)

    @property
    def live(self) -> int:
        return len(self._live)

    @property
    def free_slots(self) -> int:
        return self.capacity - self.live

    @property
    def utilization(self) -> float:
        """Fraction of usable rows currently live (the cluster placement
        signal: packed/affinity policies pick the least-loaded device)."""
        return self.live / self.capacity

    def shortfall(self, n_rows: int) -> int:
        """How many rows short of an ``n_rows`` allocation the device is
        (0 = it fits). The spill loop evicts until this reaches zero
        instead of probing with throwaway failed allocations."""
        return max(0, n_rows - self.free_slots)

    def occupancy(self, bank: int, subarray: int) -> int:
        """Number of live slots in one subarray."""
        return self._occupancy[(bank, subarray)]

    def subarray_free(self, bank: int, subarray: int) -> int:
        return self.usable_rows - self._occupancy[(bank, subarray)] \
            - self._q_by_sub.get((bank, subarray), 0)

    def is_live(self, slot: Slot) -> bool:
        return tuple(slot) in self._live

    @property
    def quarantined(self) -> int:
        return len(self._quarantined)

    @property
    def quarantined_slots(self) -> frozenset:
        return frozenset(self._quarantined)

    def report(self) -> dict:
        """Accounting snapshot: every retired row must appear here (the
        chaos CI job asserts quarantine never leaks slots)."""
        return {
            "capacity": self.capacity,
            "live": self.live,
            "free": self.free_slots,
            "quarantined": len(self._quarantined),
            "quarantined_slots": sorted(self._quarantined),
        }

    # -- allocation ----------------------------------------------------------

    def _purge_quarantined(self, key: Tuple[int, int]) -> None:
        """Drop retired rows from the subarray's free structures: pop
        them off the freed heap and step the virgin cursor over them
        (lazily, so quarantine stays O(1))."""
        if not self._quarantined:
            return
        freed = self._freed[key]
        while freed and (key[0], key[1], freed[0]) in self._quarantined:
            heapq.heappop(freed)
        v = self._virgin[key]
        while v < self.usable_rows \
                and (key[0], key[1], v) in self._quarantined:
            v += 1
        self._virgin[key] = v

    def _lowest_free_row(self, key: Tuple[int, int]) -> Optional[int]:
        self._purge_quarantined(key)
        freed = self._freed[key]
        virgin = self._virgin[key]
        if freed:
            return min(freed[0], virgin) if virgin < self.usable_rows \
                else freed[0]
        return virgin if virgin < self.usable_rows else None

    def _take_row(self, key: Tuple[int, int]) -> int:
        """Pop the lowest free row of a subarray (caller checked non-full)."""
        self._purge_quarantined(key)
        freed = self._freed[key]
        virgin = self._virgin[key]
        if freed and (virgin >= self.usable_rows or freed[0] < virgin):
            row = heapq.heappop(freed)
        else:
            row = virgin
            self._virgin[key] = virgin + 1
        slot = (key[0], key[1], row)
        self._live.add(slot)
        self._occupancy[key] += 1
        return row

    def _pick_subarray(self, policy: str,
                       prefer: Sequence[Tuple[int, int]] = ()) -> Optional[
                           Tuple[int, int]]:
        """Choose the subarray the next slot comes from.

        Affinity subarrays (in order) win when they have space. Otherwise
        striped order minimizes (row, subarray, bank) - the seed bump-cursor
        order - and colocated order minimizes (bank, subarray) among
        non-full subarrays (fill one subarray, then move on)."""
        for key in prefer:
            if self._lowest_free_row(key) is not None:
                return key
        best = None
        best_rank = None
        for b in range(self.banks):
            for s in range(self.subarrays):
                row = self._lowest_free_row((b, s))
                if row is None:
                    continue
                rank = (row, s, b) if policy == STRIPED else (b, s, row)
                if best_rank is None or rank < best_rank:
                    best, best_rank = (b, s), rank
        return best

    def alloc(self, n_rows: int, policy: Optional[str] = None,
              near: Optional[Iterable[Slot]] = None) -> List[Slot]:
        """Allocate ``n_rows`` slots. Raises AmbitError when the device is
        full (no partial allocation survives a failure)."""
        policy = self.policy if policy is None else policy
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}")
        prefer: List[Tuple[int, int]] = []
        if near:
            seen = set()
            for b, s, _ in near:
                if (b, s) not in seen:
                    seen.add((b, s))
                    prefer.append((b, s))
        out: List[Slot] = []
        try:
            for _ in range(n_rows):
                key = self._pick_subarray(policy, prefer)
                if key is None:
                    raise AmbitError(
                        f"device full ({self.live}/{self.capacity} rows "
                        f"live)")
                out.append((key[0], key[1], self._take_row(key)))
        except AmbitError:
            self.free(out)
            raise
        return out

    def alloc_in(self, bank: int, subarray: int, n_rows: int) -> List[Slot]:
        """Allocate in exactly one subarray (placement-exact; used by the
        migration planner). Raises AmbitError when it doesn't fit."""
        key = (bank, subarray)
        if self.subarray_free(bank, subarray) < n_rows:
            raise AmbitError(
                f"subarray ({bank},{subarray}) full: "
                f"{self.subarray_free(bank, subarray)} free, "
                f"{n_rows} requested")
        return [(bank, subarray, self._take_row(key)) for _ in range(n_rows)]

    # -- freeing -------------------------------------------------------------

    def free(self, slots: Iterable[Slot]) -> None:
        for slot in slots:
            slot = tuple(slot)
            if slot not in self._live:
                raise AmbitError(f"free of non-live slot {slot}")
            self._live.remove(slot)
            b, s, r = slot
            heapq.heappush(self._freed[(b, s)], r)
            self._occupancy[(b, s)] -= 1

    # -- quarantine ----------------------------------------------------------

    def quarantine(self, slots: Iterable[Slot]) -> None:
        """Retire faulty rows permanently (the reliability layer's
        re-placement contract: a quarantined row is never allocated
        again). Live slots must be freed first; repeats are no-ops."""
        for slot in slots:
            slot = tuple(slot)
            b, s, r = slot
            if not (0 <= b < self.banks and 0 <= s < self.subarrays
                    and 0 <= r < self.usable_rows):
                raise AmbitError(
                    f"cannot quarantine non-allocatable slot {slot}")
            if slot in self._live:
                raise AmbitError(
                    f"cannot quarantine live slot {slot} (free it first)")
            if slot in self._quarantined:
                continue
            self._quarantined.add(slot)
            self._q_by_sub[(b, s)] = self._q_by_sub.get((b, s), 0) + 1
