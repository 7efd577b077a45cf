"""PIM runtime on the accelerator: resident bitvectors and batched
query execution.

  AsyncScheduler / Ticket      - submit/drain queue packing queries into
                                 epochs, one kernel launch each
  DeviceStore / DeviceBitVector- tensors resident on the card across calls
                                 (LRU spill under a capacity budget)
  DevicePlanner                - one fused launch per expression / epoch
  AmbitRuntime                 - the session API applications use
  RowAllocator                 - free-list (bank, subarray, row) allocation
                                 on the DRAM model (``AmbitDevice``)

The reference's DRAM-model runtime (PimStore, QueryPlanner, PimCluster,
the optimizer and fault injection) is not ported yet (ROADMAP queue 1
item 9).
"""

from .allocator import COLOCATED, POLICIES, RowAllocator, STRIPED, Slot
from .device_store import DeviceBitVector, DevicePlanner, DeviceStore
from .runtime import AmbitRuntime
from .scheduler import AsyncScheduler, DrainReport, EpochReport, Ticket

__all__ = [
    "AmbitRuntime", "AsyncScheduler", "COLOCATED", "DeviceBitVector",
    "DevicePlanner", "DeviceStore", "DrainReport", "EpochReport", "POLICIES",
    "RowAllocator", "STRIPED", "Slot", "Ticket",
]
