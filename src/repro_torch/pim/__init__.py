"""PIM runtime on the accelerator: resident bitvectors and batched
query execution.

  AsyncScheduler / Ticket      - submit/drain queue packing queries into
                                 epochs, one kernel launch each
  DeviceStore / DeviceBitVector- tensors resident on the card across calls
                                 (LRU spill under a capacity budget)
  DevicePlanner                - one fused launch per expression / epoch
  AmbitRuntime                 - the session API applications use

The reference's DRAM-model runtime (RowAllocator, PimStore, QueryPlanner,
PimCluster, the optimizer and fault injection) is not ported yet.
"""

from .device_store import DeviceBitVector, DevicePlanner, DeviceStore
from .runtime import AmbitRuntime
from .scheduler import AsyncScheduler, DrainReport, EpochReport, Ticket

__all__ = [
    "AmbitRuntime", "AsyncScheduler", "DeviceBitVector", "DevicePlanner",
    "DeviceStore", "DrainReport", "EpochReport", "Ticket",
]
