"""PIM runtime: resident bitvectors, row allocation and placement-aware
query planning over the Ambit device model, and its accelerator twin.

  RowAllocator                 - free-list (bank, subarray, row) allocation
  PimStore / ResidentBitVector - bitvectors living in simulated DRAM
                                 (LRU spill/eviction when the device fills)
  QueryPlanner                 - whole-Expr batched AAP scheduling
  PimCluster / ClusterBitVector- N devices behind one store API: sharded
                                 placement, channel cost model, cross-device
                                 colocation, per-device sub-plans
  AsyncScheduler / Ticket      - submit/drain queue packing bank/device-
                                 disjoint queries into concurrent epochs
  DeviceStore / DeviceBitVector- the accelerator twin of PimStore: tensors
                                 resident on the card across calls, one
                                 fused (stacked) launch per epoch
  AmbitRuntime                 - the session API applications use
                                 (devices=N shards across a cluster;
                                 backend="torch"/"cuda" runs resident on
                                 the accelerator)

The DRAM model's row state lives on the session's torch device - the card
unless the caller names another.
"""

from .allocator import COLOCATED, POLICIES, RowAllocator, STRIPED, Slot
from .cluster import (AFFINITY, ChannelLedger, ChannelModel, CLUSTER_POLICIES,
                      ClusterBitVector, ClusterPlanner, ClusterReport,
                      PACKED, PimCluster, ROUND_ROBIN)
from .device_store import DeviceBitVector, DevicePlanner, DeviceStore
from .planner import PlanReport, QueryPlanner
from .runtime import AmbitRuntime
from .scheduler import (AsyncScheduler, DrainReport, EpochReport, Ticket)
from .store import PimStore, ResidentBitVector

__all__ = [
    "AFFINITY", "AmbitRuntime", "AsyncScheduler", "COLOCATED",
    "ChannelLedger", "ChannelModel", "CLUSTER_POLICIES", "ClusterBitVector",
    "ClusterPlanner", "ClusterReport", "DeviceBitVector", "DevicePlanner",
    "DeviceStore", "DrainReport", "EpochReport",
    "PACKED", "PimCluster", "PimStore", "PlanReport", "POLICIES",
    "QueryPlanner", "ResidentBitVector", "ROUND_ROBIN", "RowAllocator",
    "STRIPED", "Slot", "Ticket",
]
