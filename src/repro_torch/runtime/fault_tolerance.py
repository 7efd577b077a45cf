"""Fault tolerance: supervised step loop, straggler watchdog, elastic mesh.

The Supervisor wraps the training loop with checkpoint/restart semantics:
on a (simulated or real) host failure it restores the latest checkpoint
and continues - with a *smaller* mesh if hosts were lost (elastic).
Plain Python, as in the reference; the tests exercise it with injected
failures (tests/test_torch_train_infra.py).

Over a mesh (sharded state: ``mesh`` and ``spec_tree`` set) every rank
runs the loop, and its decisions must be the same on every rank, or the
step's collectives would deadlock: a failure injected (or raised) on any
rank before a step is agreed over the whole mesh, so every rank restores
together, onto the mesh (``restore(mesh=, spec_tree=)``).

Straggler mitigation: per-step wall times feed an EWMA; steps slower than
`threshold x` the EWMA are flagged, and the policy hook decides (re-issue
the batch / drop the host from the next elastic mesh). At 1000+ nodes this
watchdog runs on the coordinator with per-host step acks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..checkpoint.checkpointing import Checkpointer


class HostFailure(RuntimeError):
    """Raised (or injected) when a host drops out mid-step."""

    def __init__(self, lost_hosts: int = 1):
        super().__init__(f"lost {lost_hosts} host(s)")
        self.lost_hosts = lost_hosts


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor (Section: straggler mitigation)."""

    alpha: float = 0.1
    threshold: float = 3.0
    ewma: Optional[float] = None
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        # slow steps don't poison the baseline estimate
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        else:
            self.flagged.append(step)
        return slow


def elastic_mesh_shape(n_devices: int, model_parallel: int
                       ) -> Dict[str, int]:
    """Largest (data, model) mesh using <= n_devices with fixed TP degree.
    Elastic policy: TP degree is preserved (resharding TP weights is
    expensive); the data axis shrinks to what survives."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than TP degree")
    data = n_devices // model_parallel
    return {"data": data, "model": model_parallel}


@dataclasses.dataclass
class Supervisor:
    """Checkpoint/restart wrapper around a step loop."""

    checkpointer: Checkpointer
    checkpoint_every: int = 50
    max_restarts: int = 10
    watchdog: StragglerWatchdog = dataclasses.field(
        default_factory=StragglerWatchdog)
    device: Optional[str] = None    # where a restore lands (the card)
    mesh: Any = None                # sharded state: the mesh it lies on
    spec_tree: Any = None           # and its specs (restore places them)

    def _agreed(self, failure: Optional[HostFailure]
                ) -> Optional[HostFailure]:
        """The failure any rank of the mesh saw (the most hosts lost), on
        every rank; None when no rank failed."""
        if self.mesh is None:
            return failure
        lost = torch.tensor([failure.lost_hosts if failure else 0],
                            dtype=torch.int64,
                            device=torch.device(self.mesh.device_type))
        for i in range(self.mesh.ndim):
            dist.all_reduce(lost, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(i))
        n = int(lost.item())
        return failure or (HostFailure(n) if n else None)

    def run(self, state, data_fn: Callable[[int], dict],
            step_fn: Callable, start_step: int, n_steps: int,
            on_restore: Optional[Callable] = None,
            failure_injector: Optional[Callable[[int], None]] = None):
        """Runs steps [start_step, n_steps); returns (state, history).

        A restore lands the checkpoint on ``device``; `on_restore(state_tree)
        -> state` lets the caller adapt it after a failure."""
        step = start_step
        restarts = 0
        history: List[Dict] = []
        while step < n_steps:
            try:
                t0 = time.monotonic()
                failure = None
                if failure_injector is not None:
                    try:
                        failure_injector(step)
                    except HostFailure as e:
                        failure = e
                failure = self._agreed(failure)
                if failure is not None:
                    raise failure
                batch = data_fn(step)
                state, metrics = step_fn(state, batch)
                dt = time.monotonic() - t0
                slow = self.watchdog.observe(step, dt)
                history.append({"step": step, "dt": dt, "slow": slow,
                                **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.checkpoint_every == 0:
                    self.checkpointer.save(step, state)
            except HostFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                # a save in flight lands first (on every rank, over a
                # mesh), so every rank sees the same latest step
                self.checkpointer.wait()
                restore_step = self.checkpointer.latest_step()
                if restore_step is None:
                    restore_step, tree = start_step, None
                else:
                    restore_step, tree = self.checkpointer.restore(
                        mesh=self.mesh, spec_tree=self.spec_tree,
                        device=self.device)
                if tree is not None:
                    state = on_restore(tree) if on_restore else tree
                step = restore_step
                history.append({"step": step, "restart": restarts})
        self.checkpointer.save(n_steps, state, blocking=True)
        return state, history
