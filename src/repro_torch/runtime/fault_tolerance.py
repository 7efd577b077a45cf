"""Fault tolerance: supervised step loop, straggler watchdog, elastic mesh.

The Supervisor wraps the training loop with checkpoint/restart semantics:
on a (simulated or real) host failure it restores the latest checkpoint
and continues - with a *smaller* mesh if hosts were lost (elastic).
Plain Python, as in the reference; the tests exercise it with injected
failures (tests/test_torch_train_infra.py).

Straggler mitigation: per-step wall times feed an EWMA; steps slower than
`threshold x` the EWMA are flagged, and the policy hook decides (re-issue
the batch / drop the host from the next elastic mesh). At 1000+ nodes this
watchdog runs on the coordinator with per-host step acks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

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
                if failure_injector is not None:
                    failure_injector(step)
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
                restore_step = self.checkpointer.latest_step()
                if restore_step is None:
                    restore_step, tree = start_step, None
                else:
                    self.checkpointer.wait()
                    restore_step, tree = self.checkpointer.restore(
                        device=self.device)
                if tree is not None:
                    state = on_restore(tree) if on_restore else tree
                step = restore_step
                history.append({"step": step, "restart": restarts})
        self.checkpointer.save(n_steps, state, blocking=True)
        return state, history
