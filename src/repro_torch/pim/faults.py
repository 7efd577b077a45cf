"""The reliability layer's error type.

Only ``FaultError`` lives here for now, so that the scheduler's import
path matches the reference package's; ``FaultInjector`` and
``ReliabilityManager`` are ported with the ``ambit_sim`` PIM runtime
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core.simulator import AmbitError

__all__ = ["FaultError"]


class FaultError(AmbitError):
    """An injected (or detected) fault. ``kind`` labels the metric
    series; ``device``/``slot`` name the faulty site so recovery can
    re-place away from it."""

    def __init__(self, msg: str, kind: str = "fault",
                 device: Optional[int] = None,
                 slot: Optional[Tuple[int, int, int]] = None):
        super().__init__(msg)
        self.kind = kind
        self.device = device
        self.slot = slot
