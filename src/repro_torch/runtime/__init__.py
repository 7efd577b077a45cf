"""Runtime: the fault-tolerant supervisor, straggler watchdog and elastic
mesh policy."""

from .fault_tolerance import (HostFailure, StragglerWatchdog, Supervisor,
                              elastic_mesh_shape)
