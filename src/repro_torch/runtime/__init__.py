"""Runtime: the fault-tolerant supervisor, straggler watchdog, elastic
mesh policy and the GPipe pipeline."""

from .fault_tolerance import (HostFailure, StragglerWatchdog, Supervisor,
                              elastic_mesh_shape)
from .pipeline import bubble_fraction, pipeline
