"""Device meshes over ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the default process group with the
reference's axis names: ``("data", "model")`` on one pod and
``("pod", "data", "model")`` across pods. Every rank of the group calls
these functions together. The process group comes from a launcher
(``torchrun``/``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``
and the rendezvous) or from ``init_process_group``, which starts a
one-rank group when no launcher did.

Meshes run on the card unless the caller names ``device="cpu"`` (the
``gloo`` backend; the card takes NCCL).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.bitvector import resolve_device
from ..models.sharding_ctx import mesh_shape_dict

__all__ = ["PRODUCTION_MESHES", "backend_for", "init_process_group",
           "make_host_mesh", "make_production_mesh", "mesh_shape_dict"]

# (shape, axis names) of the production meshes: 256 chips on one pod,
# 512 across two; the "pod" axis composes with "data" for DP/FSDP (and
# optionally hosts pipeline stages)
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def backend_for(device) -> str:
    """The process-group backend for a device type: NCCL on the card,
    gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device=None) -> bool:
    """Join the default process group: the launcher's when its
    environment is set (one rank a process; on the card each rank takes
    card ``LOCAL_RANK``), else a one-rank group of this process over a
    file store in a temporary directory. Returns whether this call
    started the group (the caller then ends it with
    ``destroy_process_group``); a group already up is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend_for(dev))
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                             "store")
        dist.init_process_group(backend_for(dev),
                                init_method=f"file://{store}",
                                rank=0, world_size=1)
    return True


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None) -> DeviceMesh:
    """Single pod: (16,16) ("data","model") = 256 ranks. Multi-pod:
    (2,16,16) ("pod","data","model") = 512 ranks. The process group must
    hold exactly that many ranks."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the process group (tests / local
    runs), on the card unless ``device`` names another."""
    return _mesh((data, model), ("data", "model"), device)


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "launch.mesh.init_process_group or a launcher")
    size = 1
    for n in shape:
        size *= n
    if dist.get_world_size() != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


