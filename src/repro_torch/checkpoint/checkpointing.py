"""Async checkpointing in the reference package's on-disk layout.

Layout:  <dir>/step_<N>/
           manifest.json   {step, leaves: {key: {file, shape, dtype}}}
           <flatkey>.npy   one file per leaf

The layout is the reference's, key for key and byte for byte, so a
checkpoint written by either package restores in the other. A
``bfloat16`` leaf is written as its 16-bit patterns under the manifest
dtype ``"bfloat16"`` (numpy has no such type without ``ml_dtypes``).

Properties:
  * async: save snapshots the tree to host memory (a copy: the train
    step updates its state in place) and writes it on a background
    thread; training continues.
  * atomic: written into step_<N>.tmp then renamed - a crash mid-save
    never corrupts the latest checkpoint.
  * retention: keep_n newest checkpoints are retained.
  * restore lands every leaf on the device it is given (the card unless
    named), or, given a mesh and a spec tree, each leaf of the tree as a
    DTensor under its spec's placements on the mesh's device: the
    elastic reshard (the mesh may differ from the one that saved). A
    leaf is placed before the next is read, so a rank holds its shards
    and one whole leaf at most on the device.
  * sharded state (DTensor leaves) is gathered a leaf at a time on every
    rank (a collective: every rank calls ``save``); only rank 0 copies
    it to host memory and writes, and the ranks meet at a barrier once
    the write is done (``wait``, or before a blocking ``save`` returns).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.bitvector import resolve_device
from ..models.sharding_ctx import checked_mesh, distribute

SEP = "/"
BF16 = "bfloat16"


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            out.extend(_flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    return [(prefix.rstrip(SEP), tree)]


def _unflatten(items: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in items.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array of its own (no storage shared with the
    live tensor) and the manifest's dtype name."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._barrier = False   # a sharded save's ranks have yet to meet

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        # Snapshot to host memory synchronously (cheap), write async.
        items = _flatten(tree)
        sharded = any(isinstance(v, DTensor) for _, v in items)
        writer = not sharded or dist.get_rank() == 0
        host = []
        for k, v in items:
            if isinstance(v, DTensor):
                v = v.full_tensor()     # every rank takes part
            if writer:
                host.append((k, *_to_host(v)))
        self.wait()
        if writer:
            if blocking:
                self._write(step, host)
            else:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host), daemon=True)
                self._thread.start()
        self._barrier = sharded
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr, dtype in host:
            fname = key.replace(SEP, "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, mesh=None,
                spec_tree=None, device=None) -> Tuple[int, Any]:
        """Load a checkpoint (the latest unless ``step``) onto ``device``
        (the card unless named); if (mesh, spec_tree) are given, each leaf
        the spec tree names becomes a DTensor under its spec's placements
        on the mesh's device - the elastic-resharding path (the mesh may
        differ from the one that saved)."""
        dev = resolve_device(device if checked_mesh(mesh) is None else
                             device or mesh.device_type)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        specs = dict(_flatten(spec_tree)) if spec_tree is not None else {}
        items = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            items[key] = _from_host(arr, meta["dtype"], dev)
            if mesh is not None and key in specs:
                items[key] = distribute(items[key], mesh, specs[key])
        return step, _unflatten(items)
