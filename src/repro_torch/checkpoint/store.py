"""Async checkpointing with elastic re-sharding on restore (the
reference's ``checkpoint/store.py``).

Checkpoints store LOGICAL arrays (a sharded leaf gathered whole, as numpy)
so a restore may target a *different* mesh than the save -- the elastic
path: each leaf is re-split by its logical axes under the mesh given to
``restore``.

Layout (the reference's, file for file):
         <dir>/step_<n>/manifest.json  (step, extra, treedef, leaves)
         <dir>/step_<n>/leaf_<i>.npy   (one a leaf, in flatten order)
         <dir>/LATEST                  (atomic pointer file, via LATEST.tmp)
A step is written into ``<dir>/.tmp_step_<n>`` and renamed into place.

Trees are flattened as JAX flattens them -- dicts by sorted key, lists
and tuples in order, None as no leaf -- so each package reads the
other's checkpoints of such trees; a NamedTuple's fields go in order, a
module's parameters in ``named_parameters`` order.  bf16 leaves are
stored as float32.

Writes happen on a background thread (the train loop pays only for the
copy to host memory); ``wait()`` joins it and raises an error the writer
met, and ``save`` of step N+1 joins the previous write first, so at most
one checkpoint is in flight.  Under ``torch.distributed`` every rank calls
``save`` (the gathers are collective), rank 0 writes, and ``wait`` ends
in a barrier so every rank then sees the files.
"""
from __future__ import annotations

import copy
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.power import Device, resolve_device
from ..models.model import replace_parameters
from ..parallel import sharding as sh


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a container node in flatten order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if isinstance(tree, nn.Module):
        return [(n.replace(".", "/"), p) for n, p in tree.named_parameters()]
    raise TypeError


def _is_container(tree) -> bool:
    return isinstance(tree, (dict, list, tuple, nn.Module))


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for k, c in _children(tree):
        out += _flatten(c, f"{prefix}/{k}" if prefix else k)
    return out


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, nn.Module):
        return f"{type(tree).__name__}[{len(list(tree.parameters()))}]"
    if not _is_container(tree):
        return "*"
    if isinstance(tree, list) and not any(map(_is_container, tree)):
        return f"list[{len(tree)}]"
    inner = ", ".join(f"{k}={_describe(c)}" for k, c in _children(tree))
    return f"{type(tree).__name__}({inner})"


def _to_host(v) -> np.ndarray:
    """A leaf as a numpy array the caller's later in-place updates cannot
    reach: a DTensor gathered whole, a tensor copied to host memory."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.to("cpu", copy=True).numpy()
    return np.array(v)


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Gather to host then write asynchronously (rank 0)."""
        self.wait()
        host_leaves = [(k, _to_host(v)) for k, v in _flatten(tree)]
        if _distributed():
            import torch.distributed as dist
            if dist.get_rank() != 0:
                return
        treedef = _describe(tree)

        def _write():
            try:
                tmp = self.dir / f".tmp_step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = dict(step=step, extra=extra or {},
                                treedef=treedef,
                                leaves=[k for k, _ in host_leaves])
                for i, (k, v) in enumerate(host_leaves):
                    np.save(tmp / f"leaf_{i}.npy", v)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                (self.dir / "LATEST.tmp").write_text(str(step))
                (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _distributed():
            import torch.distributed as dist
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = self.dir / "LATEST"
        if not p.exists():
            return None
        return int(p.read_text().strip())

    def restore(self, step: Optional[int], like, mesh=None, axes=None,
                device: Device = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (real tensors or a
        ``meta``-device skeleton; numpy leaves stay numpy).  Tensors take
        ``like``'s dtypes, on ``device`` (default: the mesh's device type,
        else a ``like`` tensor's own device, else the CUDA card).  Under a
        ``mesh``, each tensor leaf with logical axes in ``axes`` (a tree
        parallel to ``like``: a module's by parameter name, e.g.
        ``train.step.state_axes``) becomes a DTensor split by those axes
        under the mesh and the active rules; the others are whole on every
        rank."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        names = [k for k, _ in _flatten(like)]
        if names != manifest["leaves"]:
            raise ValueError(f"step {step}: the checkpoint's leaves "
                             f"{manifest['leaves'][:4]}... are not the "
                             f"tree's {names[:4]}...")
        leaves = iter([np.load(d / f"leaf_{i}.npy")
                       for i in range(len(manifest["leaves"]))])
        if device is None and mesh is not None:
            device = mesh.device_type

        def place(arr: np.ndarray, ref, ax):
            if not isinstance(ref, torch.Tensor):
                return arr
            dev = device
            if dev is None:
                dev = (ref.device_mesh.device_type if hasattr(
                    ref, "device_mesh") else ref.device)
                dev = resolve_device(None if str(dev) == "meta" else dev)
            t = torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)
            if mesh is None or not ax or len(ax) != t.ndim:
                return t
            return sh.distribute(t, sh.logical_spec(ax, t.shape, mesh), mesh)

        return _unflatten(like, leaves, axes, place), manifest["extra"]


def _unflatten(like, leaves: Iterator, axes, place):
    """``like``'s structure filled from ``leaves`` (flatten order)."""
    if like is None:
        return None
    sub = lambda key: None if axes is None else (
        axes[key] if isinstance(axes, (dict, list, tuple)) and not
        _is_namedtuple(axes) else getattr(axes, key))
    if isinstance(like, nn.Module):
        # a copy of the module that shares like's parameters, which are
        # then replaced in the copy alone
        out = copy.deepcopy(like, memo={id(p): p for p in like.parameters()})
        replace_parameters(out, [place(next(leaves), p, sub(name))
                                 for name, p in like.named_parameters()])
        return out
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves, sub(k), place)
               for k in sorted(like)}
        return {k: got[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(getattr(like, f), leaves, sub(f),
                                       place) for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(c, leaves, sub(i), place)
                          for i, c in enumerate(like))
    return place(next(leaves), like, axes)
