"""Logical-axis sharding: mesh-agnostic models, mesh-specific placement
(the reference's ``parallel/sharding.py`` on a torch ``DeviceMesh``).

Parameters carry *logical* axes ("fsdp", "tp", "heads", ...); this module
resolves them to mesh axes under the active mesh.  Resolution silently
drops a mesh axis whenever the dimension is not divisible by it (e.g.
hymba's 25 heads on a 16-way 'model' axis, internvl2's 92553 vocab) and
never uses one mesh axis twice in a spec, so every architecture shards as
far as its shapes allow and replicates the rest.

A spec is a tuple with one entry a tensor dimension: None (replicated), a
mesh axis name, or a tuple of names (the dimension split over several
axes, the first the major one), as the reference's ``PartitionSpec``.
``placements`` translates it into DTensor placements (``Shard(d)`` /
``Replicate()`` a mesh dimension); ``block`` gives a rank's contiguous
block of a global tensor under it, ``distribute`` a DTensor of it, and
``dim_block`` the block of one dimension a rank holds (sharded serving's
cache along ``kv_seq``); ``step_facts`` records, for one step, what the
host knows and its tensors cannot tell (the whole sizes its blocks were
cut from, its first position).

Tensor-parallel serving: ``tensor_parallel`` (a context the serving
engine enters) names the model group of the step -- the mesh axes of the
``tp`` rule, their size and this rank's index (``TensorParallel``) -- and
``tp_of(n)`` gives it where it splits a dimension of n (the divisibility
rule of ``_resolve``; outside the context, or over one rank, None, and the
layers run their whole-layer code).  Its collectives: ``all_reduce`` (the
sum of the ranks' partial products), ``gather_ranks`` (every rank's
tensor, stacked: an all-gather; the reshard of fresh K/V from ``heads``
to ``kv_seq`` is this all-gather and the owner's slice of the slots) and
``all_gather`` (concatenated along a dimension).  Over one rank none moves
anything; on ``meta`` (the dry run) each bills the tracer
(``kernels.flash_attention.META_TRACE``) at its group size and moves
nothing; on a mesh of sizes, which has no process group, a real tensor
over more than one rank raises.

Default rules (overridable per context):
  batch   -> ('pod', 'data')     a batch's leading dim (data parallelism)
  fsdp    -> 'data'              parameter / optimizer-state sharding (ZeRO-3)
  tp      -> 'model'             tensor-parallel dim (heads / ffn / vocab)
  kv_seq  -> 'model'             decode KV-cache sequence when heads < TP
  expert  -> 'model'             expert parallelism for MoE weight stacks

The reference's ``shard_map_compat`` papers over JAX versions' manual
sharding APIs; torch has no counterpart to paper over, and the port's
sharded train step calls the collectives itself (``train/step.py``).
"""
from __future__ import annotations

import math
import threading
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Optional[str]
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "heads": ("model",),
    "q_seq": ("model",),     # sequence parallelism when heads % tp != 0
    "kv_seq": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": (),
    "embed": (),
    "none": (),
}


class MeshContext(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)
        self.facts: Dict[str, int] = {}
        self.tp: Optional["TensorParallel"] = None


_CTX = MeshContext()


@contextmanager
def mesh_context(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh of this thread,
    with ``rules`` over the defaults."""
    prev_mesh, prev_rules, prev_tp = _CTX.mesh, _CTX.rules, _CTX.tp
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    _CTX.tp = None
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules, _CTX.tp = prev_mesh, prev_rules, prev_tp


def current_mesh():
    return _CTX.mesh


@contextmanager
def step_facts(facts: Mapping[str, int]):
    """Record, for the step run inside, what the host knows of it that its
    tensors cannot tell, or tell only by a device read (sharded serving:
    ``serve.engine`` records the global ``batch`` and the cross caches'
    ``enc_len`` that its cache's blocks were cut from, and the step's
    first ``position``); ``step_fact`` reads them."""
    prev = _CTX.facts
    _CTX.facts = {**prev, **facts}
    try:
        yield
    finally:
        _CTX.facts = prev


def step_fact(name: str) -> Optional[int]:
    """The value ``step_facts`` recorded under ``name``, or None."""
    return _CTX.facts.get(name)


# a DeviceMesh's axis sizes and this rank's coordinate, which never change:
# read once a mesh (its ``shape`` and ``get_coordinate`` cost tens of
# microseconds, and sharded serving asks at every attention layer)
_SIZES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_COORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _read_once(cache: "weakref.WeakKeyDictionary", mesh, read):
    """``read(mesh)``, kept for ``mesh`` in ``cache`` when it can be weakly
    referenced (a ``DeviceMesh``; a stand-in object is read every time)."""
    try:
        got = cache.get(mesh)
    except TypeError:
        return read(mesh)
    if got is None:
        got = cache[mesh] = read(mesh)
    return dict(got)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or of a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return _read_once(_SIZES, mesh,
                      lambda m: dict(zip(m.mesh_dim_names, m.shape)))


def axis_size(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 when absent)."""
    mesh = _CTX.mesh
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(name, 1)


def _resolve(logical: Sequence[Axis], shape: Sequence[int],
             sizes: Mapping[str, int]) -> Spec:
    """Map logical axis names to mesh axes, dropping non-divisible ones."""
    out: List[Entry] = []
    used: set = set()
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        mesh_axes = _CTX.rules.get(name, (name,) if name in sizes else ())
        picked = []
        size = 1
        for ax in mesh_axes:
            if ax in used or ax not in sizes:
                continue
            nsize = size * sizes[ax]
            if dim % nsize == 0:
                picked.append(ax)
                used.add(ax)
                size = nsize
        out.append(tuple(picked) if len(picked) > 1 else
                   (picked[0] if picked else None))
    return tuple(out)


def logical_spec(logical: Sequence[Axis], shape: Sequence[int],
                 mesh=None) -> Spec:
    """The spec of a tensor of ``shape`` with logical axes ``logical``
    under ``mesh`` (a ``DeviceMesh`` or a mapping of axis sizes; default:
    the active mesh).  ``()`` outside any mesh."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    return _resolve(logical, shape, mesh_shape(mesh))


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` for a
    mesh dimension that splits tensor dimension d, ``Replicate()`` for
    the others.  A dimension split over several axes must list them in
    the mesh's order (DTensor nests shards that way); another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def coordinate(mesh) -> Dict[str, int]:
    """This rank's index along every axis of ``mesh`` (a ``DeviceMesh``;
    of a mapping of axis sizes -- the dry run's mesh, which has no ranks
    -- its rank 0's)."""
    if isinstance(mesh, Mapping):
        return {a: 0 for a in mesh}
    return _read_once(_COORDS, mesh, lambda m: dict(
        zip(m.mesh_dim_names, m.get_coordinate())))


def rule_size(name: str, mesh=None) -> int:
    """How many blocks the rule of logical axis ``name`` cuts a dimension
    into when the dimension divides: the product of the sizes of its
    mesh axes present in ``mesh`` (default: the active mesh)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return 1
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in _CTX.rules.get(name, ())
                     if a in sizes)


def dim_block(name: str, n: int, mesh=None
              ) -> Tuple[int, int, Tuple[str, ...]]:
    """(start, width, axes): the block of a dimension of ``n`` elements
    with logical axis ``name`` that this rank holds under ``mesh``
    (default: the active mesh; a mapping of sizes stands for its rank 0),
    and the mesh axes that split it -- empty, with the whole dimension,
    outside a mesh or where the rule drops every axis (none divides
    ``n``)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return 0, n, ()
    spec = _resolve((name,), (n,), mesh_shape(mesh))
    sl = block(spec, (n,), mesh_shape(mesh), coordinate(mesh))[0]
    return sl.start, sl.stop - sl.start, entry_axes(spec[0])


def block(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int],
          coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of a global tensor of ``shape`` that the rank at
    ``coord`` holds under ``spec``: per dimension, block index
    sum(coord[a] * size of the axes after a) of ``prod(sizes)`` equal
    blocks."""
    out = []
    for d, n in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        idx, count = 0, 1
        for a in axes:
            idx, count = idx * sizes[a] + coord[a], count * sizes[a]
        width = n // count
        out.append(slice(idx * width, (idx + 1) * width))
    return tuple(out)


def distribute(x: torch.Tensor, spec: Spec, mesh):
    """A DTensor on ``mesh`` holding this rank's block of ``x`` (every rank
    passes the same global ``x``; no communication).  A block smaller
    than ``x`` is a copy: a slice along the first dimension is a
    contiguous view that would keep all of ``x``'s storage alive; the
    whole ``x`` is kept as it is (contiguous), with no copy."""
    from torch.distributed.tensor import DTensor
    local = x[block(spec, x.shape, mesh_shape(mesh), coordinate(mesh))]
    local = local.clone(memory_format=torch.contiguous_format) \
        if local.numel() < x.numel() else local.contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def shard(x: torch.Tensor, *logical: Axis):
    """``x`` laid out on the active mesh by its logical axes: a DTensor of
    the same global value (the reference's sharding constraint).  No-op
    outside a mesh context, so single-device runs are untouched."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} axes for rank-{x.ndim} tensor")
    return distribute(x, _resolve(logical, x.shape, mesh_shape(mesh)), mesh)


def shard_params(params, axes: Mapping[str, Sequence[Axis]], mesh=None
                 ) -> Dict[str, Optional[list]]:
    """Placements by leaf name for ``params`` (a module's
    ``named_parameters`` or a mapping of tensors) and their logical
    ``axes`` (e.g. ``Model.axes``) under ``mesh`` (default: the active
    mesh); None for every leaf outside a mesh."""
    mesh = mesh if mesh is not None else _CTX.mesh
    items = (params.named_parameters() if isinstance(params,
                                                     torch.nn.Module)
             else params.items())
    return {name: None if mesh is None else placements(
        _resolve(axes[name], tuple(t.shape), mesh_shape(mesh)), mesh)
        for name, t in items}


def replicas(spec: Spec, sizes: Mapping[str, int]) -> int:
    """How many ranks hold each block under ``spec``: the product of the
    sizes of the axes that do not split the tensor."""
    split = {a for e in spec for a in entry_axes(e)}
    return math.prod(n for a, n in sizes.items() if a not in split)


# ---------------------------------------------------------------------------
# tensor-parallel serving: the model group and its collectives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorParallel:
    """The model group of a serving step: the mesh ``axes`` of the ``tp``
    rule (more than one rank), their ``size``, this rank's index ``rank``
    along them and, on a ``DeviceMesh``, the process ``group`` (None on a
    mesh of sizes: the dry run's, meta tensors only)."""
    axes: Tuple[str, ...]
    size: int
    rank: int
    group: Any

    def block(self, n: int) -> Tuple[int, int]:
        """(start, width) of this rank's block of a dimension of ``n`` the
        group splits (``size`` divides it; checked)."""
        if n % self.size:
            raise ValueError(f"{self.size} ranks do not split {n}")
        w = n // self.size
        return self.rank * w, w


def tp_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes of the ``tp`` rule that hold more than one rank in
    ``mesh`` (default: the active mesh): the model group's."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    return tuple(a for a in _CTX.rules.get("tp", ()) if sizes.get(a, 1) > 1)


@contextmanager
def tensor_parallel():
    """Under the active mesh, the serving step's model group
    (``TensorParallel`` of the ``tp`` rule's mesh axes) for the layers
    run inside: each computes its share of the heads, ffn columns and
    vocabulary where the group splits them (``tp_of``).  No mesh, or a
    model axis of one rank: no group, and the layers run their whole-layer
    code.  The group is one mesh axis (the default rule's "model")."""
    mesh = _CTX.mesh
    group = None
    axes = tp_axes()
    if axes:
        sizes = mesh_shape(mesh)
        if len(axes) > 1:
            raise ValueError(f"tensor parallelism over one mesh axis, not "
                             f"{axes}")
        (a,) = axes
        real = not isinstance(mesh, Mapping)
        group = TensorParallel(axes, sizes[a], coordinate(mesh)[a],
                               mesh.get_group(a) if real else None)
    prev = _CTX.tp
    _CTX.tp = group
    try:
        yield group
    finally:
        _CTX.tp = prev


def tp() -> Optional[TensorParallel]:
    """The model group ``tensor_parallel`` entered, or None."""
    return _CTX.tp


def tp_of(n: int) -> Optional[TensorParallel]:
    """The model group where it splits a dimension of ``n`` (its size
    divides n, as ``_resolve`` keeps an axis), else None."""
    g = _CTX.tp
    return g if g is not None and n % g.size == 0 else None


def _meta_collective(opcode: str, result_bytes: int, n: int) -> None:
    """Bill the dry run's tracer one collective of ``result_bytes`` a rank
    over ``n`` ranks."""
    from ..kernels import flash_attention as fa
    if fa.META_TRACE is None:
        raise RuntimeError("a collective on the meta device runs only "
                           "under launch.roofline.analyze_step")
    fa.META_TRACE.collective(opcode, result_bytes, n)


def _groups(axes: Tuple[str, ...]):
    """(mesh, sizes, ranks along ``axes``) of the active mesh."""
    mesh = _CTX.mesh
    sizes = mesh_shape(mesh)
    return mesh, sizes, math.prod(sizes[a] for a in axes)


def gather_ranks(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """[n, *x.shape]: ``x`` of every rank along the active mesh's ``axes``
    (n ranks), stacked in rank order -- an all-gather over each axis's
    process group; for n == 1, ``x`` itself, with nothing moved.  On meta
    (the dry run) the gathered buffer is made and billed to the tracer
    as an all-gather; a mapping of sizes holds no process group, so it
    takes only n == 1 for real tensors."""
    mesh, sizes, n = _groups(axes)
    x = x.contiguous()[None]
    if n == 1:
        return x
    if x.is_meta:
        out = x.expand((n,) + tuple(x.shape[1:])).contiguous()
        _meta_collective("all-gather", out.numel() * out.element_size(), n)
        return out
    if isinstance(mesh, Mapping):
        raise ValueError("a mesh of sizes has no process group")
    import torch.distributed as dist
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    for a in reversed(axes):
        out = x.new_empty((sizes[a] * x.shape[0],) + tuple(x.shape[1:]))
        gather(out, x, group=mesh.get_group(a))
        x = out
    return x


def all_gather(x: torch.Tensor, dim: int, axes: Tuple[str, ...]
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated along ``dim`` in rank
    order (``gather_ranks``; ``x`` itself over one rank)."""
    got = gather_ranks(x, axes)
    if got.shape[0] == 1:
        return x
    dim = dim % x.ndim
    return got.movedim(0, dim).flatten(dim, dim + 1)


def all_reduce(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axes`` (the ranks' partial
    products of a split contraction), in ``x``'s dtype: an all-reduce
    over each axis's process group, in place on a contiguous ``x``; ``x``
    itself over one rank.  On meta, billed to the tracer as an
    all-reduce."""
    mesh, sizes, n = _groups(axes)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_meta:
        _meta_collective("all-reduce", x.numel() * x.element_size(), n)
        return x
    if isinstance(mesh, Mapping):
        raise ValueError("a mesh of sizes has no process group")
    import torch.distributed as dist
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x
