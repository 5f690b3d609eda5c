"""Training step (the reference's ``train/step.py``): gradient
accumulation, mixed precision, global-norm clipping, AdamW, and the
sharded step with the int8 pod compression.

The model's leaves are float32 masters (``nn.Parameter``, requires grad).
A step casts every float32 leaf to ``compute_dtype`` once
(``models.model.compute_view``), before the microbatch loop, and
differentiates that copy: the bf16 gradients reach the masters through the
cast and are accumulated there in float32 (``.grad``), then averaged over
``accum``.  ``compute_dtype=None`` differentiates the masters themselves.
Peak activation memory is one microbatch's, the blocks rematerialized by
the config's ``remat_policy``.

**Sharded state** (``init_state(..., mesh=...)``, a ``DeviceMesh`` with
axes among "pod", "data", "model"): every master, both AdamW moments and
the error-feedback residual ``err`` of a leaf are DTensors split over the
mesh axes its logical axes resolve to (``Model.axes`` through
``parallel.sharding``: fsdp -> data; tp / heads / vocab / expert ->
model); ``step`` and ``count`` are replicated.  The same ``step``
function then
  * takes this rank's block of the global batch by the ``batch`` rule
    (("pod", "data"); ranks along "model" take the same block),
  * all-gathers each leaf's compute copy whole, cast to
    ``compute_dtype`` before the gather (2-byte payloads), in
    ``compute_view`` -- the only gather of a leaf,
  * returns each float32 gradient to its leaf's layout in the backward:
    reduce-scattered over the batch axes that split the leaf, cut to the
    rank's block along the others, all-reduced over the batch axes that
    do not (after the microbatches), averaged over pod x data; with
    ``compress_pod`` the pod part is the int8 error-feedback all-gather
    of ``train/compress.py``,
  * runs AdamW on the blocks, ``global_norm`` counting each element once,
  * reports the loss averaged over the batch ranks.
The "model" axis shards memory, not compute: every rank computes every
head and every ffn column of its batch block (the reference's GSPMD
splits that work; tensor-parallel compute is a later port item).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.power import Device
from ..models import model as M
from ..models.config import ArchConfig
from ..optim import adamw
from ..parallel import sharding as sh


class TrainState(NamedTuple):
    model: M.Model
    opt: adamw.OptState
    step: torch.Tensor                         # int32 scalar
    err: Optional[List[torch.Tensor]] = None   # error feedback (compression)


def init_state(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               device: Device = None, compress_pod: bool = False,
               mesh=None) -> TrainState:
    """Float32 trainable masters drawn from ``generator`` (a generator on
    ``device``; default: one seeded with 0) on ``device`` (default: the
    mesh's device type, else the CUDA card; "meta" allocates nothing),
    zero moments, step 0, and with ``compress_pod`` zero residuals.  With
    a ``mesh``, every rank draws the whole model and keeps its blocks
    (``shard_state``)."""
    if device is None and mesh is not None:
        device = mesh.device_type
    model = M.init_model(cfg, generator, device=device, trainable=True)
    opt = adamw.init(model.parameters())
    err = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in model.parameters()] if compress_pod else None)
    state = TrainState(model=model, opt=opt,
                       step=torch.zeros((), dtype=torch.int32,
                                        device=opt.count.device), err=err)
    return state if mesh is None else shard_state(state, mesh)


def state_axes(model: M.Model, compress_pod: bool = False) -> TrainState:
    """The state's logical axes (the reference's ``train_state_specs``
    second half): masters, moments and ``err`` by leaf, as lists in
    ``named_parameters`` order; ``()`` for the scalars."""
    axes = list(model.axes.values())
    return TrainState(model=model.axes, opt=adamw.state_axes(axes), step=(),
                      err=axes if compress_pod else None)


def shard_state(state: TrainState, mesh) -> TrainState:
    """``state`` with every leaf's master, moments and residual replaced by
    a DTensor on ``mesh`` holding this rank's block (specs from the
    model's logical axes under the active rules); no communication."""
    model = state.model
    specs = [sh.logical_spec(model.axes[name], p.shape, mesh)
             for name, p in model.named_parameters()]
    dist = lambda ts: [sh.distribute(t.detach(), s, mesh)
                       for t, s in zip(ts, specs)]
    M.replace_parameters(model, dist(model.parameters()))
    opt = adamw.OptState(m=dist(state.opt.m), v=dist(state.opt.v),
                         count=state.opt.count)
    err = None if state.err is None else dist(state.err)
    return TrainState(model, opt, state.step, err)


def decay_mask(model: M.Model) -> List[bool]:
    """Per leaf of ``model.parameters()``: whether AdamW decays it.  The
    reference decays a leaf with ``ndim >= 2`` on its own shapes, where a
    layer group's leaves carry the stacked ``repeats`` axis: every leaf in
    a layer is decayed, norm scales included, and only top-level 1-D
    leaves (``final_norm``, ``enc_final_norm``) are exempt."""
    return [p.ndim >= 2 or not name.startswith("top.")
            for name, p in model.named_parameters()]


def _to_device(batch: Dict, device: torch.device) -> Dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _split_microbatches(batch: Dict, accum: int) -> List[Dict]:
    """``accum`` microbatches cut along the leading axis, in order."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def _accumulate(view, cfg: ArchConfig, batch: Dict, accum: int,
                device: torch.device) -> torch.Tensor:
    """The loss summed over ``accum`` microbatches of ``batch``, each one's
    backward run through ``view``."""
    loss = torch.zeros((), device=device)
    for mb in _split_microbatches(_to_device(batch, device), accum):
        mb_loss = M.forward_train(view, cfg, mb)
        mb_loss.backward()
        loss = loss + mb_loss.detach()
    return loss


def make_grads_fn(cfg: ArchConfig, accum: int = 1,
                  compute_dtype: Optional[torch.dtype] = torch.bfloat16
                  ) -> Callable:
    """``grads_fn(model, batch) -> (loss, grads)``: the mean loss over the
    ``accum`` microbatches and each master's float32 gradient (the
    ``.grad`` tensors, in ``model.parameters()`` order), averaged over
    them.  ``batch``: tensors on the model's device, or numpy arrays."""

    def grads_fn(model: M.Model, batch: Dict
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = _accumulate(M.compute_view(model, compute_dtype), cfg, batch,
                           accum, params[0].device)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if accum > 1:
            inv = 1.0 / accum
            for g in grads:
                g.mul_(inv)
            loss = loss * inv
        return loss, grads

    return grads_fn


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    """All-gather ``x`` along dim ``d`` over ``group`` (rank order)."""
    import torch.distributed as dist
    xs = x.movedim(d, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    # all_gather_single is all_gather_into_tensor's newer name
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, xs, group=group)
    return out.movedim(0, d)


def _reduce_scatter(g: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    """Sum ``g`` over ``group`` and keep this rank's block along dim d."""
    import torch.distributed as dist
    gs = g.movedim(d, 0).contiguous()
    out = gs.new_empty((gs.shape[0] // n,) + tuple(gs.shape[1:]))
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, gs, group=group)
    return out.movedim(0, d)


class _GatherLeaf(torch.autograd.Function):
    """Forward: a master's block cast to ``dtype`` (None: as it is) and
    all-gathered whole over the axes that split it (minor axis first).
    Backward: the float32 gradient of the whole leaf returned to the
    block's layout, major axis first -- reduce-scattered over the batch
    axes, cut to this rank's block along the others (their ranks
    computed the same gradient)."""

    @staticmethod
    def forward(ctx, local, spec, mesh, batch_axes, dtype):
        ctx.spec, ctx.mesh, ctx.batch_axes = spec, mesh, batch_axes
        sizes = sh.mesh_shape(mesh)
        x = local if dtype is None else local.to(dtype)
        for d, entry in enumerate(spec):
            for a in reversed(sh.entry_axes(entry)):
                x = _gather(x, d, mesh.get_group(a), sizes[a])
        return x.contiguous() if x is not local else x.clone()

    @staticmethod
    def backward(ctx, g):
        sizes, coord = sh.mesh_shape(ctx.mesh), sh.coordinate(ctx.mesh)
        g = g.float()
        for d, entry in enumerate(ctx.spec):
            for a in sh.entry_axes(entry):
                if a in ctx.batch_axes:
                    g = _reduce_scatter(g, d, ctx.mesh.get_group(a), sizes[a])
                else:
                    w = g.shape[d] // sizes[a]
                    g = g.narrow(d, coord[a] * w, w)
        return g.contiguous(), None, None, None, None


def _spec_of(p) -> sh.Spec:
    """The spec of a DTensor's placements (mesh order is major first)."""
    entries = [[] for _ in range(p.ndim)]
    for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def _norm(spec: sh.Spec) -> Tuple[Tuple[str, ...], ...]:
    return tuple(sh.entry_axes(e) for e in spec)


def _sharded_step(state: TrainState, batch: Dict, cfg: ArchConfig,
                  opt_cfg: adamw.AdamWConfig, accum: int,
                  compute_dtype: Optional[torch.dtype], compress_pod: bool
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    import torch.distributed as dist
    from .compress import make_compressed_sync
    model = state.model
    named = list(model.named_parameters())
    mesh = named[0][1].device_mesh
    sizes, coord = sh.mesh_shape(mesh), sh.coordinate(mesh)
    specs = []
    for name, p in named:
        spec = _spec_of(p)
        want = sh.logical_spec(model.axes[name], p.shape, mesh)
        if p.device_mesh != mesh or _norm(spec) != _norm(want):
            raise ValueError(f"{name}: sharded as {spec}, its axes "
                             f"{model.axes[name]} resolve to {want}")
        specs.append(spec)
    split = [{a for e in s for a in sh.entry_axes(e)} for s in specs]

    b = next(iter(batch.values())).shape[0]
    bspec = sh.logical_spec(("batch",), (b,), mesh)
    batch_axes = sh.entry_axes(bspec[0])
    rows = sh.block(bspec, (b,), sizes, coord)[0]
    n_pods = sizes["pod"] if "pod" in batch_axes else 1
    n_rest = math.prod(sizes[a] for a in batch_axes if a != "pod")
    if compress_pod and any("pod" in s for s in split):
        raise ValueError("compress_pod: a parameter is split over 'pod'")

    with torch.no_grad():
        masters = [p.to_local().detach().requires_grad_() for _, p in named]
    leaf_of = {id(p): (m, s) for (_, p), m, s in zip(named, masters, specs)}

    def gathered(p):
        local, spec = leaf_of[id(p)]
        return _GatherLeaf.apply(local, spec, mesh, batch_axes,
                                 compute_dtype)

    view = M.compute_view(model, compute_dtype, leaf=gathered)
    loss = _accumulate(view, cfg, {k: v[rows] for k, v in batch.items()},
                       accum, masters[0].device) / accum
    del view

    grads = []
    for m, s in zip(masters, split):
        g = m.grad if m.grad is not None else torch.zeros_like(m)
        for a in batch_axes:
            if a != "pod" and a not in s:
                dist.all_reduce(g, group=mesh.get_group(a))
        g.mul_(1.0 / (accum * n_rest * (n_pods if "pod" in s else 1)))
        grads.append(g)
    err = state.err
    if n_pods > 1 and compress_pod:
        grads, new_err = make_compressed_sync(mesh)(
            grads, [e.to_local() for e in err])
        with torch.no_grad():
            for e, n in zip(err, new_err):
                e.to_local().copy_(n)
    elif n_pods > 1:
        for g, s in zip(grads, split):
            if "pod" not in s:
                dist.all_reduce(g, group=mesh.get_group("pod"))
                g.mul_(1.0 / n_pods)
    for a in batch_axes:
        dist.all_reduce(loss, group=mesh.get_group(a))
    loss = loss / math.prod(sizes[a] for a in batch_axes)

    with torch.no_grad():
        local = lambda ts: [t.to_local() for t in ts]
        opt, metrics = adamw.apply_updates(
            local(model.parameters()), grads,
            adamw.OptState(local(state.opt.m), local(state.opt.v),
                           state.opt.count),
            opt_cfg, decay_mask(model),
            replicas=[sh.replicas(s, sizes) for s in specs],
            groups=[mesh.get_group(a) for a in mesh.mesh_dim_names])
    metrics["loss"] = loss
    return TrainState(model, adamw.OptState(state.opt.m, state.opt.v,
                                            opt.count),
                      state.step + 1, err), metrics


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    accum: int = 1,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    compress_pod: bool = False, mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``: gradients over
    ``accum`` microbatches, then AdamW in place on the masters (the
    reference's weight-decay rule, ``decay_mask``).  ``metrics``: ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors on the device (reading one
    waits for the step).  ``batch``: the global batch (numpy arrays or
    tensors).

    A state sharded on a mesh (``init_state(..., mesh=...)`` or a
    checkpoint restored under one) takes the sharded step (module
    docstring); its leaves must lie as ``state.model.axes`` resolve on
    that mesh.  The mesh is the state's own: ``mesh``, when given, only
    asserts it, and a state that is not sharded on ``mesh`` raises.
    ``compress_pod`` needs the mesh and a state made with
    ``compress_pod``; at one pod it is the identity."""
    from torch.distributed.tensor import DTensor
    if compress_pod and mesh is None:
        raise ValueError("compress_pod needs the mesh")
    grads_fn = make_grads_fn(cfg, accum, compute_dtype)

    def step(state: TrainState, batch: Dict
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = list(state.model.parameters())
        sharded = isinstance(params[0], DTensor)
        if mesh is not None and not (sharded
                                     and params[0].device_mesh == mesh):
            where = params[0].device_mesh if sharded else "no mesh"
            raise ValueError("the state is not sharded on the step's mesh "
                             f"(its leaves lie on {where})")
        if sharded:
            if compress_pod and state.err is None:
                raise ValueError("compress_pod: the state has no err "
                                 "(init_state(..., compress_pod=True))")
            return _sharded_step(state, batch, cfg, opt_cfg, accum,
                                 compute_dtype, compress_pod)
        loss, grads = grads_fn(state.model, batch)
        opt, metrics = adamw.apply_updates(params, grads, state.opt,
                                           opt_cfg, decay_mask(state.model))
        for p in params:
            p.grad = None
        metrics["loss"] = loss
        return TrainState(state.model, opt, state.step + 1,
                          state.err), metrics

    return step
