"""Dry run of every (arch x shape) cell on the production mesh (the
reference's ``launch/dryrun.py``): per device, whether the step fits a
card, its FLOPs and bytes, its collective traffic, which roofline term
dominates and how much of the counted work is useful.

The reference lowers and compiles each step for 256 or 512 placeholder
devices.  The port runs one rank's step on ``meta`` tensors instead
(``launch.roofline.analyze_step``): nothing is allocated, no process group
is made, and the mesh is only a mapping of axis sizes -- {"data": 16,
"model": 16}, or with ``--multi-pod`` {"pod": 2, "data": 16, "model": 16}.

The rank's step is the sharded train step's (``train/step.py``):
  * masters and both AdamW moments are the rank's blocks of each leaf, by
    its logical axes (``parallel.sharding.logical_spec`` over the sizes);
  * its batch block is ``global_batch / (pod x data)`` rows (the ``batch``
    rule), in ``accum`` microbatches (the reference's rule: min(8, global
    batch / (pod x data)));
  * each leaf's bf16 compute copy is made whole for the step (the
    all-gathers of ``_GatherLeaf``) and each microbatch's float32 gradient
    cut back to the block (its reduce-scatters), here by ``_MetaGather``,
    which moves no data;
  * AdamW runs on the blocks.
The "model" axis shards the train step's memory, not its compute
(ROADMAP item 12c): a rank's dot FLOPs are the whole model on its batch
block, so on the 16 x 16 mesh a train cell's ``useful_flops_ratio``
(the model FLOPs a device's share of the mesh over the FLOPs it counts)
is about 1/16.

A serving cell's step is the rank's tensor-parallel serving step
(``serve/engine.py``), traced under ``parallel.sharding.mesh_context`` of
the sizes, for the mesh's rank 0 (``serving_pattern``: "tensor_parallel"
where the model axis holds more than one rank, "gather_weights_split_cache"
where only the batch axes split, "whole" on one device):
  * the rank holds its blocks of the serving parameters (bf16 matrices,
    float32 1-D leaves) as the train step holds its masters; a leaf of
    ``models.model.tp_leaves`` is read as the rank's block along "model",
    made whole only along the other axes that split it, any other leaf a
    mesh axis splits is made whole where the step reads it
    (``engine.gathered_view``; here ``_meta_view_leaf``, which moves no
    data) and dropped after its layer; a leaf no axis splits is read in
    place;
  * the step runs under ``parallel.sharding.tensor_parallel``: the rank's
    dot FLOPs are its heads' (or, where the heads do not divide the model
    axis and the prompt does, its query rows'), its ffn columns' and its
    vocabulary block's; MLA, the MoE and the recurrent blocks compute
    whole;
  * its cache is its block (``serve.cache.zeros(..., mesh=...)``): split
    along ``batch`` over ("pod", "data") and along ``kv_seq`` over "model"
    where they divide, the recurrent states whole on the model ranks
    (``cache_sharded``: whether any leaf is split; ``memory.cache_bytes``:
    the rank's block);
  * a prefill attends its fresh K/V; a decode step over a split cache
    attends the rank's block of it and all-gathers (out, lse) over the
    model ranks to combine them (``models/layers.py``).
A decode cell's cache holds ``seq_len - 1`` positions of history (each
ring slot its latest) and the step decodes position ``seq_len - 1``.

The collectives are counted from the step's own pattern, each op billed
by ``roofline.collective_bytes`` at its group size:
  * per leaf, an all-gather of the compute copy over each axis that
    splits it and that the step reads whole (major axis last, the
    payload growing): training once a step, serving at each read of the
    leaf (a layer's leaves once, a tied embedding twice), billed as the
    trace reaches it;
  * serving's tensor-parallel collectives, billed by the layers' own
    calls as the trace reaches them (``parallel.sharding``'s helpers
    through ``roofline._Tracer.collective``): the all-reduce of each
    attention's and MLP's output projection and of the embedding, the
    all-gather of the logits along the vocabulary (of the query rows
    after ``wo`` in the fallback), the fresh K/V's all-gather along the
    heads where a cache takes them, a decode's query heads' all-gather
    and the (out, lse) all-gather of each attention layer whose cache
    ``kv_seq`` is split;
  * training, per microbatch, a reduce-scatter of the float32 gradient
    over each batch axis that splits the leaf; after the microbatches an
    all-reduce over each batch axis that does not, and over "pod"; the
    loss's and the gradient norm's scalar all-reduces.  The step is the
    uncompressed one: ``compress_pod``'s int8 exchange is not counted.

Record keys are the reference's wherever they mean the same thing:
  * ``lower_s`` + ``compile_s`` -> ``trace_s`` (the meta run's seconds);
  * ``hlo`` -> ``counted`` (``StepAnalysis.merged``: the reference's
    keys, plus ``bytes_read``, ``bytes_accessed``, ``peak_live_bytes``
    and the attention kernels' ``kernel_flops`` / ``kernel_calls``);
  * ``memory.fits_16gb`` -> ``memory.fits_card``, against
    ``mesh.CARD_MEMORY_BYTES`` (``memory.card_bytes``);
  * ``memory.temp_bytes`` is the traced peak above the arguments, the
    step's new outputs included, so ``peak_per_device_bytes`` =
    ``argument_bytes + temp_bytes`` (the reference's ``output - alias``
    term is inside it);
  * ``cost_analysis`` is dropped: XLA's figure that counts a loop body
    once has no counterpart;
  * new: ``batch_per_device``, ``cache_sharded``, ``serving_pattern``
    (None for a train cell), ``memory.cache_bytes``.
``roofline`` divides ``counted.bytes_accessed`` (not ``bytes_written``:
``launch/roofline.py`` says why).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k [--multi-pod] [--accum 8] [--out-dir build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import configs
from ..kernels import flash_attention as fa
from ..models import costs as costs_mod
from ..models import model as M
from ..models.config import ArchConfig
from ..optim import adamw
from ..parallel import sharding as sh
from ..serve import cache as C
from ..serve import engine
from ..train import step as T
from . import mesh as mesh_mod
from . import specs as S
from .roofline import StepAnalysis, analyze_step, roofline_terms

META = torch.device("meta")


@dataclass
class _Cell:
    fn: Callable                       # the rank's step, on meta
    known: Dict                        # meta tensor -> its values
    argument_bytes: int
    cache_bytes: int
    batch_per_device: int
    collectives: Callable[[StepAnalysis], None]
    serving_pattern: Optional[str] = None
    cache_sharded: bool = False


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _factors(spec: sh.Spec, ndim: int, sizes: Mapping[str, int]
             ) -> Tuple[int, ...]:
    """Per dimension, how many blocks ``spec`` cuts it into."""
    return tuple(math.prod(sizes[a] for a in sh.entry_axes(spec[d]))
                 if d < len(spec) else 1 for d in range(ndim))


class _MetaGather(torch.autograd.Function):
    """A rank's ``train.step._GatherLeaf`` on meta, moving no data: the
    block cast to ``dtype`` (None: as it is) and made whole -- the
    gathers' output, written -- and in the backward the whole leaf's
    float32 gradient cut back to the block, the reduce-scatters' output."""

    @staticmethod
    def forward(ctx, local, factors, dtype):
        ctx.factors = factors
        x = local if dtype is None else local.to(dtype)
        if any(f > 1 for f in factors):
            return x.repeat(*factors)
        return x.contiguous() if x is not local else x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.float()
        for d, f in enumerate(ctx.factors):
            if f > 1:
                g = g.narrow(d, 0, g.shape[d] // f)
        return g.contiguous(), None, None


def _place(model: M.Model, sizes: Mapping[str, int]
           ) -> List[Tuple[Tuple[int, ...], sh.Spec, Tuple[int, ...]]]:
    """Replace ``model``'s leaves by the rank's blocks (meta, each leaf's
    dtype, requiring grad as before); returns each leaf's (whole shape,
    spec, factors) in ``named_parameters`` order."""
    placed, blocks = [], []
    for name, p in model.named_parameters():
        spec = sh.logical_spec(model.axes[name], p.shape, sizes)
        f = _factors(spec, p.ndim, sizes)
        placed.append((tuple(p.shape), spec, f))
        blocks.append(torch.empty([n // k for n, k in zip(p.shape, f)],
                                  dtype=p.dtype, device=META))
    M.replace_parameters(model, blocks)
    return placed


def _gather_leaf(model: M.Model, placed, dtype):
    """The train step's ``compute_view`` leaf function of a rank:
    ``_MetaGather`` by each leaf's factors."""
    factors = {id(p): f for p, (_, _, f) in zip(model.parameters(), placed)}
    return lambda p: _MetaGather.apply(p, factors[id(p)], dtype)


def _batch_rows(global_batch: int, sizes: Mapping[str, int]
                ) -> Tuple[int, Tuple[str, ...]]:
    """(rows of the rank's batch block, the mesh axes that split it)."""
    spec = sh.logical_spec(("batch",), (global_batch,), sizes)
    axes = sh.entry_axes(spec[0])
    return global_batch // math.prod(sizes[a] for a in axes), axes


def _leaf_gathers(shape, spec: sh.Spec, f, itemsize: int,
                  sizes: Mapping[str, int]) -> List[Tuple[int, int]]:
    """(result bytes a rank, ranks) of each all-gather that makes a leaf
    of ``shape`` whole from its block (``f`` blocks a dimension,
    ``itemsize`` bytes an element), minor axis first."""
    cur = math.prod(n // k for n, k in zip(shape, f)) * itemsize
    out = []
    for d in range(len(shape)):
        for a in reversed(sh.entry_axes(spec[d]) if d < len(spec) else ()):
            cur *= sizes[a]
            out.append((cur, sizes[a]))
    return out


def _bill_gathers(rec: StepAnalysis, placed, sizes,
                  itemsizes: Sequence[int]) -> None:
    """Each leaf's all-gathers of its compute copy (``itemsizes[i]`` bytes
    an element), minor axis first."""
    for (shape, spec, f), itemsize in zip(placed, itemsizes):
        for n_bytes, g in _leaf_gathers(shape, spec, f, itemsize, sizes):
            rec.add_collective("all-gather", n_bytes, g)


def build_train(cfg: ArchConfig, shape: configs.Shape,
                sizes: Mapping[str, int], accum: int) -> _Cell:
    """The rank's train step on meta (module docstring)."""
    model, _ = S.abstract_model(cfg)
    placed = _place(model, sizes)
    params = list(model.parameters())
    opt = adamw.init(params)
    rows, batch_axes = _batch_rows(shape.global_batch, sizes)
    if rows % accum:
        raise ValueError(f"a rank's {rows} rows do not split into {accum} "
                         "microbatches")
    batch = S.token_specs(cfg, rows, shape.seq_len, with_labels=True)
    leaf = _gather_leaf(model, placed, torch.bfloat16)
    opt_cfg = adamw.AdamWConfig()

    def step():
        view = M.compute_view(model, torch.bfloat16, leaf=leaf)
        loss = T._accumulate(view, cfg, batch, accum, META) / accum
        del view
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for g in grads:
            g.mul_(1.0 / accum)
        adamw.apply_updates(params, grads, opt, opt_cfg,
                            T.decay_mask(model))
        for p in params:
            p.grad = None
        return params, opt.m, opt.v, loss

    n_pods = sizes.get("pod", 1)

    def collectives(rec: StepAnalysis) -> None:
        _bill_gathers(rec, placed, sizes, [2] * len(placed))
        for shape_, spec, f in placed:
            split = {a for e in spec for a in sh.entry_axes(e)}
            cur = math.prod(shape_) * 4
            for d in range(len(shape_)):
                for a in (sh.entry_axes(spec[d]) if d < len(spec) else ()):
                    cur //= sizes[a]
                    if a in batch_axes:
                        rec.add_collective("reduce-scatter", cur, sizes[a],
                                           count=accum)
            block = math.prod(n // k for n, k in zip(shape_, f))
            for a in batch_axes:
                if a != "pod" and a not in split:
                    rec.add_collective("all-reduce", block * 4, sizes[a])
            if n_pods > 1 and "pod" not in split:
                rec.add_collective("all-reduce", block * 4, n_pods)
        for a in batch_axes:                       # the loss
            rec.add_collective("all-reduce", 4, sizes[a])
        for a, n in sizes.items():                 # the gradient norm
            rec.add_collective("all-reduce", 4, n)

    args = params + opt.m + opt.v + list(batch.values())
    return _Cell(step, {}, _nbytes(args), 0, rows, collectives)


def _ring_positions(shape: Tuple[int, ...], n: int) -> np.ndarray:
    """pos_ids [repeats, smax] of a ring cache after positions 0..n-1: slot
    j holds the latest p < n with p % smax == j, -1 where none."""
    smax = shape[-1]
    j = np.arange(smax)
    pos = np.where(j < n, j + smax * ((n - 1 - j) // smax), -1)
    return np.broadcast_to(pos, shape).astype(np.int32)


def _cache_positions(cache, n: int) -> Dict[torch.Tensor, np.ndarray]:
    """Every ``pos_ids`` leaf of a cache tree with its values after ``n``
    positions."""
    known = {}

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "pos_ids":
                    known[v] = _ring_positions(tuple(v.shape), n)
                else:
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(cache)
    return known


def _meta_view_leaf(placed, model: M.Model, sizes: Mapping[str, int]
                    ) -> Callable:
    """``engine.gathered_view``'s leaf function of a rank on meta
    (``engine._gather_plan``'s reads): a leaf a mesh axis splits made
    whole, or for a leaf of ``models.model.tp_leaves`` the rank's block
    along the model group's axes (``repeat``: the gathers' output,
    written), each all-gather billed to the tracer as ``_bill_gathers``
    bills the train step's (minor axis first); any other leaf as it
    is."""
    tp_axes = sh.tp_axes(sizes)
    n = math.prod(sizes[a] for a in tp_axes)
    split = M.tp_leaves(model.cfg, n) if tp_axes else set()
    read = {}
    for (name, p), (shape, spec, f) in zip(model.named_parameters(), placed):
        if name in split:
            spec = tuple(tuple(a for a in sh.entry_axes(e)
                               if a not in tp_axes) or None for e in spec)
            shape = tuple(s // (k // g) for s, k, g in zip(
                shape, f, _factors(spec, len(shape), sizes)))
            f = _factors(spec, len(shape), sizes)
        read[id(p)] = (shape, spec, f)

    def leaf(p: torch.Tensor) -> torch.Tensor:
        shape, spec, f = read[id(p)]
        if not any(k > 1 for k in f):
            return p
        for n_bytes, g in _leaf_gathers(shape, spec, f, p.element_size(),
                                        sizes):
            fa.META_TRACE.collective("all-gather", n_bytes, g)
        return p.repeat(*f)
    return leaf


def build_serve(cfg: ArchConfig, shape: configs.Shape,
                sizes: Mapping[str, int], kind: str,
                cache_len: Optional[int] = None) -> _Cell:
    """The rank's sharded prefill or decode step on meta (module
    docstring); ``cache_len``: the cache's slots (default: the decoder's
    length of ``shape.seq_len``, the reference's ``serve_specs``)."""
    rows, _ = _batch_rows(shape.global_batch, sizes)
    _, _, batch, _, spec = S.serve_specs(cfg, shape.global_batch,
                                         shape.seq_len, kind)
    # the rank's rows, in storages of their own (argument bytes)
    batch = {k: v.clone() for k, v in engine.batch_block(batch, sizes)
             .items()}
    if cache_len is not None:
        spec = C.cache_spec(cfg, shape.global_batch, cache_len, enc_len=(
            shape.seq_len if cfg.is_encoder_decoder else 0))
    # the serving model's own leaves: matrices in cfg.dtype, 1-D leaves
    # float32 (``models.layers.leaf_dtype``), as ``init_model`` makes them
    model = M.init_model(cfg, device="meta")
    placed = _place(model, sizes)
    split = any(k > 1 for _, _, f in placed for k in f)
    tp = bool(sh.tp_axes(sizes))
    view = engine.gathered_view(model, _meta_view_leaf(placed, model, sizes),
                                tp) if split else model
    cache = C.zeros(spec, device=META, mesh=sizes)
    blocks = C.leaves(cache)
    cache_split = any(tuple(b.shape) != s.shape
                      for b, s in zip(blocks, C.leaves(spec)))
    dl = S.dec_len(cfg, shape.seq_len)

    if kind == "prefill":
        known = _cache_positions(cache, 0)

        def run():
            return engine.prefill(view, cfg, batch, cache)
    else:
        known = _cache_positions(cache, dl - 1)

        def run():
            return engine.decode_step(view, cfg, batch["tokens"], dl - 1,
                                      cache)

    def step():
        with sh.mesh_context(sizes):
            return run()

    args = list(model.parameters()) + list(batch.values()) + blocks
    pattern = ("tensor_parallel" if tp else "gather_weights_split_cache"
               if split or cache_split else "whole")
    return _Cell(step, known, _nbytes(args), _nbytes(blocks), rows,
                 lambda rec: None, pattern, cache_split)


def _shape(shape) -> configs.Shape:
    return configs.SHAPES[shape] if isinstance(shape, str) else shape


def run_cell(arch: str, shape, *, multi_pod: bool = False,
             accum: Optional[int] = None,
             mesh: Optional[Mapping[str, int]] = None,
             cfg: Optional[ArchConfig] = None,
             cache_len: Optional[int] = None,
             verbose: bool = True) -> Dict:
    """The dry run's record of one cell: ``shape`` a name of
    ``configs.SHAPES`` or a ``configs.Shape``; ``mesh`` a mapping of axis
    sizes (default: the production mesh); ``cfg`` in place of
    ``configs.get(arch)`` (a cut depth, a smoke config); ``cache_len`` a
    serving cell's cache slots (``build_serve``)."""
    cfg = cfg or configs.get(arch)
    shape = _shape(shape)
    if (shape in configs.SHAPES.values()
            and shape not in configs.applicable_shapes(cfg)):
        return dict(arch=arch, shape=shape.name, skipped=True,
                    reason="long_500k needs a sub-quadratic arch")
    sizes = dict(mesh) if mesh is not None else \
        mesh_mod.production_mesh_shape(multi_pod=multi_pod)
    n_dev = math.prod(sizes.values())
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if accum is None and shape.kind == "train":
        accum = max(1, min(8, shape.global_batch // dp))

    t0 = time.perf_counter()
    if shape.kind == "train":
        cell = build_train(cfg, shape, sizes, accum)
    else:
        cell = build_serve(cfg, shape, sizes, shape.kind, cache_len)
    counted = analyze_step(cell.fn, known=cell.known)
    cell.collectives(counted)
    trace_s = time.perf_counter() - t0

    model_fl = costs_mod.model_flops(cfg, shape)
    terms = roofline_terms(
        counted.dot_flops, counted.bytes_accessed,
        counted.collective_wire_bytes,
        peak_flops=mesh_mod.PEAK_FLOPS_BF16, hbm_bw=mesh_mod.HBM_BW,
        ici_bw=mesh_mod.ICI_BW)
    temp = counted.peak_live_bytes
    per_dev = cell.argument_bytes + temp
    rec = dict(
        arch=arch, shape=shape.name,
        mesh=dict(shape=list(sizes.values()), axes=list(sizes),
                  n_devices=int(n_dev)),
        accum=accum, batch_per_device=cell.batch_per_device,
        trace_s=trace_s, cache_sharded=cell.cache_sharded,
        serving_pattern=cell.serving_pattern,
        memory=dict(
            argument_bytes=cell.argument_bytes,
            output_bytes=counted.output_bytes,
            alias_bytes=counted.alias_bytes,
            temp_bytes=temp,
            cache_bytes=cell.cache_bytes,
            peak_per_device_bytes=per_dev,
            card_bytes=mesh_mod.CARD_MEMORY_BYTES,
            fits_card=bool(per_dev < mesh_mod.CARD_MEMORY_BYTES),
        ),
        counted=counted.merged(),
        model_flops=model_fl,
        useful_flops_ratio=(model_fl["total_flops"] / n_dev
                            / counted.dot_flops
                            if counted.dot_flops else 0.0),
        roofline=terms,
    )
    if verbose:
        print(json.dumps(rec, indent=1))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out-dir", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "multipod" if args.multi_pod else "singlepod"
    cells = (configs.all_cells() if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in cells:
        out_path = out_dir / f"{arch}_{shape}_{tag}.json"
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           accum=args.accum, verbose=False)
            out_path.write_text(json.dumps(rec, indent=1))
            mem = rec.get("memory", {})
            print(f"OK   {arch:24s} {shape:12s} {tag}: "
                  f"trace={rec.get('trace_s', 0):7.1f}s "
                  f"perdev={mem.get('peak_per_device_bytes', 0)/1e9:6.2f}GB "
                  f"dominant={rec.get('roofline', {}).get('dominant', '?')}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 -- report and continue
            failures += 1
            print(f"FAIL {arch:24s} {shape:12s} {tag}: "
                  f"{type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
