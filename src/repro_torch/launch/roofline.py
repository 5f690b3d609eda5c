"""A step's FLOPs, bytes, peak memory and collective traffic, counted on the
``meta`` device (the reference's ``launch/roofline.py``).

The reference compiles each step with XLA and parses the partitioned HLO
text: dot FLOPs, result bytes and collectives, every op multiplied by the
trip count of the while loop (``lax.scan`` over the stacked layers) that
runs it.  The port compiles nothing, so that parser has no counterpart.
What takes its place is ``analyze_step``: it runs the step on ``meta``
tensors (shapes and dtypes, no memory, no arithmetic) and watches every
ATen op it dispatches.  The port's stack is a host loop over the layers,
so every layer's ops dispatch and are counted where they run: the
reference's while-loop multiplication does not arise.

  * dot FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
    matrix products (forward, rematerialized forward and backward), plus
    the attention kernels' own count.  On ``meta`` the attention dispatch
    (``kernels/flash_attention.py``) runs no plain version: it returns the
    output's shape and reports the FLOPs of the (row, slot) pairs of the
    tiles the chosen kernel computes, from the positions' values (below),
    and the bytes of q, k, v, the positions and the output.  Traced as the
    plain version, prefill_32k's [B, H, Sq, Skv] scores would bill
    hundreds of GB of temporaries that no kernel allocates.
  * bytes: ``bytes_written`` sums each op's output bytes, leaving out ops
    that only alias their inputs (views; the reference's ``NON_WRITING``)
    and allocations that write nothing (``empty``); an indexed write
    (``index_put_``, ...) bills the values it writes, not the whole
    target.  ``bytes_read`` sums the bytes each op reads (a gather its
    output's rows, not the whole table).  The port runs eagerly -- every
    op reads its inputs from device memory and writes its outputs there
    -- so the memory term divides their sum, ``bytes_accessed``: the
    reference's writes alone would miss a decode step's weight reads,
    the step's largest traffic.
  * peak memory: every storage an op allocates is live from that op until
    Python drops its last reference (a weak reference's callback), so
    autograd's saved tensors, rematerialized activations and gradients
    count while they are held.  ``peak_live_bytes`` is the largest sum,
    above what was live before the step (its arguments).
  * positions: a ``meta`` tensor has no values, but the attention's tile
    count and its backward's row bounds need the positions'.  Integer and
    bool tensors of at most ``VALUE_LIMIT`` elements carry a host copy
    (seeded by ``known``, or made by a factory op such as ``arange``), and
    an op whose inputs all carry one computes its outputs' on the host,
    with deterministic algorithms (a slot written twice keeps its last
    value).
    ``kernels.flash_attention`` asks for them through ``META_TRACE``;
    outside ``analyze_step`` an attention call on ``meta`` raises.
  * collectives: the sharded step's are counted by the dry run from its
    own pattern (``launch/dryrun.py``), each op billed by
    ``collective_bytes``; those that sharded serving's attention makes
    inside the step (its (out, lse) all-gather over the model ranks,
    ``models/layers.py``) bill themselves through ``collective``.

  * speed: an op that allocates fresh outputs takes their layouts from
    the first op of its kind with the same input layouts and arguments
    (``_Tracer._run``).  On torch 2.13's CPU build a meta elementwise op
    runs a Python reference (~200 us an ``add``, ~1 ms a
    ``log_sigmoid_forward``) against ~3 us for ``empty_strided``: without
    the cache xlstm-1.3b's train_4k cell traced for over 7380 s against
    1561 s (sLSTM steps one time step at a time), and the smoke tests'
    file took ~278 s against ~121 s.

``roofline_terms`` is the reference's function.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import flash_attention as fa

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# integer / bool tensors up to this many elements carry host values
VALUE_LIMIT = 1 << 20
_VALUE_DTYPES = frozenset({torch.bool, torch.uint8, torch.int8, torch.int16,
                           torch.int32, torch.int64})

aten = torch.ops.aten
# allocations that write nothing
_ALLOCS = frozenset({aten.empty.memory_format, aten.empty_strided.default,
                     aten.new_empty.default, aten.new_empty_strided.default,
                     aten.empty_like.default})
# writes into part of their first argument: bill the values, not the target
_INDEXED_WRITES = frozenset({aten.index_put_.default,
                             aten._index_put_impl_.default,
                             aten.index_copy_.default,
                             aten.scatter_.src, aten.scatter_.value,
                             aten.masked_scatter_.default})
# reads of rows by index: bill the rows read (the output), not the table
_GATHERS = frozenset({aten.index.Tensor, aten.embedding.default,
                      aten.index_select.default, aten.gather.default})
META = torch.device("meta")
# argument types an op's output layout may depend on (keys of the cache)
_KEYABLE = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def collective_bytes(opcode: str, result_bytes: float, g: int
                     ) -> Tuple[float, float]:
    """(wire bytes a device moves, operand bytes) of one collective over a
    group of ``g`` devices whose result is ``result_bytes`` a device --
    the reference's ring model:
      all-gather:          result_bytes * (g-1)/g      received per device
      all-reduce:          2 * bytes * (g-1)/g         (reduce-scatter + gather)
      reduce-scatter:      result_bytes * (g-1)
      all-to-all:          bytes * (g-1)/g
      collective-permute:  bytes
    operand = result/g for all-gather, result*g for reduce-scatter,
    result otherwise."""
    g1 = max(g, 1)
    if opcode == "all-gather":
        return result_bytes * (g - 1) / g1, result_bytes / g1
    if opcode == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g1, result_bytes
    if opcode == "reduce-scatter":
        return result_bytes * (g - 1), result_bytes * g
    if opcode == "all-to-all":
        return result_bytes * (g - 1) / g1, result_bytes
    if opcode == "collective-permute":
        return result_bytes, result_bytes
    raise ValueError(f"unknown collective {opcode!r}; one of {COLLECTIVES}")


@dataclass
class StepAnalysis:
    dot_flops: float = 0.0                  # per device
    bytes_written: float = 0.0              # sum of op output bytes
    bytes_read: float = 0.0                 # sum of op input bytes
    collective_wire_bytes: float = 0.0      # ring-model bytes per device
    collective_operand_bytes: float = 0.0   # task-spec operand-sum
    per_collective: Dict[str, float] = field(default_factory=dict)
    per_group_size: Dict[int, float] = field(default_factory=dict)
    n_collective_ops: int = 0
    peak_live_bytes: float = 0.0            # above the step's arguments
    output_bytes: float = 0.0               # what the step returns
    alias_bytes: float = 0.0                # of it, arguments (in place)
    # the attention kernels' share of dot_flops, and their calls, by kernel
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)

    @property
    def bytes_accessed(self) -> float:
        return self.bytes_read + self.bytes_written

    def add_collective(self, opcode: str, result_bytes: float, g: int,
                       count: int = 1) -> None:
        """Bill ``count`` collectives of ``opcode`` over ``g`` devices, each
        with ``result_bytes`` a device (none when g == 1)."""
        if g <= 1 or count <= 0:
            return
        wire, operand = collective_bytes(opcode, result_bytes, g)
        self.collective_wire_bytes += wire * count
        self.collective_operand_bytes += operand * count
        self.per_collective[opcode] = \
            self.per_collective.get(opcode, 0.0) + wire * count
        self.per_group_size[g] = self.per_group_size.get(g, 0.0) + wire * count
        self.n_collective_ops += count

    def merged(self) -> Dict:
        return dict(dot_flops=self.dot_flops, bytes_written=self.bytes_written,
                    bytes_read=self.bytes_read,
                    bytes_accessed=self.bytes_accessed,
                    collective_wire_bytes=self.collective_wire_bytes,
                    collective_operand_bytes=self.collective_operand_bytes,
                    per_collective=dict(self.per_collective),
                    per_group_size={str(k): v
                                    for k, v in self.per_group_size.items()},
                    n_collective_ops=self.n_collective_ops,
                    peak_live_bytes=self.peak_live_bytes,
                    kernel_flops=dict(self.kernel_flops),
                    kernel_calls=dict(self.kernel_calls))


def _leaves(xs) -> list:
    """The leaves of an op's arguments: tensors, scalars, and the items of
    lists and tuples (``kwargs`` passed as (name, value) pairs)."""
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.extend(_leaves(x))
        else:
            out.append(x)
    return out


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor addresses (a broadcast dimension,
    stride 0, once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


class _Tracer(TorchDispatchMode):
    """Bytes, live storages and host values of the ops on ``meta``."""

    def __init__(self, rec: StepAnalysis, products=frozenset()):
        super().__init__()
        self.rec = rec
        self.products = products     # ops the FLOP counter bills
        self.live = 0
        self.sizes: Dict[int, int] = {}        # storage -> bytes (in trace)
        self.values: Dict[int, torch.Tensor] = {}   # storage -> host copy
        self.refs: Dict[int, weakref.ref] = {}
        self.kinds: Dict = {}          # op -> (its returns' aliases, view)
        self.fresh: set = set()        # ops that return new storages only
        self.shapes: Dict = {}         # (op, layouts, args) -> outputs

    # -- storages ---------------------------------------------------------
    def _watch(self, st) -> int:
        key = st._cdata
        if key not in self.refs:
            self.refs[key] = weakref.ref(st, lambda _, k=key: self._drop(k))
        return key

    def _drop(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)
        self.values.pop(key, None)
        self.refs.pop(key, None)

    def _allocated(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live if no op has seen it before: a new
        allocation (an input's storage -- an argument's, or one a view or an
        in-place op returns -- is watched when it comes in)."""
        st = t.untyped_storage()
        if st._cdata in self.refs:
            return
        self.sizes[self._watch(st)] = st.nbytes()
        self.live += st.nbytes()
        self.rec.peak_live_bytes = max(self.rec.peak_live_bytes, self.live)

    # -- host values ------------------------------------------------------
    def host(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The host view of a meta tensor's values, or None."""
        flat = self.values.get(t.untyped_storage()._cdata)
        if flat is None or flat.dtype != t.dtype:
            return None
        return torch.as_strided(flat, t.shape, t.stride(),
                                t.storage_offset())

    def seed(self, t: torch.Tensor, values) -> None:
        """Give ``t``'s storage host values (``t``'s elements; the rest of
        the storage is left unset)."""
        st = t.untyped_storage()
        flat = torch.empty(st.nbytes() // t.element_size(), dtype=t.dtype)
        torch.as_strided(flat, t.shape, t.stride(), t.storage_offset()
                         ).copy_(torch.as_tensor(values, dtype=t.dtype))
        self.values[self._watch(st)] = flat

    def _propagate(self, func, args, kwargs, ins, outs, writes) -> None:
        """Compute the outputs' host values from the inputs', where every
        input has them and every output is a small integer or bool tensor;
        where not, an op that writes into a storage with values drops
        them (they would be stale).  The host runs it with deterministic
        algorithms, so a slot that one indexed write hits twice keeps the
        last value (a prompt longer than a ring: each slot its latest
        position), not whichever thread wrote last."""
        ok = func not in _ALLOCS and bool(outs) and all(
            t.is_meta and t.dtype in _VALUE_DTYPES
            and t.numel() <= VALUE_LIMIT for t in outs)
        hosts = {}
        for t in ins if ok else ():
            if t.is_meta:
                h = self.host(t)
                if h is None:
                    ok = False
                    break
                hosts[id(t)] = h
        if not ok:
            for t in writes:
                self.values.pop(t.untyped_storage()._cdata, None)
            return

        def to_host(x):
            if isinstance(x, torch.Tensor):
                return hosts.get(id(x), x)
            if isinstance(x, torch.device) and x.type == "meta":
                return torch.device("cpu")
            return x

        det = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        with _disable_current_modes():
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                res = func(*pytree.tree_map(to_host, args),
                           **pytree.tree_map(to_host, kwargs))
            finally:
                torch.use_deterministic_algorithms(det[0], warn_only=det[1])
            res = [r for r in pytree.tree_leaves(res)
                   if isinstance(r, torch.Tensor)]
            for t, h in zip(outs, res):
                if t.untyped_storage()._cdata not in self.values:
                    self.seed(t, h)     # a new output (in place: written)

    # -- dispatch -------------------------------------------------------
    def _run(self, func, args, kwargs, leaves):
        """The op's outputs.  A product goes on to the FLOP counter; any
        other op runs past it (the counter would decompose it, milliseconds
        an op on meta, to find none), and an op that allocates fresh
        outputs takes them from ``self.shapes`` when an earlier op of the
        same kind, input layouts and arguments made them (module docstring:
        a meta kernel may be a Python reference of ~200 us)."""
        if func._overloadpacket in self.products:
            return func(*args, **kwargs)
        key = None
        if func in self.fresh:
            key = [func]
            for x in leaves:
                if isinstance(x, torch.Tensor):
                    if not x.is_meta:
                        key = None
                        break
                    key.append((tuple(x.shape), x.stride(), x.dtype))
                elif isinstance(x, _KEYABLE) or x is None:
                    key.append(x)
                else:
                    key = None
                    break
            key = None if key is None else tuple(key)
            made = self.shapes.get(key)
            if made is not None:
                spec, metas = made
                with _disable_current_modes():
                    return pytree.tree_unflatten(
                        [torch.empty_strided(shape, stride, dtype=dtype,
                                             device=META)
                         for shape, stride, dtype in metas], spec)
        with _disable_current_modes():
            out = func(*args, **kwargs)
        if key is not None:
            res, spec = pytree.tree_flatten(out)
            stores = {x.untyped_storage()._cdata for x in leaves
                      if isinstance(x, torch.Tensor)}
            if any(isinstance(r, torch.Tensor)
                   and r.untyped_storage()._cdata in stores for r in res):
                # returns an input's storage though its schema says not
                # (``_unsafe_view``): never from the cache
                self.fresh.discard(func)
            elif all(isinstance(r, torch.Tensor) and r.is_meta for r in res):
                self.shapes[key] = (spec, [(tuple(r.shape), r.stride(),
                                            r.dtype) for r in res])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves(args) + _leaves(tuple(kwargs.items()))
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        for t in ins:
            if t.is_meta:
                self._watch(t.untyped_storage())
        if func not in self.kinds:
            aliases = tuple(r.alias_info for r in func._schema.returns)
            view = bool(aliases) and all(a is not None and not a.is_write
                                         for a in aliases)
            self.kinds[func] = (aliases, view)
            if aliases and all(a is None for a in aliases):
                self.fresh.add(func)
        aliases, view = self.kinds[func]
        out = self._run(func, args, kwargs, leaves)
        outs = [t for t in _leaves((out,)) if isinstance(t, torch.Tensor)]
        if view or not any(t.is_meta for t in ins + outs):
            # a view: no write, no allocation; or host work (positions'
            # values): not billed
            return out
        for t in outs:
            if t.is_meta:
                self._allocated(t)
        self._bill(func, ins, outs)
        writes = [t for t, a in zip(outs, aliases)
                  if a is not None and a.is_write]
        self._propagate(func, args, kwargs, ins, outs, writes)
        return out

    def _bill(self, func, ins, outs) -> None:
        rec = self.rec
        if func in _ALLOCS:
            return
        if func in _INDEXED_WRITES:
            # self, then indices, then the values written (last)
            rec.bytes_read += sum(_unique_bytes(t) for t in ins[1:])
            rec.bytes_written += _unique_bytes(ins[-1])
            return
        if func in _GATHERS:
            rec.bytes_read += sum(_unique_bytes(t) for t in ins[1:]) + sum(
                _unique_bytes(t) for t in outs)
        elif func is aten.copy_.default:
            rec.bytes_read += _unique_bytes(ins[1])
        else:
            rec.bytes_read += sum(_unique_bytes(t) for t in ins)
        rec.bytes_written += sum(_unique_bytes(t) for t in outs)

    # -- the attention kernels' protocol (kernels.flash_attention) ---------
    def positions(self, t: torch.Tensor) -> torch.Tensor:
        """A positions tensor's values, on the host."""
        h = self.host(t) if t.is_meta else t
        if h is None:
            raise RuntimeError(
                "attention on meta: the dry run does not know these "
                f"positions' values ({tuple(t.shape)} {t.dtype})")
        return h.clone()

    def collective(self, opcode: str, result_bytes: float, g: int) -> None:
        """Bill one collective the step makes (``StepAnalysis.
        add_collective``)."""
        self.rec.add_collective(opcode, result_bytes, g)

    def kernel(self, name: str, flops: float, bytes_read: float,
               bytes_written: float) -> None:
        """Bill one launch of the kernel ``name``."""
        rec = self.rec
        rec.kernel_flops[name] = rec.kernel_flops.get(name, 0.0) + flops
        rec.kernel_calls[name] = rec.kernel_calls.get(name, 0) + 1
        rec.bytes_read += bytes_read
        rec.bytes_written += bytes_written


def analyze_step(fn: Callable, *args,
                 known: Optional[Mapping[torch.Tensor, object]] = None,
                 **kwargs) -> StepAnalysis:
    """Run ``fn(*args, **kwargs)`` on ``meta`` tensors and count it:
    ``dot_flops`` (matrix products and the attention kernels),
    ``bytes_written`` / ``bytes_read`` and ``peak_live_bytes`` (module
    docstring).  ``known``: meta tensor -> its values (the positions a
    cache holds), for the attention's count.  The collectives are the
    caller's to add.  ``output_bytes``: the distinct storages of the
    tensors ``fn`` returns (in lists, tuples and dicts); ``alias_bytes``:
    those of them it did not allocate (its arguments, updated in place)."""
    rec = StepAnalysis()
    counter = FlopCounterMode(display=False)
    tracer = _Tracer(rec, frozenset(counter.flop_registry))
    for t, vals in (known or {}).items():
        tracer.seed(t, vals)
    prev, fa.META_TRACE = fa.META_TRACE, tracer
    try:
        with counter, tracer:
            out = fn(*args, **kwargs)
            stores = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                      for t in pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)}
            rec.output_bytes = float(sum(stores.values()))
            rec.alias_bytes = float(sum(n for k, n in stores.items()
                                        if k not in tracer.sizes))
            del out
    finally:
        fa.META_TRACE = prev
    rec.dot_flops = float(counter.get_total_flops()) + sum(
        rec.kernel_flops.values())
    return rec


def roofline_terms(dot_flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, *,
                   peak_flops: float, hbm_bw: float, ici_bw: float) -> Dict:
    compute_s = dot_flops_per_dev / peak_flops
    memory_s = bytes_per_dev / hbm_bw
    collective_s = wire_bytes_per_dev / ici_bw
    total = max(compute_s, memory_s, collective_s)
    dominant = ("compute" if total == compute_s else
                "memory" if total == memory_s else "collective")
    return dict(compute_s=compute_s, memory_s=memory_s,
                collective_s=collective_s, dominant=dominant,
                bound_s=total,
                compute_fraction=compute_s / total if total else 0.0)
