"""The port's tracelint rule catalog (CFN101-CFN105), in torch terms.

The ids are the JAX package's, so one ``# tracelint: allow[CFN10x]``
pragma names the same invariant in both packages:

  CFN101  host syncs inside captured or compiled regions -- the body of
          ``torch.cuda.graph(...)``, ``capture_begin()`` ..
          ``capture_end()``, a ``torch.compile``d function, the callables
          handed to ``make_graphed_callables`` -- and in every function
          reachable from them, across modules (``dataflow.ProjectIndex``
          resolves the calls), following callables passed as arguments
          back to the call sites that pass them.
  CFN102  float64 outside the oracle whitelist (``kernels/ref.py``,
          ``launch/roofline.py``).
  CFN103  pytree hygiene: a ``register_pytree_node`` flatten function
          accounts for every dataclass field; value-only ``degrade``
          paths change no shape.
  CFN104  the counted solver entries (``COUNTED_ENTRIES``) carry
          ``@count_traces`` with the JAX package's names.
  CFN105  shared memory: each launcher's ``*_launch_smem`` mirror,
          evaluated at ``MAX_SCALE``, fits ``SMEM_PER_BLOCK_BYTES``;
          loops over non-constexpr bounds in ``@triton.jit`` bodies.

Only the standard library is imported: linting needs neither a GPU nor
the CUDA toolkit.  See ``docs/ANALYSIS.md`` for the JAX package's
catalog; the README's port section lists the torch forms.
"""
from __future__ import annotations

import ast
import operator
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import Finding, Module, Project, ProjectRule, Rule

# The largest shapes the port runs (each with its source); CFN105
# evaluates every ``*_launch_smem`` mirror here.
MAX_SCALE: Dict[str, int] = {
    "P": 468, "N": 126, "K": 14,   # city_p468 (chip_smoke phase 3)
    "J": 27000,                    # phase 3c: R = 9000 x 3 VMs (phase 3: 3072)
    "B": 4096,                     # phase 1's largest placement_power batch
    "C": 141,                      # phase 1's largest fused_anneal chain count
    "deg": 32,                     # fused anneal incident links (FUSED_MAX_D;
                                   # 3c's D = 33 stars take the delta engine)
    "D": 192, "Dv": 128,           # the wgmma rule (MLA prefill: K 192, V 128)
    "Skv": 32768,                  # configs.SHAPES: prefill_32k / decode_32k
    "rows": 16,                    # split-KV rows a kv head (kMaxRows)
    "cps": 16,                     # split-KV chunks a split (its maximum)
    "esz": 4,                      # float32 elements (the float32 checks)
}

# the dynamic shared memory one H100 block may opt into
# (cudaDevAttrMaxSharedMemoryPerBlockOptin); a module's own
# ``SMEM_PER_BLOCK`` constant takes precedence
SMEM_PER_BLOCK_BYTES = 232448

# the counted solver entries of the JAX package, by defining module of the
# port: function name -> TRACE_COUNTS name
COUNTED_ENTRIES: Dict[str, Dict[str, str]] = {
    "core/solvers.py": {"_sweep": "sweep",
                        "_anneal_scan_delta": "anneal_delta",
                        "_anneal_scan_full": "anneal_full"},
    "core/federation.py": {"_solve_regions": "solve_regions"},
}

_COMPILE_NAMES = {"torch.compile"}
_PARTIAL_NAMES = {"functools.partial", "partial"}
_UNWRAP_CALLS = _PARTIAL_NAMES | {
    "vmap", "torch.vmap", "torch.func.vmap", "func.vmap", "torch.compile",
    "torch.func.grad", "torch.func.grad_and_value", "count_traces"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_target(node: ast.AST) -> Optional[str]:
    return _dotted(node.func) if isinstance(node, ast.Call) else None


def _leaf(dotted: Optional[str]) -> str:
    return dotted.split(".")[-1] if dotted else ""


def _is_compile_decorator(dec: ast.AST) -> bool:
    """``@torch.compile``, ``@torch.compile(...)`` or
    ``@functools.partial(torch.compile, ...)``."""
    if _dotted(dec) in _COMPILE_NAMES:
        return True
    if isinstance(dec, ast.Call):
        f = _dotted(dec.func)
        if f in _COMPILE_NAMES:
            return True
        if f in _PARTIAL_NAMES and dec.args \
                and _dotted(dec.args[0]) in _COMPILE_NAMES:
            return True
    return False


def _is_count_traces_decorator(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        return _leaf(_dotted(dec.func)) == "count_traces"
    return False


def _count_traces_name(dec: ast.Call) -> Optional[str]:
    if dec.args and isinstance(dec.args[0], ast.Constant) \
            and isinstance(dec.args[0].value, str):
        return dec.args[0].value
    return None


def _unwrap_to_names(node: ast.AST) -> List[str]:
    """Function names inside transform wrappers: vmap(f) -> f,
    torch.compile(count_traces("x")(f)) -> f, partial(k, ...) -> k."""
    out: List[str] = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Call):
            t = _dotted(n.func)
            if t is not None and (t in _UNWRAP_CALLS
                                  or _leaf(t) == "count_traces"):
                stack.extend(n.args[:1])
            elif isinstance(n.func, ast.Call):
                # decorator-factory application: count_traces("x")(f)
                stack.extend(n.args[:1])
    return out


def _module_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Function defs reachable by bare name (module-level and nested),
    class methods excluded."""
    methods = {m for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               for m in n.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n not in methods}


def _toplevel_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _scalar_annotation(ann: Optional[ast.AST]) -> bool:
    """``int`` / ``float`` / ``bool`` / ``str``, or ``Optional[...]`` of
    one: a Python scalar, not a tensor."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    return bool(names) and names <= {"int", "float", "bool", "str",
                                     "Optional", "None"}


def _scalar_params(fn: Optional[ast.AST]) -> Set[str]:
    """Parameters of ``fn`` annotated as Python scalars or defaulted to a
    number or bool."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
        return set()
    a = fn.args
    pos = list(getattr(a, "posonlyargs", [])) + list(a.args)
    out = {p.arg for p in pos + list(a.kwonlyargs)
           if _scalar_annotation(getattr(p, "annotation", None))}
    for p, d in list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) \
            + list(zip(a.kwonlyargs, a.kw_defaults)):
        if isinstance(d, ast.Constant) and isinstance(d.value,
                                                      (bool, int, float)):
            out.add(p.arg)
    return out


# ---------------------------------------------------------------------------
# CFN101: host syncs inside captured or compiled regions
# ---------------------------------------------------------------------------

_BOOL_MASK_OPS = (ast.BitAnd, ast.BitOr, ast.BitXor)


class RetraceHazards(ProjectRule):
    """Host syncs in code a CUDA graph captures or ``torch.compile``
    traces.

    Regions: the body of ``with torch.cuda.graph(g):``, the statements
    between ``g.capture_begin()`` and ``g.capture_end()``, functions
    decorated with (or passed to) ``torch.compile``, and the callables
    given to ``torch.cuda.make_graphed_callables``.  From a region the
    rule follows every call it can resolve (bare names, ``module.fn``,
    ``self.method``, across the project) and every callable a region
    calls through a parameter, back to what the callers pass there
    (lambdas, named functions, dict / list displays of them, the
    callables a called factory returns).

    Syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``float`` / ``int`` / ``bool`` of a non-static value, ``np.asarray``
    / ``np.array``, ``torch.nonzero`` / ``argwhere`` / ``masked_select``
    / ``unique`` / one-argument ``torch.where`` without ``size=``,
    boolean-mask indexing, ``synchronize()``.  Casts of ``.shape`` /
    ``.dim()`` / ``.numel()`` / ``len()`` reads, constants and
    parameters annotated or defaulted as Python scalars are static.
    A capture fails on a sync; ``torch.compile`` breaks its graph there.
    """

    id = "CFN101"
    title = "host sync in a captured or compiled region"
    CASTS = {"float", "int", "bool"}
    NP_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
    SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
    DATA_SHAPE = {"nonzero", "argwhere", "masked_select", "unique",
                  "unique_consecutive"}
    STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                    "itemsize"}
    STATIC_METHODS = {"dim", "numel", "size", "data_ptr", "element_size",
                      "is_contiguous", "stride"}
    MAX_DEPTH = 5

    # -- regions ------------------------------------------------------------

    @staticmethod
    def _is_graph_ctx(expr: ast.AST) -> bool:
        t = _call_target(expr)
        return t is not None and (t == "torch.cuda.graph"
                                  or t.endswith("cuda.graph"))

    def _stmt_regions(self, body: List[ast.stmt], out: list) -> None:
        """Capture regions in a statement list and its nested blocks (not
        in nested defs): with-graph bodies, capture_begin .. capture_end."""
        begin = None
        for i, st in enumerate(body):
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
                    and isinstance(st.value.func, ast.Attribute):
                if st.value.func.attr == "capture_begin":
                    begin = i
                elif st.value.func.attr == "capture_end" \
                        and begin is not None:
                    out.append(body[begin + 1:i])
                    begin = None
            if isinstance(st, (ast.With, ast.AsyncWith)) and any(
                    self._is_graph_ctx(it.context_expr) for it in st.items):
                out.append(st.body)
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    self._stmt_regions(sub, out)
            for h in getattr(st, "handlers", []) or []:
                self._stmt_regions(h.body, out)

    def _regions(self, index, mod: Module) -> List[tuple]:
        """(module, scope FuncInfo or None, [nodes]) of every region in
        ``mod``."""
        out: List[tuple] = []
        scopes = [(None, mod.tree.body)] + [
            (fi, fi.node.body) for (p, _), fi in index.funcs.items()
            if p == mod.path]
        for fi, body in scopes:
            found: List[list] = []
            self._stmt_regions(body, found)
            for stmts in found:
                out.append((mod, fi, list(stmts)))
        for (p, _), fi in index.funcs.items():
            if p == mod.path and any(_is_compile_decorator(d)
                                     for d in fi.node.decorator_list):
                out.append((mod, fi, [fi.node]))
        for node in ast.walk(mod.tree):
            t = _call_target(node)
            if not (isinstance(node, ast.Call) and node.args) or not (
                    t in _COMPILE_NAMES
                    or _leaf(t) == "make_graphed_callables"):
                continue
            scope = self._scope_of(index, mod, node)
            out += self._callables(index, mod, scope, node.args[0], 0)
        return out

    @staticmethod
    def _scope_of(index, mod: Module, node: ast.AST):
        """The innermost function of ``mod`` whose body holds ``node``."""
        best = None
        for (p, _), cand in index.funcs.items():
            if p != mod.path:
                continue
            n = cand.node
            if n.lineno <= node.lineno <= (n.end_lineno or n.lineno):
                if best is None or (n.end_lineno - n.lineno) < (
                        best.node.end_lineno - best.node.lineno):
                    best = cand
        return best

    # -- callables flowing into a region --------------------------------------

    def _assigned(self, scope, name: str) -> List[ast.AST]:
        """Values assigned to ``name`` in ``scope``'s body (nested defs
        included: a closure's own assignments are rare)."""
        out = []
        root = scope.node if scope is not None else None
        if root is None:
            return out
        for n in ast.walk(root):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        out.append(n.value)
        return out

    def _callables(self, index, mod: Module, scope, expr: ast.AST,
                   depth: int) -> List[tuple]:
        """Bodies (module, scope, [node]) a callable expression can run."""
        if depth > self.MAX_DEPTH or expr is None:
            return []
        rec = lambda e, s=scope, m=mod: self._callables(index, m, s, e,
                                                        depth + 1)
        if isinstance(expr, ast.Lambda):
            return [(mod, scope, [expr.body])]
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return [b for e in expr.elts for b in rec(e)]
        if isinstance(expr, ast.Dict):
            return [b for e in expr.values for b in rec(e)]
        if isinstance(expr, ast.DictComp):
            return rec(expr.value)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return rec(expr.elt)
        if isinstance(expr, ast.IfExp):
            return rec(expr.body) + rec(expr.orelse)
        if isinstance(expr, ast.Subscript):
            return rec(expr.value)
        if isinstance(expr, ast.Starred):
            return rec(expr.value)
        if isinstance(expr, ast.Call):
            t = _dotted(expr.func)
            if t in _PARTIAL_NAMES | _UNWRAP_CALLS and expr.args:
                return rec(expr.args[0])
            fi = index.resolve_func(mod, t, class_name=getattr(
                scope, "class_name", None))
            if fi is None:
                return []
            out = []
            for n in ast.walk(fi.node):
                if isinstance(n, ast.Return) and n.value is not None:
                    out += self._callables(index, fi.mod, fi, n.value,
                                           depth + 1)
            return out
        if isinstance(expr, ast.Name):
            if scope is not None and expr.id in (scope.params
                                                 + scope.kwonly):
                return self._from_callers(index, scope, expr.id, depth)
            vals = self._assigned(scope, expr.id)
            if vals:
                return [b for v in vals for b in rec(v)]
        t = _dotted(expr)
        fi = index.resolve_func(mod, t, class_name=getattr(
            scope, "class_name", None))
        if fi is not None:
            return [(fi.mod, fi, [fi.node])]
        return []

    def _from_callers(self, index, fi, param: str, depth: int
                      ) -> List[tuple]:
        """What the call sites of ``fi`` pass for ``param``."""
        params = fi.params
        out = []
        for caller_mod, caller_fi, call in index.callers(fi):
            off = 1 if (fi.class_name is not None and params
                        and params[0] == "self") else 0
            arg = None
            if param in params:
                i = params.index(param) - off
                if 0 <= i < len(call.args) \
                        and not isinstance(call.args[i], ast.Starred):
                    arg = call.args[i]
            for kw in call.keywords:
                if kw.arg == param:
                    arg = kw.value
            if arg is not None:
                out += self._callables(index, caller_mod, caller_fi, arg,
                                       depth + 1)
        return out

    # -- syncs ----------------------------------------------------------------

    def _static_cast_arg(self, arg: ast.AST, scalars: Set[str]) -> bool:
        if isinstance(arg, ast.Constant):
            return True
        if isinstance(arg, ast.Name) and arg.id in scalars:
            return True
        for n in ast.walk(arg):
            if isinstance(n, ast.Attribute) and n.attr in self.STATIC_ATTRS:
                return True
            if isinstance(n, ast.Call):
                t = _dotted(n.func)
                if t == "len" or (isinstance(n.func, ast.Attribute)
                                  and n.func.attr in self.STATIC_METHODS):
                    return True
        return False

    @staticmethod
    def _bool_mask(idx: ast.AST, masks: Set[str]) -> bool:
        if isinstance(idx, ast.Compare):
            return True
        if isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.Invert):
            return True
        if isinstance(idx, ast.BinOp) and isinstance(idx.op, _BOOL_MASK_OPS):
            return any(isinstance(n, (ast.Compare, ast.UnaryOp))
                       for n in ast.walk(idx))
        return isinstance(idx, ast.Name) and idx.id in masks

    def _syncs(self, nodes: List[ast.AST], where: str, scalars: Set[str]
               ) -> Iterable[Tuple[ast.AST, str]]:
        masks: Set[str] = set()
        for root in nodes:
            for n in ast.walk(root):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and self._bool_mask(n.value, set()):
                    masks.add(n.targets[0].id)
        region = "reached from a captured or compiled region"
        for root in nodes:
            for node in ast.walk(root):
                if isinstance(node, ast.Subscript) \
                        and isinstance(node.ctx, ast.Load) \
                        and self._bool_mask(node.slice, masks):
                    yield node, (f"boolean-mask indexing in `{where}` "
                                 f"({region}) sizes its result on the "
                                 "host: a device sync")
                if not isinstance(node, ast.Call):
                    continue
                t = _dotted(node.func)
                kws = {k.arg for k in node.keywords}
                meth = node.func.attr if isinstance(node.func,
                                                    ast.Attribute) else None
                if meth in self.SYNC_METHODS and not node.args:
                    yield node, (f"`.{meth}()` in `{where}` ({region}) "
                                 "copies to the host: a device sync")
                elif meth == "synchronize" or t == "torch.cuda.synchronize":
                    yield node, (f"`synchronize()` in `{where}` ({region}) "
                                 "waits for the device")
                elif t in self.CASTS and node.args \
                        and not self._static_cast_arg(node.args[0],
                                                      scalars):
                    yield node, (f"`{t}(...)` on a tensor value in "
                                 f"`{where}` ({region}) reads it on the "
                                 "host: a device sync")
                elif t in self.NP_CALLS:
                    yield node, (f"`{t}(...)` in `{where}` ({region}) "
                                 "materializes device values on the host")
                elif (meth in self.DATA_SHAPE
                      or (t or "").startswith("torch.")
                      and _leaf(t) in self.DATA_SHAPE) \
                        and "size" not in kws:
                    yield node, (f"`{_leaf(t) or meth}` in `{where}` "
                                 f"({region}) has a data-dependent shape: "
                                 "the host waits for it (pass size=)")
                elif t == "torch.where" and len(node.args) == 1:
                    yield node, (f"one-argument `torch.where` in `{where}` "
                                 f"({region}) has a data-dependent shape: "
                                 "the host waits for it")

    # -- the pass -------------------------------------------------------

    def check_project(self, project: Project) -> Iterable[Finding]:
        from .dataflow import project_index
        index = project_index(project)
        work: List[tuple] = []
        for mod in project.modules:
            work += self._regions(index, mod)
        seen_funcs: Set[Tuple[str, str]] = set()
        seen_bodies: Set[Tuple[str, Tuple[int, ...]]] = set()
        seen: Set[Tuple[str, int, int, str]] = set()
        while work:
            mod, scope, nodes = work.pop()
            body = (mod.path, tuple(id(n) for n in nodes))
            if body in seen_bodies:
                continue
            seen_bodies.add(body)
            if len(nodes) == 1 and isinstance(
                    nodes[0], (ast.FunctionDef, ast.AsyncFunctionDef)):
                seen_funcs.add((mod.path, scope.qual if scope
                                else nodes[0].name))
            where = scope.qual if scope is not None else "<module>"
            scalars = _scalar_params(scope.node if scope else None)
            for node, msg in self._syncs(nodes, where, scalars):
                k = (mod.path, node.lineno, node.col_offset, msg)
                if k not in seen:
                    seen.add(k)
                    yield self.finding(mod, node, msg)
            cls = getattr(scope, "class_name", None)
            for root in nodes:
                for node in ast.walk(root):
                    if not isinstance(node, ast.Call):
                        continue
                    t = _dotted(node.func)
                    if isinstance(node.func, ast.Name) and scope is not None \
                            and node.func.id in scope.params + scope.kwonly:
                        work += self._from_callers(index, scope,
                                                   node.func.id, 0)
                        continue
                    fi = index.resolve_func(mod, t, class_name=cls)
                    if fi is not None and (fi.mod.path, fi.qual) \
                            not in seen_funcs:
                        work.append((fi.mod, fi, [fi.node]))


# ---------------------------------------------------------------------------
# CFN102: dtype discipline
# ---------------------------------------------------------------------------

class DtypeDiscipline(Rule):
    """float64 belongs to the oracle (``kernels/ref.py``) and the byte-size
    table (``launch/roofline.py``); elsewhere it doubles memory traffic and
    runs at 1/64 of the H100's bf16 rate, so every other use carries an
    explicit ``# tracelint: allow[CFN102]`` pragma saying why.  The JAX
    package's numpy / dtype-string checks are kept as they are; the torch
    forms added: ``torch.double``, ``.double()``, ``.to(float)`` and
    ``dtype=float`` in a ``torch.*`` call (torch.float64, not a
    promotion hazard)."""

    id = "CFN102"
    title = "dtype discipline"
    WHITELIST_SUFFIXES = ("kernels/ref.py", "launch/roofline.py")
    DTYPE_STRS = {"float64", "f64"}
    DTYPE_CALLS = {"astype", "asarray", "array", "zeros", "ones", "full",
                   "empty", "arange"}

    def check(self, mod: Module) -> Iterable[Finding]:
        if mod.path.endswith(self.WHITELIST_SUFFIXES):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and node.attr == "float64":
                yield self.finding(
                    mod, node,
                    f"float64 reference `{_dotted(node)}` outside the f64 "
                    "oracle whitelist")
            elif isinstance(node, ast.Attribute) and node.attr == "double" \
                    and _dotted(node) == "torch.double":
                yield self.finding(
                    mod, node,
                    "float64 reference `torch.double` outside the f64 "
                    "oracle whitelist")
            elif isinstance(node, ast.Name) and node.id == "float64":
                yield self.finding(
                    mod, node,
                    "float64 reference outside the f64 oracle whitelist")
            elif isinstance(node, ast.Call):
                yield from self._check_call(mod, node)

    def _check_call(self, mod: Module, node: ast.Call) -> Iterable[Finding]:
        fn = _dotted(node.func)
        leaf = fn.split(".")[-1] if fn else ""
        torch_call = bool(fn) and fn.startswith("torch.")
        if isinstance(node.func, ast.Attribute) and not node.args:
            if node.func.attr == "double":
                yield self.finding(mod, node, "`.double()` casts to float64 "
                                   "outside the f64 oracle whitelist")
        if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
                and any(isinstance(a, ast.Name) and a.id == "float"
                        for a in node.args):
            yield self.finding(mod, node, "`.to(float)` casts to float64 "
                               "outside the f64 oracle whitelist")
        for kw in node.keywords:
            if kw.arg != "dtype":
                continue
            if isinstance(kw.value, ast.Constant) \
                    and kw.value.value in self.DTYPE_STRS:
                yield self.finding(
                    mod, node,
                    f'dtype="{kw.value.value}" outside the f64 oracle '
                    "whitelist")
            elif isinstance(kw.value, ast.Name) and kw.value.id == "float":
                if torch_call:
                    yield self.finding(
                        mod, node,
                        f"dtype=float in `{fn}` is torch.float64 (outside "
                        "the f64 oracle whitelist)")
                else:
                    yield self.finding(
                        mod, node,
                        "dtype=float promotes to float64 (implicit-"
                        "promotion hazard)", severity="warning")
        if leaf in self.DTYPE_CALLS:
            for arg in node.args:
                if isinstance(arg, ast.Constant) \
                        and arg.value in self.DTYPE_STRS:
                    yield self.finding(
                        mod, node,
                        f'`{leaf}(..., "{arg.value}")` outside the f64 '
                        "oracle whitelist")
                elif leaf == "astype" and isinstance(arg, ast.Name) \
                        and arg.id == "float":
                    yield self.finding(
                        mod, node,
                        "astype(float) promotes to float64 (implicit-"
                        "promotion hazard)", severity="warning")


# ---------------------------------------------------------------------------
# CFN103: pytree hygiene
# ---------------------------------------------------------------------------

class PytreeHygiene(Rule):
    """A dataclass registered as a pytree must account for EVERY field in
    its flatten function (a field that is neither a child nor context
    disappears through ``tree_map`` and comes back from a stale default),
    and ``degrade``-style value-only paths must never change a tensor's
    shape (the counted entries would see a fresh fingerprint, and a
    captured graph a different buffer).

    Flatten functions: the one handed to ``*.register_pytree_node(Cls,
    flatten, ...)`` (torch's ``utils._pytree``), or a ``tree_flatten``
    method.  ``dataclasses.fields(...)`` / ``__dataclass_fields__`` in
    the flatten function covers every field."""

    id = "CFN103"
    title = "pytree hygiene"
    SHAPE_OPS = {"cat", "concat", "concatenate", "pad", "stack", "hstack",
                 "vstack", "tile", "repeat", "repeat_interleave", "append",
                 "delete", "narrow"}
    VALUE_ONLY_NAMES = {"degrade"}

    @staticmethod
    def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
        for dec in cls.decorator_list:
            d = _dotted(dec) or (_dotted(dec.func)
                                 if isinstance(dec, ast.Call) else None)
            if d and d.split(".")[-1] == "dataclass":
                return True
        return False

    @staticmethod
    def _fields(cls: ast.ClassDef) -> List[str]:
        return [st.target.id for st in cls.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
                and "ClassVar" not in ast.dump(st.annotation)]

    @staticmethod
    def _str_tuples(tree: ast.AST) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {}
        for stmt in ast.walk(tree):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                elts = stmt.value.elts
                if elts and all(isinstance(e, ast.Constant)
                                and isinstance(e.value, str) for e in elts):
                    out[stmt.targets[0].id] = {e.value for e in elts}
        return out

    def _coverage(self, mod: Module, cls: ast.ClassDef, flatten: ast.AST,
                  self_name: str) -> Iterable[Finding]:
        fields = self._fields(cls)
        str_tuples = self._str_tuples(mod.tree)
        covered: Set[str] = set()
        for node in ast.walk(flatten):
            if isinstance(node, ast.Attribute):
                if node.attr == "__dataclass_fields__":
                    return
                if isinstance(node.value, ast.Name) \
                        and node.value.id == self_name:
                    covered.add(node.attr)
            elif isinstance(node, ast.Call) \
                    and _leaf(_dotted(node.func)) == "fields":
                return
            elif isinstance(node, ast.Name) and node.id in str_tuples:
                covered |= str_tuples[node.id]
        missing = [f for f in fields if f not in covered]
        if missing:
            yield self.finding(
                mod, flatten,
                f"pytree `{cls.name}`: field(s) {', '.join(missing)} are "
                "neither child nor context in its flatten function "
                "(dropped through tree_map, resurrected stale by "
                "unflatten)")

    def _check_value_only(self, mod: Module,
                          fn: ast.FunctionDef) -> Iterable[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            leaf = _leaf(_dotted(node.func))
            if leaf in self.SHAPE_OPS:
                yield self.finding(
                    mod, node,
                    f"shape-changing `{leaf}` inside value-only path "
                    f"`{fn.name}` (fail/recover must keep the counted "
                    "entries on their shape fingerprints)")
            elif leaf in ("reshape", "view", "expand") and any(
                    not isinstance(a, (ast.Constant, ast.UnaryOp))
                    for a in node.args):
                yield self.finding(
                    mod, node,
                    f"`{leaf}` with non-static args inside value-only "
                    f"path `{fn.name}`")

    def check(self, mod: Module) -> Iterable[Finding]:
        classes = {n.name: n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.ClassDef)
                   and self._is_dataclass_decorated(n)}
        funcs = _module_functions(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name in classes:
                flatten = next((n for n in node.body
                                if isinstance(n, ast.FunctionDef)
                                and n.name == "tree_flatten"), None)
                if flatten is not None:
                    yield from self._coverage(mod, node, flatten, "self")
            elif isinstance(node, ast.Call) \
                    and _leaf(_dotted(node.func)) in (
                        "register_pytree_node", "_register_pytree_node") \
                    and len(node.args) >= 2:
                cls = classes.get(_dotted(node.args[0]) or "")
                fl = node.args[1]
                fn = funcs.get(fl.id) if isinstance(fl, ast.Name) else (
                    fl if isinstance(fl, ast.Lambda) else None)
                if cls is None or fn is None or not fn.args.args:
                    continue
                yield from self._coverage(mod, cls, fn, fn.args.args[0].arg)
            elif isinstance(node, ast.FunctionDef) \
                    and node.name in self.VALUE_ONLY_NAMES:
                yield from self._check_value_only(mod, node)


# ---------------------------------------------------------------------------
# CFN104: trace-counter coverage
# ---------------------------------------------------------------------------

class TraceCounterCoverage(Rule):
    """The port's counterparts of the JAX package's counted solver
    entries (``COUNTED_ENTRIES``) carry ``@count_traces`` with the same
    ``TRACE_COUNTS`` name, so the shape-stability tests and the CFN108
    bounds read one set of names in both packages; and a
    ``torch.compile``d entry in those modules counts under the compile
    (above it, the counter ticks per call, not per fresh shape).

    Scope: ``core/solvers.py`` and ``core/federation.py``."""

    id = "CFN104"
    title = "trace-counter coverage"

    def check(self, mod: Module) -> Iterable[Finding]:
        table = next((t for suffix, t in COUNTED_ENTRIES.items()
                      if mod.path.endswith(suffix)), None)
        if table is None:
            return
        for name, fn in _toplevel_functions(mod.tree).items():
            cts = [(i, d) for i, d in enumerate(fn.decorator_list)
                   if _is_count_traces_decorator(d)]
            comp = [i for i, d in enumerate(fn.decorator_list)
                    if _is_compile_decorator(d)]
            if name in table:
                want = table[name]
                if not cts:
                    yield self.finding(
                        mod, fn,
                        f"counted solver entry `{name}` does not increment "
                        f"TRACE_COUNTS (add @count_traces(\"{want}\"))")
                elif _count_traces_name(cts[0][1]) != want:
                    yield self.finding(
                        mod, fn,
                        f"counted solver entry `{name}` counts under "
                        f"`{_count_traces_name(cts[0][1])}`, not the JAX "
                        f"package's `{want}`")
            if comp and not cts:
                yield self.finding(
                    mod, fn,
                    f"compiled solver entry `{name}` does not increment "
                    "TRACE_COUNTS (add @count_traces under @torch.compile)")
            elif comp and cts and cts[0][0] < comp[0]:
                yield self.finding(
                    mod, fn,
                    f"`{name}`: @count_traces must sit UNDER "
                    "@torch.compile (above it, the counter ticks per call, "
                    "not per fresh shape)")


# ---------------------------------------------------------------------------
# CFN105: shared memory
# ---------------------------------------------------------------------------

class NotStatic(Exception):
    """An expression the shared-memory evaluator does not take."""


class _Return(Exception):
    def __init__(self, value):
        self.value = value


_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.FloorDiv: operator.floordiv,
           ast.Mod: operator.mod, ast.Pow: operator.pow,
           ast.Div: operator.truediv, ast.BitAnd: operator.and_,
           ast.BitOr: operator.or_, ast.BitXor: operator.xor,
           ast.LShift: operator.lshift, ast.RShift: operator.rshift}
_CMPOPS = {ast.Eq: operator.eq, ast.NotEq: operator.ne,
           ast.Lt: operator.lt, ast.LtE: operator.le,
           ast.Gt: operator.gt, ast.GtE: operator.ge}
_BUILTINS = {"max": max, "min": min, "abs": abs, "int": int, "bool": bool,
             "len": len, "range": range}


class _Lambda:
    def __init__(self, node: ast.Lambda, env: dict):
        self.node, self.env = node, env


class SmemEvaluator:
    """Evaluates a module's pure integer functions (the shared-memory
    mirrors and what they call) on the AST: constants, arithmetic,
    comparisons, ``if`` / ``while`` / ``for`` over tuples and
    ``range``, tuple unpacking, lambdas, ``max`` / ``min`` / ``abs`` /
    ``int``, and calls to the module's own top-level functions.  Nothing
    of the module is imported or run; anything else raises
    ``NotStatic``."""

    MAX_STEPS = 200000

    def __init__(self, mod: Module):
        self.funcs = _toplevel_functions(mod.tree)
        self.consts: Dict[str, object] = {}
        self.steps = 0
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                try:
                    self.consts[node.targets[0].id] = self.eval(
                        node.value, {})
                except NotStatic:
                    pass

    def call(self, fn: ast.FunctionDef, args: tuple, kwargs: dict,
             depth: int = 0):
        if depth > 20:
            raise NotStatic("recursion")
        a = fn.args
        pos = list(getattr(a, "posonlyargs", [])) + list(a.args)
        env: Dict[str, object] = {}
        defaults = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                            a.defaults))
        defaults.update({p.arg: d for p, d in zip(a.kwonlyargs,
                                                  a.kw_defaults)
                         if d is not None})
        for p, v in zip(pos, args):
            env[p.arg] = v
        for p in pos + list(a.kwonlyargs):
            if p.arg in kwargs:
                env[p.arg] = kwargs[p.arg]
            elif p.arg not in env:
                if p.arg not in defaults:
                    raise NotStatic(f"no value for `{p.arg}`")
                env[p.arg] = self.eval(defaults[p.arg], {})
        try:
            self._block(fn.body, env, depth)
        except _Return as r:
            return r.value
        return None

    def _tick(self) -> None:
        self.steps += 1
        if self.steps > self.MAX_STEPS:
            raise NotStatic("too many steps")

    def _block(self, body, env, depth) -> None:
        for st in body:
            self._stmt(st, env, depth)

    def _assign(self, target, value, env) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = list(value)
            if len(vals) != len(target.elts):
                raise NotStatic("unpack")
            for t, v in zip(target.elts, vals):
                self._assign(t, v, env)
        else:
            raise NotStatic("assignment target")

    def _stmt(self, st, env, depth) -> None:
        self._tick()
        if isinstance(st, ast.Expr):
            if not (isinstance(st.value, ast.Constant)
                    and isinstance(st.value.value, str)):
                self.eval(st.value, env, depth)
        elif isinstance(st, ast.Assign):
            v = self.eval(st.value, env, depth)
            for t in st.targets:
                self._assign(t, v, env)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            self._assign(st.target, self.eval(st.value, env, depth), env)
        elif isinstance(st, ast.AugAssign) \
                and isinstance(st.target, ast.Name):
            op = _BINOPS.get(type(st.op))
            if op is None or st.target.id not in env:
                raise NotStatic("augmented assignment")
            env[st.target.id] = op(env[st.target.id],
                                   self.eval(st.value, env, depth))
        elif isinstance(st, ast.Return):
            raise _Return(None if st.value is None
                          else self.eval(st.value, env, depth))
        elif isinstance(st, ast.If):
            self._block(st.body if self.eval(st.test, env, depth)
                        else st.orelse, env, depth)
        elif isinstance(st, ast.While):
            while self.eval(st.test, env, depth):
                self._tick()
                self._block(st.body, env, depth)
        elif isinstance(st, ast.For):
            for v in self.eval(st.iter, env, depth):
                self._tick()
                self._assign(st.target, v, env)
                self._block(st.body, env, depth)
        elif isinstance(st, ast.Pass):
            pass
        else:
            raise NotStatic(type(st).__name__)

    def eval(self, node, env, depth: int = 0):
        self._tick()
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if node.id in self.consts:
                return self.consts[node.id]
            if node.id in ("True", "False", "None"):
                return {"True": True, "False": False, "None": None}[node.id]
            raise NotStatic(f"name `{node.id}`")
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise NotStatic("operator")
            right = self.eval(node.right, env, depth)
            if op in (operator.floordiv, operator.mod, operator.truediv) \
                    and right == 0:
                raise NotStatic("division by zero")
            return op(self.eval(node.left, env, depth), right)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, env, depth)
            return {ast.USub: operator.neg, ast.UAdd: operator.pos,
                    ast.Not: operator.not_,
                    ast.Invert: operator.invert}[type(node.op)](v)
        if isinstance(node, ast.BoolOp):
            v = None
            for x in node.values:
                v = self.eval(x, env, depth)
                if isinstance(node.op, ast.And) and not v:
                    return v
                if isinstance(node.op, ast.Or) and v:
                    return v
            return v
        if isinstance(node, ast.Compare):
            left = self.eval(node.left, env, depth)
            for op, c in zip(node.ops, node.comparators):
                right = self.eval(c, env, depth)
                f = _CMPOPS.get(type(op))
                if f is None:
                    raise NotStatic("comparison")
                if not f(left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return self.eval(node.body if self.eval(node.test, env, depth)
                             else node.orelse, env, depth)
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self.eval(e, env, depth) for e in node.elts)
        if isinstance(node, ast.Subscript):
            return self.eval(node.value, env, depth)[
                self.eval(node.slice, env, depth)]
        if isinstance(node, ast.Lambda):
            return _Lambda(node, dict(env))
        if isinstance(node, ast.Call):
            args = tuple(self.eval(a, env, depth) for a in node.args)
            kwargs = {k.arg: self.eval(k.value, env, depth)
                      for k in node.keywords if k.arg is not None}
            if isinstance(node.func, ast.Name):
                name = node.func.id
                target = env.get(name)
                if isinstance(target, _Lambda):
                    lenv = dict(target.env)
                    for p, v in zip(target.node.args.args, args):
                        lenv[p.arg] = v
                    return self.eval(target.node.body, lenv, depth)
                if name in self.funcs:
                    return SmemEvaluator.call(self, self.funcs[name], args,
                                              kwargs, depth + 1)
                if name in _BUILTINS:
                    return _BUILTINS[name](*args, **kwargs)
            raise NotStatic(f"call `{_dotted(node.func)}`")
        raise NotStatic(type(node).__name__)


class SharedMemoryBudget(Rule):
    """Every ``*_launch_smem`` function -- the Python mirror of the
    dynamic shared memory a CUDA launcher requests at a launch shape --
    evaluated at ``MAX_SCALE`` (its parameters by name; defaults where
    MAX_SCALE has none) must fit the block's opt-in limit (the module's
    ``SMEM_PER_BLOCK`` or ``SMEM_PER_BLOCK_BYTES``); a mirror the
    evaluator cannot take is a warning.  Also flags loops over
    non-constexpr bounds in ``@triton.jit`` bodies: the trip count is
    unknown when the kernel compiles, so ``tl.static_range`` fails on it
    and a ``range`` is neither unrolled nor pipelined."""

    id = "CFN105"
    title = "shared-memory budget"
    SUFFIX = "_launch_smem"

    def check(self, mod: Module) -> Iterable[Finding]:
        top = _toplevel_functions(mod.tree)
        mirrors = [f for n, f in top.items() if n.endswith(self.SUFFIX)]
        if mirrors:
            ev = SmemEvaluator(mod)
            limit = ev.consts.get("SMEM_PER_BLOCK", SMEM_PER_BLOCK_BYTES)
            for fn in mirrors:
                yield from self._check_mirror(mod, ev, fn, limit)
        yield from self._triton_loops(mod, top)

    def _check_mirror(self, mod, ev, fn, limit) -> Iterable[Finding]:
        kwargs = {}
        a = fn.args
        for p in list(a.args) + list(a.kwonlyargs):
            if p.arg in MAX_SCALE:
                kwargs[p.arg] = MAX_SCALE[p.arg]
        at = ", ".join(f"{k}={v}" for k, v in kwargs.items())
        try:
            ev.steps = 0
            got = ev.call(fn, (), kwargs)
        except NotStatic as e:
            yield self.finding(
                mod, fn,
                f"shared-memory mirror `{fn.name}` is not statically "
                f"evaluable at MAX_SCALE ({e})", severity="warning")
            return
        if not isinstance(got, int):
            yield self.finding(
                mod, fn, f"shared-memory mirror `{fn.name}` does not return "
                "a byte count", severity="warning")
        elif got > limit:
            yield self.finding(
                mod, fn,
                f"`{fn.name}` requests {got} bytes of shared memory at "
                f"MAX_SCALE ({at}), over the block's {limit}")

    @staticmethod
    def _is_triton_jit(fn: ast.FunctionDef) -> bool:
        for d in fn.decorator_list:
            t = _dotted(d) or (_dotted(d.func) if isinstance(d, ast.Call)
                               else None)
            if t in ("triton.jit", "jit") or (t or "").endswith(
                    "triton.jit"):
                return True
        return False

    def _triton_loops(self, mod, top) -> Iterable[Finding]:
        for name, fn in top.items():
            if not self._is_triton_jit(fn):
                continue
            constexpr = {p.arg for p in fn.args.args
                         if p.annotation is not None
                         and _leaf(_dotted(p.annotation)) == "constexpr"}
            for node in ast.walk(fn):
                if not (isinstance(node, ast.For)
                        and isinstance(node.iter, ast.Call)
                        and _leaf(_dotted(node.iter.func)) in (
                            "range", "static_range")):
                    continue
                for arg in node.iter.args:
                    names = {n.id for n in ast.walk(arg)
                             if isinstance(n, ast.Name)}
                    if any(isinstance(n, (ast.Call, ast.Attribute,
                                          ast.Subscript))
                           for n in ast.walk(arg)) \
                            or not names <= constexpr:
                        yield self.finding(
                            mod, node,
                            f"loop over a non-constexpr bound in Triton "
                            f"kernel `{name}` (its trip count is unknown "
                            "when the kernel compiles; make the bound a "
                            "tl.constexpr)")
                        break


def all_rules() -> List[Rule]:
    from . import rules_flow
    return [RetraceHazards(), DtypeDiscipline(), PytreeHygiene(),
            TraceCounterCoverage(), SharedMemoryBudget()] \
        + list(rules_flow.flow_rules())
