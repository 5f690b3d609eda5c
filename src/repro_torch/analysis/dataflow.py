"""Flow-sensitive, interprocedural dataflow core of the port's tracelint.

The JAX package's engine (``repro.analysis.dataflow``) with its vocabulary
in torch terms.  The syntactic rules (CFN101-CFN105, ``rules.py``) see
one module and one statement at a time; the CFN106-CFN109 families
(``rules_flow.py``) need values flowing between statements and functions:
which random draws use the global stream, which generator a loop re-seeds,
which buffers a kernel launch reads and writes, which shape-determining
values reach a counted solver entry.  This module supplies:

  * ``ProjectIndex`` -- function tables per module (methods and nested
    defs included), import resolution (absolute and relative), call
    resolution for bare names, ``module.fn`` attributes and
    ``self.method`` calls, the counted entries (``@count_traces``, and
    names bound to ``vmap`` / ``torch.compile`` / ``partial`` of one),
    and the callers of every function (CFN101 follows callables back to
    them).
  * ``FlowWalker`` -- an abstract interpreter over one function body.
    The environment maps variable names (``self.attr`` pseudo-variables
    included) to abstract values: a set of definition sites (def-use
    chains: reassignment kills, aliases share) and a set of provenance
    atoms (a small lattice: const < finite(k) < param < bucket < opaque)
    that bounds the counted entries' shape-fingerprint key-spaces.
    ``if`` / ``else`` forks the environment and merges by union; loop
    bodies are walked once with the loop recorded on every fact.
  * function summaries, computed to fixpoint over the project call
    graph: the bucket and finite atoms a function's return values carry,
    so a helper that buckets a shape (``federation._batch_inputs``)
    passes its axes on to the entry its caller feeds.
  * per-entry records: every call site of a counted entry with the
    provenance-derived axes of its arguments (``compute_cache_bounds``
    in ``rules_flow`` builds on them).

Scope and limits: a launch is recognized by its exported name
(``LAUNCH_OUTPUTS``) or as a call of a Python in-place consumer
(``INPLACE_CONSUMERS``); buffers are matched through plain names,
``_ptr(t)`` / ``p(t)`` / ``c_void_p(t.data_ptr())`` and a local tuple of
those unpacked with ``*``; exceptional control flow is assumed to fall
through.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from .engine import Module, Project, module_name
from .rules import (_dotted, _is_count_traces_decorator, _leaf,
                    _scalar_annotation, _unwrap_to_names)

# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

# torch draws that take ``generator=``: without it they use the global
# stream (every caller of the global seed shares one sequence)
_DRAW_FNS = {"rand", "randn", "randint", "randperm", "bernoulli",
             "multinomial", "normal", "poisson"}
# draws with no ``generator=`` at all: always the global stream
_GLOBAL_ONLY_DRAWS = {"rand_like", "randn_like", "randint_like"}
# in-place tensor draws (``t.uniform_(a, b, generator=g)``) and
# ``torch.nn.init``'s
_DRAW_METHODS = {"uniform_", "normal_", "random_", "exponential_",
                 "bernoulli_", "cauchy_", "geometric_", "log_normal_"}
_INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
               "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
               "orthogonal_", "sparse_"}
# (re-)seeding a stream: the first argument is the seed
_SEED_FNS = {"manual_seed"}

# shape-bucketing helpers: results take finitely many values (the pow-2
# bucket policy), so a bucketed value feeding an entry is a bounded
# cache axis, not an unbounded one
_BUCKET_FNS = {"_pow2", "_pad_positions", "_pad_links", "_bucket_rows",
               "pow2", "next_pow2", "bucket"}

# calls whose results inherit their arguments' provenance even when the
# callee is not resolved (pure tensor/math/builtin surface); an
# UNRESOLVED call with no rooted argument and not on this surface is
# opaque -- the "unbounded" end of the lattice
_PURE_PREFIXES = ("torch.", "np.", "numpy.", "math.", "functools.", "F.")
_PURE_BARE = {
    "len", "int", "float", "bool", "str", "abs", "min", "max", "sum",
    "round", "sorted", "list", "tuple", "set", "dict", "frozenset",
    "range", "enumerate", "zip", "map", "filter", "reversed", "getattr",
    "hasattr", "isinstance", "print", "repr", "divmod", "pow", "any",
    "all", "slice", "iter", "next", "vars", "id", "type", "format",
}

# assignments of these calls to a never-read name are dead device compute
# (CFN109): tensors from ``torch.*`` (less the namespaces that make no
# tensor), ``torch.as_tensor``, host copies of device values
_DEVICE_PREFIXES = ("torch.",)
_NOT_TENSOR_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.profiler.", "torch.jit.", "torch.nn.Module", "torch.nn.Parameter",
    "torch.autograd.", "torch.set_", "torch.get_", "torch.is_",
    "torch.use_", "torch.Generator", "torch.device", "torch.Size",
    "torch.dtype", "torch.finfo", "torch.iinfo", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.compile",
    "torch.manual_seed", "torch.load", "torch.save", "torch.library.",
    "torch.func.", "torch.vmap", "torch._")
_DEVICE_EXACT = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                 "torch.as_tensor"}
# tensor methods whose result is a tensor (or a host copy of one)
_TENSOR_METHODS = {
    "to", "cuda", "cpu", "numpy", "contiguous", "clone", "detach", "float",
    "half", "bfloat16", "long", "int", "bool", "sum", "mean", "amax",
    "amin", "argmax", "argmin", "cumsum", "matmul", "reshape", "view",
    "permute", "transpose", "expand", "gather", "scatter", "index_select",
    "masked_fill", "softmax", "exp", "log", "sqrt", "abs", "clamp",
    "clamp_min", "clamp_max", "norm", "square", "flatten", "squeeze",
    "unsqueeze", "new_zeros", "new_ones", "new_empty", "new_full",
    "new_tensor", "type_as", "expand_as", "view_as", "reshape_as"}

# the output pointer slots of the CUDA launchers' C interfaces
# (``csrc/*.cu``: the non-const pointers before the stream; the CPU tests
# hold this table to the sources)
LAUNCH_OUTPUTS: Dict[str, Tuple[int, ...]] = {
    "placement_power_launch": (8,),
    "fused_anneal_launch": (16, 17, 18),
    "flash_attention_launch": (5,),
    "flash_attention_wgmma_launch": (5,),
    "flash_attention_decode_launch": (5, 6, 7, 8),
}
# Python functions that launch a kernel into buffers their caller hands
# them: (defining module suffix, name) -> output argument slots
INPLACE_CONSUMERS: Dict[Tuple[str, str], Tuple[int, ...]] = {
    ("kernels/placement_power.py", "placement_power_launch"): (0,),
    ("kernels/placement_power.py", "fused_anneal_launch"): (0, 1),
}
# wrappers that hand a tensor's device pointer to a launch
_PTR_WRAPPERS = {"_ptr", "p", "c_void_p", "ctypes.c_void_p"}


def _is_global_draw(t: Optional[str], node: ast.Call) -> Optional[str]:
    """The draw's name when the call draws from the global stream."""
    if not t:
        return None
    parts = t.split(".")
    leaf = parts[-1]
    gen = [k for k in node.keywords if k.arg == "generator"]
    no_gen = not gen or (isinstance(gen[0].value, ast.Constant)
                         and gen[0].value.value is None)
    torch_fn = len(parts) >= 2 and parts[0] == "torch" and (
        len(parts) == 2 or parts[1] == "random")
    if torch_fn and leaf in _GLOBAL_ONLY_DRAWS:
        return t
    if torch_fn and leaf in _DRAW_FNS and no_gen:
        return t
    if leaf in _INIT_DRAWS and len(parts) >= 2 and parts[-2] == "init" \
            and no_gen:
        return t
    if leaf in _DRAW_METHODS and isinstance(node.func, ast.Attribute) \
            and not (len(parts) >= 2 and parts[-2] == "init") and no_gen:
        return f".{leaf}"
    return None


def _walk_own(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` of a function's own code: nested defs and classes are
    not entered (they are functions of their own); lambdas are."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------

# a definition site: (module_path, line, distinguishing_token)
DefSite = Tuple[str, int, str]

# provenance atoms (the CFN108 lattice):
#   ("const",)             literal / module constant          card 1
#   ("finite", name, k)    one of k literal options           card k
#   ("param", name)        rooted at a caller-supplied value  card per scenario
#   ("bucket", name)       through the pow-2 bucket policy    card #buckets
#   ("opaque", name)       unknown origin                     unbounded
Atom = Tuple


@dataclasses.dataclass(frozen=True)
class Val:
    defs: FrozenSet[DefSite] = frozenset()
    prov: FrozenSet[Atom] = frozenset()

    @staticmethod
    def merge(vals: Iterable["Val"]) -> "Val":
        defs: Set[DefSite] = set()
        prov: Set[Atom] = set()
        for v in vals:
            defs |= v.defs
            prov |= v.prov
        return Val(frozenset(defs), frozenset(prov))


CONST = Val(prov=frozenset({("const",)}))


# ---------------------------------------------------------------------------
# per-function facts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheAxis:
    name: str                  # "resolve_incremental.pad_changed_to"
    kind: str      # "const" | "finite" | "param" | "bucket" | "unbounded"
    card: Optional[int]        # finite k; None otherwise
    static: bool = False       # reaches a parameter annotated as a scalar


@dataclasses.dataclass
class EntryCall:
    entry: str                 # TRACE_COUNTS name
    path: str
    context: str               # caller qualname
    line: int
    axes: Tuple[CacheAxis, ...]


@dataclasses.dataclass
class AliasEvent:
    var: str                   # the buffer written and read
    launch: str                # the launcher's name
    line: int


@dataclasses.dataclass
class FuncFacts:
    qual: str
    path: str
    line: int
    params: List[str] = dataclasses.field(default_factory=list)
    # (line, draw) of every draw on the global random stream
    global_draws: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)
    # (line, call, loop line) of a loop-invariant re-seed inside a loop
    reseeds: List[Tuple[int, str, int]] = dataclasses.field(
        default_factory=list)
    loop_stores: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    loads: Set[str] = dataclasses.field(default_factory=set)
    dead_assigns: List[Tuple[int, str, str]] = dataclasses.field(
        default_factory=list)
    alias_events: List[AliasEvent] = dataclasses.field(default_factory=list)
    entry_calls: List[EntryCall] = dataclasses.field(default_factory=list)
    # bucket / finite atoms the function's return values carry
    return_atoms: Set[Atom] = dataclasses.field(default_factory=set)


# ---------------------------------------------------------------------------
# project index: functions, imports, entries, callers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    mod: Module
    node: ast.AST              # FunctionDef / AsyncFunctionDef
    qual: str
    class_name: Optional[str]

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return [x.arg for x in
                list(getattr(a, "posonlyargs", [])) + list(a.args)]

    @property
    def kwonly(self) -> List[str]:
        return [x.arg for x in self.node.args.kwonlyargs]


@dataclasses.dataclass
class EntryDef:
    name: str                  # the count_traces literal
    mod: Module
    fn: ast.AST                # the counted FunctionDef
    callables: Set[str]        # names that invoke it in the defining module
    static_names: Set[str]


def _static_names(fn: ast.AST) -> Set[str]:
    """Parameters of a counted entry its fingerprint keys by value: those
    annotated as Python scalars (``n_sweeps: int``)."""
    a = fn.args
    return {p.arg for p in list(getattr(a, "posonlyargs", [])) + list(a.args)
            + list(a.kwonlyargs) if _scalar_annotation(p.annotation)}


class ProjectIndex:
    """Name resolution over the whole project (the call graph substrate)."""

    def __init__(self, project: Project):
        self.project = project
        self.funcs: Dict[Tuple[str, str], FuncInfo] = {}   # (path, qual)
        self.bare: Dict[str, Dict[str, FuncInfo]] = {}     # path -> name -> fi
        self.methods: Dict[str, Dict[str, Dict[str, FuncInfo]]] = {}
        self.imports: Dict[str, Dict[str, Tuple]] = {}     # path -> alias
        self.const_dicts: Dict[str, Dict[str, int]] = {}   # path -> name
        self.entries: Dict[str, Dict[str, EntryDef]] = {}  # path -> callable
        self.entry_defs: Dict[str, EntryDef] = {}          # entry name -> def
        self._callers: Optional[Dict[Tuple[str, str], List[tuple]]] = None
        for m in project.modules:
            self._index_module(m)
        for m in project.modules:
            self._index_entry_aliases(m)

    # -- per-module tables --------------------------------------------------

    def _index_module(self, mod: Module) -> None:
        p = mod.path
        self.bare[p] = {}
        self.methods[p] = {}
        self.imports[p] = self._imports(mod)
        self.const_dicts[p] = {}
        self.entries[p] = {}
        self._index_defs(mod, mod.tree, (), None)
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Dict):
                self.const_dicts[p][node.targets[0].id] = \
                    len(node.value.keys)
        self._index_entries(mod)

    def _index_defs(self, mod: Module, node: ast.AST, stack: tuple,
                    class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + (child.name,))
                fi = FuncInfo(mod, child, qual, class_name)
                self.funcs[(mod.path, qual)] = fi
                if class_name is None:
                    # bare-name reachable (module-level and nested defs);
                    # first (outermost) definition wins
                    self.bare[mod.path].setdefault(child.name, fi)
                else:
                    self.methods[mod.path].setdefault(class_name, {})
                    self.methods[mod.path][class_name][child.name] = fi
                self._index_defs(mod, child, stack + (child.name,),
                                 class_name)
            elif isinstance(child, ast.ClassDef):
                self._index_defs(mod, child, stack + (child.name,),
                                 child.name)
            else:
                self._index_defs(mod, child, stack, class_name)

    def _imports(self, mod: Module) -> Dict[str, Tuple]:
        out: Dict[str, Tuple] = {}
        base = (module_name(mod.path) or "").split(".")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = ("mod", a.name)
                    else:
                        out[a.name.split(".")[0]] = \
                            ("mod", a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    parent = base[:-node.level] if node.level <= len(base) \
                        else []
                    target = ".".join(parent + ([node.module]
                                                if node.module else []))
                else:
                    target = node.module or ""
                for a in node.names:
                    out[a.asname or a.name] = ("attr", target, a.name)
        return out

    def _index_entries(self, mod: Module) -> None:
        for fn in mod.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ct = next((d for d in fn.decorator_list
                       if _is_count_traces_decorator(d)), None)
            if ct is None:
                continue
            name = (ct.args[0].value if ct.args
                    and isinstance(ct.args[0], ast.Constant) else fn.name)
            e = EntryDef(name, mod, fn, {fn.name}, _static_names(fn))
            self.entries[mod.path][fn.name] = e
            self.entry_defs.setdefault(name, e)

    def _index_entry_aliases(self, mod: Module) -> None:
        """``g = vmap(entry, ...)`` / ``torch.compile(entry)`` /
        ``partial(entry, ...)`` at module level: calling ``g`` calls the
        entry (it counts per fresh shape inside the transform)."""
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and node.value.args
                    and _leaf(_dotted(node.value.func)) in (
                        "vmap", "compile", "partial")):
                continue
            e = self.resolve_entry(mod, _dotted(node.value.args[0]))
            if e is None:
                names = _unwrap_to_names(node.value.args[0])
                e = self.entries[mod.path].get(names[0]) if names else None
            if e is not None:
                self.entries[mod.path][node.targets[0].id] = e

    # -- resolution ---------------------------------------------------------

    def _module_for(self, mod: Module, head: str) -> Optional[Module]:
        imp = self.imports[mod.path].get(head)
        if imp is None:
            return None
        if imp[0] == "mod":
            return self.project.by_name.get(imp[1])
        target, attr = imp[1], imp[2]
        return self.project.by_name.get(f"{target}.{attr}")

    def resolve_func(self, mod: Module, dotted: Optional[str],
                     class_name: Optional[str] = None) -> Optional[FuncInfo]:
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 2 and parts[0] == "self" and class_name:
            return self.methods[mod.path].get(class_name, {}).get(parts[1])
        if len(parts) == 1:
            fi = self.bare[mod.path].get(parts[0])
            if fi is not None:
                return fi
            imp = self.imports[mod.path].get(parts[0])
            if imp and imp[0] == "attr":
                m = self.project.by_name.get(imp[1])
                if m is not None:
                    return self.bare[m.path].get(imp[2])
            return None
        if len(parts) == 2:
            m = self._module_for(mod, parts[0])
            if m is not None:
                return self.bare[m.path].get(parts[1])
        # fully-dotted module path: repro_torch.core.solvers.anneal
        for i in range(len(parts) - 1, 0, -1):
            m = self.project.by_name.get(".".join(parts[:i]))
            if m is not None and i == len(parts) - 1:
                return self.bare[m.path].get(parts[-1])
        return None

    def resolve_entry(self, mod: Module,
                      dotted: Optional[str]) -> Optional[EntryDef]:
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 1:
            e = self.entries[mod.path].get(parts[0])
            if e is None:
                imp = self.imports[mod.path].get(parts[0])
                if imp and imp[0] == "attr":
                    m = self.project.by_name.get(imp[1])
                    if m is not None:
                        e = self.entries[m.path].get(imp[2])
            return e
        if len(parts) == 2:
            m = self._module_for(mod, parts[0])
            if m is not None:
                return self.entries[m.path].get(parts[1])
        return None

    def resolve_const_dict(self, mod: Module,
                           dotted: Optional[str]) -> Optional[int]:
        if not dotted:
            return None
        parts = dotted.split(".")
        if len(parts) == 1:
            return self.const_dicts[mod.path].get(parts[0])
        if len(parts) == 2:
            m = self._module_for(mod, parts[0])
            if m is not None:
                return self.const_dicts[m.path].get(parts[1])
        return None

    def callers(self, fi: FuncInfo) -> List[Tuple[Module, Optional[FuncInfo],
                                                  ast.Call]]:
        """Every call site in the project that resolves to ``fi``: (the
        caller's module, the calling function or None at module level,
        the call)."""
        if self._callers is None:
            self._callers = {}
            scopes = [(m, None, m.tree) for m in self.project.modules] + [
                (c.mod, c, c.node) for c in self.funcs.values()]
            for m, caller, root in scopes:
                cls = caller.class_name if caller is not None else None
                for node in _walk_own(root):
                    if not isinstance(node, ast.Call):
                        continue
                    tgt = self.resolve_func(m, _dotted(node.func), cls)
                    if tgt is not None:
                        self._callers.setdefault(
                            (tgt.mod.path, tgt.qual), []).append(
                                (m, caller, node))
        return self._callers.get((fi.mod.path, fi.qual), [])


def project_index(project: Project) -> ProjectIndex:
    """The project's index, built once per analysis run."""
    return project.cache("index", lambda: ProjectIndex(project))


# ---------------------------------------------------------------------------
# the flow walker
# ---------------------------------------------------------------------------

def _target_name(node: ast.AST) -> Optional[str]:
    """Plain assignable name: ``x`` or the ``self.attr`` pseudo-variable."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return f"self.{node.attr}"
    return None


def _stored_names(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, (ast.Name, ast.Attribute)) \
                and isinstance(getattr(n, "ctx", None), ast.Store):
            t = _target_name(n)
            if t:
                out.add(t)
    return out


def _loaded_names(fn: ast.AST) -> Set[str]:
    """Every name (and ``self.attr``) read anywhere in ``fn``, nested
    scopes included -- the scope-wide liveness set of the dead-compute
    check."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
        elif isinstance(n, ast.Attribute) \
                and isinstance(n.ctx, ast.Load):
            t = _target_name(n)
            if t:
                out.add(t)
    return out


def _is_device_call(t: Optional[str], node: ast.Call) -> bool:
    if not t:
        return False
    if t in _DEVICE_EXACT:
        return True
    if t.startswith(_DEVICE_PREFIXES) and not t.startswith(
            _NOT_TENSOR_PREFIXES):
        return True
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr in _TENSOR_METHODS \
        and not t.startswith(("self.", "np.", "numpy.", "math.", "os.",
                              "json.", "time."))


class FlowWalker:
    """Abstract interpretation of one function body (see module docstring)."""

    def __init__(self, analyzer: "Analyzer", fi: FuncInfo):
        self.an = analyzer
        self.fi = fi
        self.mod = fi.mod
        self.facts = FuncFacts(qual=fi.qual, path=fi.mod.path,
                               line=fi.node.lineno, params=fi.params)
        self.env: Dict[str, Val] = {}
        self.loops: Tuple[int, ...] = ()
        self._fresh = 0
        for p in fi.params + fi.kwonly:
            site = (fi.mod.path, fi.node.lineno, f"param:{p}")
            self.env[p] = Val(frozenset({site}),
                              frozenset({("param", f"{fi.qual}.{p}")}))

    # -- plumbing -----------------------------------------------------------

    def _site(self, line: int, token: str) -> DefSite:
        self._fresh += 1
        return (self.mod.path, line, f"{token}#{self._fresh}")

    def _bind(self, name: str, val: Val) -> None:
        self.env[name] = val

    # -- expressions --------------------------------------------------------

    def eval(self, node: Optional[ast.AST]) -> Val:
        if node is None or isinstance(node, ast.Constant):
            return CONST
        if isinstance(node, ast.Name):
            return self.env.get(node.id, CONST)
        if isinstance(node, ast.Attribute):
            return self._eval_attr(node)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.Subscript):
            return self._eval_subscript(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return Val.merge([self.eval(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return Val.merge([self.eval(e) for e in
                              list(node.keys) + list(node.values)
                              if e is not None])
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return Val.merge([self.eval(node.body), self.eval(node.orelse)])
        if isinstance(node, ast.BoolOp):
            return Val.merge([self.eval(v) for v in node.values])
        if isinstance(node, ast.BinOp):
            return Val.merge([self.eval(node.left), self.eval(node.right)])
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, ast.Compare):
            return Val.merge([self.eval(node.left)]
                             + [self.eval(c) for c in node.comparators])
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # comprehensions: evaluate iterables for provenance; the
            # element expression runs in its own scope (not walked)
            return Val.merge([self.eval(g.iter) for g in node.generators])
        if isinstance(node, ast.NamedExpr):
            val = self.eval(node.value)
            t = _target_name(node.target)
            if t:
                self._bind(t, val)
            return val
        return CONST

    def _eval_attr(self, node: ast.Attribute) -> Val:
        t = _target_name(node)
        if t is not None and t in self.env:
            return self.env[t]
        # attribute chain rooted at a local value (problem.R, aux.free_pos)
        root = node
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in self.env:
            return self.env[root.id]
        return CONST          # module attribute (torch.int32, solvers.X, ...)

    def _eval_subscript(self, node: ast.Subscript) -> Val:
        base = _dotted(node.value)
        k = self.an.index.resolve_const_dict(self.mod, base)
        idx = node.slice
        if k is not None:
            nm = idx.id if isinstance(idx, ast.Name) else (base or "idx")
            self.eval(idx)
            return Val(prov=frozenset({("finite",
                                        f"{self.fi.qual}.{nm}", k)}))
        return Val.merge([self.eval(node.value), self.eval(idx)])

    # -- calls --------------------------------------------------------------

    def _arg_vals(self, node: ast.Call) -> Tuple[List[Val], Dict[str, Val]]:
        pos = [self.eval(a) for a in node.args]
        kw = {k.arg: self.eval(k.value) for k in node.keywords
              if k.arg is not None}
        for k in node.keywords:
            if k.arg is None:
                self.eval(k.value)
        return pos, kw

    def _eval_call(self, node: ast.Call) -> Val:
        t = _dotted(node.func)
        pos, kw = self._arg_vals(node)
        inherit = Val.merge(pos + list(kw.values()))
        leaf = _leaf(t)

        draw = _is_global_draw(t, node)
        if draw is not None:
            self.facts.global_draws.append((node.lineno, draw))
        meth = node.func.attr if isinstance(node.func, ast.Attribute) \
            else leaf
        if meth in _SEED_FNS and self.loops:
            self._check_reseed(node, t or f".{meth}")

        # shape-bucket helpers: finitely many results (pow-2 policy)
        if leaf in _BUCKET_FNS:
            size = node.args[-1] if node.args else None
            nm = _dotted(size) if size is not None else None
            axis = f"{self.fi.qual}.{nm or leaf + '@' + str(node.lineno)}"
            return Val(frozenset({self._site(node.lineno, leaf)}),
                       frozenset({("bucket", axis)}))

        # counted entries: record the cache axes reaching them
        entry = self.an.index.resolve_entry(self.mod, t)
        if entry is not None:
            self._record_entry_call(node, entry, pos, kw)

        fi = self.an.index.resolve_func(
            self.mod, t, class_name=self.fi.class_name)
        self._check_launch(node, t, fi)
        if fi is not None:
            ret = self.an.returns.get((fi.mod.path, fi.qual), set())
            return Val(frozenset({self._site(node.lineno, leaf or "call")}),
                       frozenset(inherit.prov | ret) or CONST.prov)

        # unresolved call: method calls on rooted objects and the pure
        # tensor/builtin surface inherit argument provenance; anything
        # else with NO rooted inputs is opaque (statically unbounded)
        obj_val = CONST
        if isinstance(node.func, ast.Attribute):
            obj_val = self.eval(node.func.value)
        merged = Val.merge([inherit, obj_val])
        rooted = any(a[0] != "const" for a in merged.prov)
        pure = (t is not None and (t.startswith(_PURE_PREFIXES)
                                   or t in _PURE_BARE))
        if rooted or pure:
            return Val(frozenset({self._site(node.lineno, leaf or "call")}),
                       merged.prov or frozenset({("const",)}))
        return Val(frozenset({self._site(node.lineno, leaf or "call")}),
                   frozenset({("opaque",
                               f"{self.fi.qual}.{leaf or 'call'}"
                               f"@{node.lineno}")}))

    def _check_reseed(self, node: ast.Call, t: Optional[str]) -> None:
        """A seed with no name stored in the innermost loop re-seeds the
        same stream every iteration."""
        loop_id = self.loops[-1]
        stores = self.facts.loop_stores.get(loop_id, set())
        seed = node.args[0] if node.args else next(
            (k.value for k in node.keywords if k.arg == "seed"), None)
        names = {_target_name(n) for n in ast.walk(seed)
                 if isinstance(n, (ast.Name, ast.Attribute))} \
            if seed is not None else set()
        if not (names & stores):
            self.facts.reseeds.append((node.lineno, t or "manual_seed",
                                       loop_id))

    def _buffer(self, arg: ast.AST) -> Optional[ast.AST]:
        """The tensor expression whose device pointer ``arg`` hands to a
        launch: ``t`` itself, ``_ptr(t)`` / ``p(t)``, or
        ``c_void_p(t.data_ptr())``."""
        if isinstance(arg, ast.Call) and _dotted(arg.func) in _PTR_WRAPPERS \
                and len(arg.args) == 1:
            inner = arg.args[0]
            if isinstance(inner, ast.Call) and isinstance(
                    inner.func, ast.Attribute) \
                    and inner.func.attr == "data_ptr":
                return inner.func.value
            return inner
        if isinstance(arg, (ast.Name, ast.Attribute)):
            return arg
        return None

    def _launch_args(self, args: Sequence[ast.AST]) -> List[Optional[ast.AST]]:
        """Positional launch arguments, a ``*name`` of a local tuple
        display expanded."""
        out: List[Optional[ast.AST]] = []
        for a in args:
            if isinstance(a, ast.Starred):
                tup = self._local_tuple(a.value)
                if tup is None:
                    return out + [None] * 64      # slots past it unknown
                out.extend(tup)
            else:
                out.append(a)
        return out

    def _local_tuple(self, node: ast.AST) -> Optional[List[ast.AST]]:
        if isinstance(node, (ast.Tuple, ast.List)):
            return list(node.elts)
        if not isinstance(node, ast.Name):
            return None
        found = None
        for n in _walk_own(self.fi.node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and n.targets[0].id == node.id \
                    and isinstance(n.value, (ast.Tuple, ast.List)):
                found = list(n.value.elts)
        return found

    def _check_launch(self, node: ast.Call, t: Optional[str],
                      fi: Optional[FuncInfo]) -> None:
        """An output buffer of a launch that is also one of its inputs."""
        outs: Tuple[int, ...] = ()
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else _leaf(t)
        args: List[Optional[ast.AST]] = list(node.args)
        if fi is not None:
            for (suffix, fname), slots in INPLACE_CONSUMERS.items():
                if fi.qual == fname and fi.mod.path.endswith(suffix):
                    outs, name = slots, fname
        elif name in LAUNCH_OUTPUTS:
            outs = LAUNCH_OUTPUTS[name]
        if not outs and node.args \
                and _leaf(_dotted(node.args[0])) in LAUNCH_OUTPUTS:
            # _launch(lib.fn, *args): the launcher is the first argument
            name = _leaf(_dotted(node.args[0]))
            outs, args = LAUNCH_OUTPUTS[name], list(node.args[1:])
        if not outs:
            return
        flat = self._launch_args(args)
        bufs = [self._buffer(a) if a is not None else None for a in flat]
        vals = [self.eval(b) if b is not None else None for b in bufs]
        for o in outs:
            if o >= len(bufs) or bufs[o] is None:
                continue
            onm = _dotted(bufs[o])
            for i, b in enumerate(bufs):
                if i in outs or b is None:
                    continue
                same = onm is not None and onm == _dotted(b)
                # plain names bound to one definition (x2 = x)
                shared = isinstance(bufs[o], ast.Name) \
                    and isinstance(b, ast.Name) \
                    and bool(vals[o].defs & vals[i].defs)
                if same or shared:
                    self.facts.alias_events.append(AliasEvent(
                        var=onm, launch=name, line=node.lineno))
                    break

    def _axes_from_val(self, val: Val, static: bool) -> List[CacheAxis]:
        out = []
        for a in val.prov:
            if a[0] == "const":
                continue
            if a[0] == "finite":
                out.append(CacheAxis(a[1], "finite", a[2], static))
            elif a[0] == "param":
                out.append(CacheAxis(a[1], "param", None, static))
            elif a[0] == "bucket":
                out.append(CacheAxis(a[1], "bucket", None, static))
            elif a[0] == "opaque":
                out.append(CacheAxis(a[1], "unbounded", None, static))
        return out

    def _record_entry_call(self, node: ast.Call, entry: EntryDef,
                           pos: List[Val], kw: Dict[str, Val]) -> None:
        params = FuncInfo(entry.mod, entry.fn, entry.fn.name, None).params
        axes: Dict[str, CacheAxis] = {}
        for i, v in enumerate(pos):
            pname = params[i] if i < len(params) else f"arg{i}"
            static = pname in entry.static_names
            for ax in self._axes_from_val(v, static):
                prev = axes.get(ax.name)
                if prev is None or (ax.static and not prev.static):
                    axes[ax.name] = ax
        for name, v in kw.items():
            static = name in entry.static_names
            for ax in self._axes_from_val(v, static):
                prev = axes.get(ax.name)
                if prev is None or (ax.static and not prev.static):
                    axes[ax.name] = ax
        self.facts.entry_calls.append(EntryCall(
            entry=entry.name, path=self.mod.path, context=self.fi.qual,
            line=node.lineno, axes=tuple(sorted(axes.values(),
                                                key=lambda a: a.name))))

    # -- statements ---------------------------------------------------------

    def walk(self) -> FuncFacts:
        self._walk_body(self.fi.node.body)
        self.facts.loads = _loaded_names(self.fi.node)
        self._collect_dead_assigns()
        return self.facts

    def _walk_body(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            self._assign(targets, stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            val = self.eval(stmt.value)
            t = _target_name(stmt.target)
            if t and t in self.env:
                self._bind(t, Val.merge([self.env[t], val]))
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.Return):
            val = self.eval(stmt.value)
            self.facts.return_atoms |= {a for a in val.prov
                                        if a[0] in ("bucket", "finite")}
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            before = dict(self.env)
            self._walk_body(stmt.body)
            after_if = self.env
            self.env = dict(before)
            self._walk_body(stmt.orelse)
            self._merge_env(after_if)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._walk_loop(stmt)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            self._walk_loop(stmt, target=None, it=None)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                val = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, val)
            self._walk_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            before = dict(self.env)
            self._walk_body(stmt.body)
            for h in stmt.handlers:
                saved = self.env
                self.env = dict(before)
                self._walk_body(h.body)
                self._merge_env(saved)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass   # nested defs are analyzed as their own functions
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            if isinstance(stmt, ast.Assert):
                self.eval(stmt.test)
            elif stmt.exc is not None:
                self.eval(stmt.exc)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                t = _target_name(tgt)
                if t:
                    self.env.pop(t, None)

    def _merge_env(self, other: Dict[str, Val]) -> None:
        for name, val in other.items():
            if name in self.env:
                self.env[name] = Val.merge([self.env[name], val])
            else:
                self.env[name] = val

    def _walk_loop(self, stmt, target="sentinel", it="sentinel") -> None:
        if target == "sentinel":
            target, it = stmt.target, stmt.iter
        loop_id = stmt.lineno
        self.facts.loop_stores[loop_id] = \
            self.facts.loop_stores.get(loop_id, set()) | _stored_names(stmt)
        val = self.eval(it) if it is not None else CONST
        before = dict(self.env)
        self.loops = self.loops + (loop_id,)
        if target is not None:
            self._bind_target(target, Val(
                frozenset({self._site(stmt.lineno,
                                      _target_name(target) or "it")}),
                val.prov))
        self._walk_body(stmt.body)
        self.loops = self.loops[:-1]
        self._merge_env(before)
        self._walk_body(getattr(stmt, "orelse", []) or [])

    def _bind_target(self, target: ast.AST, val: Val) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind_target(
                    e, Val(frozenset({self._site(
                        getattr(e, "lineno", 0),
                        _target_name(e) or "unpack")}), val.prov))
            return
        t = _target_name(target)
        if t is not None:
            self._bind(t, val)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, val)

    def _assign(self, targets: List[ast.AST], value: Optional[ast.AST]
                ) -> None:
        if value is None:
            return
        val = self.eval(value)
        for tgt in targets:
            nm = _target_name(tgt)
            if nm is not None and isinstance(value, (ast.Name,
                                                     ast.Attribute)):
                # plain alias: SHARE def sites (x2 = x), so a launch that
                # writes one name and reads the other is caught
                self._bind(nm, val)
            else:
                self._bind_target(tgt, val)

    # -- dead device compute (CFN109 substrate) -----------------------------

    def _collect_dead_assigns(self) -> None:
        loads = self.facts.loads
        for n in ast.walk(self.fi.node):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)):
                continue
            name = n.targets[0].id
            if name.startswith("_") or name in loads:
                continue
            t = _dotted(n.value.func)
            if _is_device_call(t, n.value):
                self.facts.dead_assigns.append((n.lineno, name, t))


# ---------------------------------------------------------------------------
# the analyzer: summaries to fixpoint, facts for every function
# ---------------------------------------------------------------------------

class Analysis:
    """What one project-wide dataflow run produces (shared by all four
    CFN106-CFN109 rules through ``Project.cache``)."""

    def __init__(self, index: ProjectIndex,
                 functions: Dict[Tuple[str, str], FuncFacts]):
        self.index = index
        self.functions = functions

    @property
    def entry_calls(self) -> List[EntryCall]:
        return [c for f in self.functions.values() for c in f.entry_calls]


class Analyzer:
    MAX_PASSES = 5

    def __init__(self, project: Project):
        self.project = project
        self.index = project_index(project)
        self.returns: Dict[Tuple[str, str], Set[Atom]] = {}

    def run(self) -> Analysis:
        functions: Dict[Tuple[str, str], FuncFacts] = {}
        for _ in range(self.MAX_PASSES):
            functions = {}
            changed = False
            for key, fi in self.index.funcs.items():
                facts = FlowWalker(self, fi).walk()
                functions[key] = facts
                if facts.return_atoms != self.returns.get(key, set()):
                    self.returns[key] = set(facts.return_atoms)
                    changed = True
            if not changed:
                break
        return Analysis(self.index, functions)


def analyze_dataflow(project: Project) -> Analysis:
    """Project-cached dataflow run (one per ``analyze_project`` call)."""
    return project.cache("dataflow", lambda: Analyzer(project).run())
