"""tracelint engine of the port: findings, pragma/baseline suppression,
runners.

Rules are stateless objects with an ``id``/``severity`` and a
``check(module) -> findings`` method; the engine owns everything rules
share -- parsing, the per-line ``# tracelint: allow[...]`` pragma map,
line-independent baseline fingerprints, and path walking.  Keeping
suppression out of the rules means a rule only ever reports what it
sees; policy (accept / pragma / baseline) lives with the code owner.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

# matches "# tracelint: allow[CFN101]" and "# tracelint: allow[CFN101,CFN102]"
_PRAGMA_RE = re.compile(r"#\s*tracelint:\s*allow\[([A-Za-z0-9,\s]+)\]")

BASELINE_VERSION = 2


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str         # "CFN101"
    severity: str     # "error" | "warning"
    path: str         # normalized with forward slashes
    line: int         # 1-based
    message: str
    context: str = ""  # enclosing function qualname ("" at module level)

    @property
    def key(self) -> str:
        """Line- and file-independent fingerprint: a baseline entry keeps
        matching after unrelated edits shift the finding up or down the
        file, and after the enclosing function is MOVED across files (the
        fingerprint anchors on the function's qualname, not the path;
        module-level findings fall back to the path)."""
        return f"{self.rule}::{self.context or self.path}::{self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "message": self.message, "context": self.context,
                "key": self.key}

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")


def _pragma_lines(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {t.strip() for t in m.group(1).split(",") if t.strip()}
    return out


class Module:
    """One parsed source file, handed to every rule."""

    def __init__(self, source: str, path: str = "<string>"):
        self.source = source
        self.path = str(path).replace("\\", "/")
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        self.pragmas = _pragma_lines(self.lines)
        # (start, end, qualname) spans of every def, innermost last
        self._spans: List[tuple] = []
        self._index_spans(self.tree, ())

    def _index_spans(self, node: ast.AST, stack: tuple) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                sub = stack + (child.name,)
                if not isinstance(child, ast.ClassDef):
                    self._spans.append((child.lineno,
                                        child.end_lineno or child.lineno,
                                        ".".join(sub)))
                self._index_spans(child, sub)
            else:
                self._index_spans(child, stack)

    def context_at(self, line: int) -> str:
        """Qualname of the innermost function def enclosing ``line``
        ("" for module-level code) -- the move-stable fingerprint anchor."""
        best = ""
        best_span = None
        for start, end, qual in self._spans:
            if start <= line <= end:
                if best_span is None or (end - start) <= best_span:
                    best, best_span = qual, end - start
        return best

    def allowed(self, rule_id: str, line: int) -> bool:
        """A pragma suppresses findings on its own line and, when it sits
        on a standalone comment line, on the line below it."""
        for ln in (line, line - 1):
            if rule_id in self.pragmas.get(ln, ()):
                return True
        return False


class Project:
    """Every parsed module of one analysis run: the cross-file context
    ``ProjectRule``s (the flow-sensitive CFN106-CFN109 families) resolve
    imports and build their call graph over.  Single-source runs
    (``analyze_source``) are one-module projects."""

    def __init__(self, modules: Sequence["Module"]):
        self.modules = list(modules)
        self.by_path: Dict[str, Module] = {m.path: m for m in self.modules}
        self.by_name: Dict[str, Module] = {}
        for m in self.modules:
            name = module_name(m.path)
            if name:
                self.by_name[name] = m
        self._caches: Dict[str, object] = {}   # dataflow index memo

    def cache(self, key: str, build):
        if key not in self._caches:
            self._caches[key] = build()
        return self._caches[key]


def module_name(path: str) -> Optional[str]:
    """Dotted import name for a source path:
    ``src/repro_torch/core/solvers.py`` -> ``repro_torch.core.solvers``
    (anchored at the ``src`` dir, else at the ``repro_torch`` or ``repro``
    package dir seen in the path); None when not derivable."""
    p = str(path).replace("\\", "/")
    if not p.endswith(".py"):
        return None
    parts = p[:-3].split("/")
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    elif "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    elif "repro" in parts:
        parts = parts[parts.index("repro"):]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(x for x in parts if x) or None


class Rule:
    """Base rule: subclasses set ``id``/``severity``/``title`` and yield
    findings from ``check``."""

    id = "CFN000"
    severity = "error"
    title = ""

    def check(self, mod: Module) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, mod: Module, node, message: str,
                severity: Optional[str] = None) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 0)
        return Finding(rule=self.id, severity=severity or self.severity,
                       path=mod.path, line=line, message=message,
                       context=mod.context_at(line))


class ProjectRule(Rule):
    """A rule that sees the WHOLE parsed project at once (imports, call
    graph, cross-module dataflow).  ``check_project`` replaces ``check``;
    findings land on whichever module/line they belong to and the engine
    applies that module's pragmas."""

    def check(self, mod: Module) -> Iterable[Finding]:   # pragma: no cover
        return self.check_project(Project([mod]))

    def check_project(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


def _default_rules() -> List[Rule]:
    from . import rules
    return rules.all_rules()


def analyze_project(project: Project,
                    rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run the rule catalog over a parsed project.  Pragma-suppressed
    findings are dropped here; baseline suppression is the caller's
    (``apply_baseline``)."""
    out: List[Finding] = []
    for rule in (rules if rules is not None else _default_rules()):
        if isinstance(rule, ProjectRule):
            found = list(rule.check_project(project))
        else:
            found = [f for m in project.modules for f in rule.check(m)]
        for f in found:
            mod = project.by_path.get(f.path)
            if mod is None or not mod.allowed(f.rule, f.line):
                out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run the rule catalog over one source string (a one-module project)."""
    return analyze_project(Project([Module(source, path=path)]), rules=rules)


def iter_python_files(paths: Sequence[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def load_project(paths: Sequence[str]) -> tuple:
    """Parse every file under ``paths`` into a Project; returns
    ``(project, syntax_error_findings)``."""
    mods: List[Module] = []
    errors: List[Finding] = []
    for f in iter_python_files(paths):
        try:
            mods.append(Module(f.read_text(), path=str(f)))
        except SyntaxError as e:
            errors.append(Finding(
                rule="E999", severity="error",
                path=str(f).replace("\\", "/"), line=e.lineno or 0,
                message=f"syntax error: {e.msg}"))
    return Project(mods), errors


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Sequence[Rule]] = None,
                  only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze every python file under ``paths``.  ``only`` (optional)
    restricts the REPORTED findings to the given files while the whole
    path set still feeds the cross-module context (the ``--changed``
    mode: lint a handful of touched files against the full call graph).
    """
    project, findings = load_project(paths)
    findings = list(findings)
    findings.extend(analyze_project(project, rules=rules))
    if only is not None:
        keep = {str(p).replace("\\", "/") for p in only}
        findings = [f for f in findings if f.path in keep]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# -- baseline ---------------------------------------------------------------

def baseline_payload(findings: Sequence[Finding]) -> dict:
    return {"version": BASELINE_VERSION,
            "suppressions": sorted({f.key for f in findings})}


def load_baseline(path: str) -> Set[str]:
    data = json.loads(Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r}")
    return set(data.get("suppressions", ()))


def apply_baseline(findings: Sequence[Finding], baseline: Set[str]
                   ) -> List[Finding]:
    """Findings NOT covered by the baseline (the ones that fail CI)."""
    return [f for f in findings if f.key not in baseline]
