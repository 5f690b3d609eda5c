"""The port's tracelint (repro_torch.analysis): engine parity with the JAX
package's, the syntactic rules CFN101-CFN105 in torch terms, the
shared-memory mirrors they evaluate, and the CLI gate.

Pure AST: no device work.  Each rule gets fixture sources with a known
violation (rule id and line asserted) and a clean twin that must produce
nothing.  The engine's fingerprints, baselines, pragmas and CLI are held
byte for byte to ``repro.analysis`` on the same numpy-only sources.
"""
import ast
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref
from repro.analysis import engine as ref_engine
from repro_torch.analysis import (MAX_SCALE, SMEM_PER_BLOCK_BYTES, Finding,
                                  analyze_paths, analyze_source,
                                  apply_baseline, baseline_payload)
from repro_torch.analysis import engine
from repro_torch.analysis.rules import SmemEvaluator
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import placement_power as tpp

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"


def findings_for(src, path="<string>"):
    return analyze_source(textwrap.dedent(src), path=path)


def rules_of(findings):
    return [(f.rule, f.line) for f in findings]


def hits(findings, rule):
    return [f for f in findings if f.rule == rule]


_F64 = """\
    import numpy as np

    def loads(F):
        return np.zeros(4, np.float64)
"""


# ---------------------------------------------------------------------------
# engine parity with repro.analysis
# ---------------------------------------------------------------------------

def test_baseline_payload_and_fingerprints_equal_the_reference():
    kw = dict(rule="CFN102", severity="error", path="src/a.py", line=7,
              message="float64 reference `np.float64` outside the f64 "
                      "oracle whitelist", context="loads")
    mine = [Finding(**kw), Finding(**{**kw, "line": 9, "context": ""})]
    theirs = [ref.Finding(**kw), ref.Finding(**{**kw, "line": 9,
                                                "context": ""})]
    assert [f.key for f in mine] == [f.key for f in theirs]
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in theirs]
    assert [f.render() for f in mine] == [f.render() for f in theirs]
    assert json.dumps(baseline_payload(mine), indent=2, sort_keys=True) \
        == json.dumps(ref.baseline_payload(theirs), indent=2,
                      sort_keys=True)


def test_findings_and_keys_equal_the_reference_and_survive_a_line_shift():
    path = "src/pkg/core/newmod.py"
    src = textwrap.dedent(_F64)
    mine = analyze_source(src, path=path)
    theirs = ref.analyze_source(src, path=path)
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in theirs]
    assert rules_of(mine) == [("CFN102", 4)]
    shifted = analyze_source("\n\n" + src, path=path)
    assert shifted[0].line == 6 and shifted[0].key == mine[0].key
    assert apply_baseline(shifted, {f.key for f in mine}) == []


def test_fingerprint_survives_a_move_across_files_as_the_reference_does(
        tmp_path):
    body = textwrap.dedent(_F64)
    for pkg in (engine, ref_engine):
        root = tmp_path / pkg.__name__.split(".")[0]
        root.mkdir()
        (root / "alpha.py").write_text(body)
        (root / "beta.py").write_text("import numpy as np\n")
        first = pkg.analyze_paths([str(root)])
        keys = {f.key for f in first}
        (root / "alpha.py").write_text("import numpy as np\n")
        (root / "beta.py").write_text("import numpy as np\n\n\n"
                                      + body[len("import numpy as np\n"):])
        moved = pkg.analyze_paths([str(root)])
        assert moved and moved[0].path.endswith("beta.py")
        assert pkg.apply_baseline(moved, keys) == []


def test_pragma_suppression_equals_the_reference():
    src = """\
        import numpy as np

        def loads(F):
            x = np.zeros(4, np.float64)  # tracelint: allow[CFN102]
            # deliberate host accounting  # tracelint: allow[CFN102]
            y = np.zeros(4, np.float64)
            return x + y
    """
    for pkg in (ref, sys.modules["repro_torch.analysis"]):
        fs = pkg.analyze_source(textwrap.dedent(src),
                                path="src/pkg/core/newmod.py")
        assert not hits(fs, "CFN102")
        wrong = pkg.analyze_source(
            textwrap.dedent(src.replace("allow[CFN102]", "allow[CFN101]")),
            path="src/pkg/core/newmod.py")
        assert [f.line for f in hits(wrong, "CFN102")] == [4, 6]


def test_module_name_anchors_at_repro_torch():
    assert engine.module_name("tools/repro_torch/core/solvers.py") \
        == "repro_torch.core.solvers"
    assert engine.module_name("src/repro_torch/kernels/__init__.py") \
        == "repro_torch.kernels"
    assert engine.module_name("a/repro/core/solvers.py") \
        == ref_engine.module_name("a/repro/core/solvers.py")
    assert ref_engine.module_name("tools/repro_torch/core/solvers.py") \
        == "solvers"


def _run_cli(pkg, args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", pkg, *args],
        cwd=str(cwd), capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_exit_codes_and_json_equal_the_reference(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(_F64))
    good = tmp_path / "good.py"
    good.write_text("import numpy as np\n\n\ndef f(x):\n    return x\n")
    outs = {}
    for pkg in ("repro.analysis", "repro_torch.analysis"):
        r = _run_cli(pkg, ["--format", "json", str(bad)])
        assert r.returncode == 1, r.stderr
        outs[pkg] = r.stdout
        assert _run_cli(pkg, [str(good)]).returncode == 0
        bl = tmp_path / f"{pkg}.json"
        w = _run_cli(pkg, ["--write-baseline", str(bl), str(bad)])
        assert w.returncode == 0
        assert _run_cli(pkg, ["--baseline", str(bl), str(bad)]).returncode \
            == 0
    assert outs["repro.analysis"] == outs["repro_torch.analysis"]
    assert json.loads(outs["repro_torch.analysis"])["findings"][0]["rule"] \
        == "CFN102"
    assert (tmp_path / "repro.analysis.json").read_bytes() \
        == (tmp_path / "repro_torch.analysis.json").read_bytes()


# ---------------------------------------------------------------------------
# CFN101: host syncs inside captured or compiled regions
# ---------------------------------------------------------------------------

def test_cfn101_item_inside_graph_capture():
    fs = findings_for("""\
        import torch

        def step(x, g):
            with torch.cuda.graph(g):
                y = x * 2
                n = y.sum().item()
            return n
    """)
    assert ("CFN101", 6) in rules_of(fs)


def test_cfn101_float_cast_reachable_through_a_helper():
    fs = findings_for("""\
        import torch

        def helper(x):
            return float(x.sum()) + 1.0

        def body(x):
            return helper(x)

        def capture(x, g):
            with torch.cuda.graph(g):
                body(x)
    """)
    assert ("CFN101", 4) in rules_of(fs)


def test_cfn101_follows_callables_passed_to_the_capturing_function():
    # the captured body is a parameter, as in chip_smoke's graph_ms
    fs = findings_for("""\
        import torch

        def graph_ms(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()

        def work(x):
            return x.tolist()

        def timed(launch):
            return graph_ms(launch)

        def run(x):
            graph_ms(lambda: x.cpu())
            calls = {k: (lambda k=k: x.numpy()) for k in "ab"}
            timed(calls["a"])
            graph_ms(work)
    """)
    got = rules_of(hits(fs, "CFN101"))
    assert ("CFN101", 9) in got and ("CFN101", 15) in got \
        and ("CFN101", 16) in got


def test_cfn101_compiled_function_and_data_dependent_shapes():
    fs = findings_for("""\
        import torch

        @torch.compile
        def step(x):
            idx = torch.nonzero(x)
            fixed = torch.nonzero_static(x, size=4)
            return idx, fixed

        def other(x):
            return torch.nonzero(x)

        compiled = torch.compile(other)
    """)
    assert rules_of(hits(fs, "CFN101")) == [("CFN101", 5), ("CFN101", 10)]


def test_cfn101_capture_begin_end_region_and_boolean_masks():
    fs = findings_for("""\
        import torch

        def step(x, g):
            g.capture_begin()
            y = x[x > 0]
            keep = x != 0
            z = x[keep]
            g.capture_end()
            w = x[x > 0]
            return y, z, w
    """)
    assert rules_of(hits(fs, "CFN101")) == [("CFN101", 5), ("CFN101", 7)]


def test_cfn101_make_graphed_callables_and_cross_module(tmp_path):
    (tmp_path / "kern.py").write_text(textwrap.dedent("""\
        import torch

        def launch(x):
            return int(x.sum())
    """))
    (tmp_path / "run.py").write_text(textwrap.dedent("""\
        import torch
        from kern import launch

        def step(x):
            return launch(x) + x.numpy()

        graphed = torch.cuda.make_graphed_callables((step,), (None,))
    """))
    fs = hits(analyze_paths([str(tmp_path)]), "CFN101")
    got = {(Path(f.path).name, f.line) for f in fs}
    assert got == {("kern.py", 4), ("run.py", 5)}


def test_cfn101_clean_static_casts_and_host_code():
    fs = findings_for("""\
        import torch

        def launch(x, cap: float = 0.0, causal: bool = True, *,
                   window=None):
            n = int(x.shape[0]) + int(x.numel()) + len(x)
            return x * float(cap) / n, int(causal), float(2.0)

        def capture(x, g):
            with torch.cuda.graph(g):
                launch(x)

        def host_report(res):
            return float(res.sum()), res.cpu().numpy(), res.item()
    """)
    assert not hits(fs, "CFN101")


# ---------------------------------------------------------------------------
# CFN102: dtype discipline
# ---------------------------------------------------------------------------

_NUMPY_DTYPE_SOURCES = [
    ("src/pkg/core/newmod.py", _F64),
    ("src/pkg/kernels/ref.py", """\
        import numpy as np

        def eq_terms_f64(omega):
            return np.asarray(omega, np.float64)
    """),
    ("src/pkg/core/newmod.py", """\
        import numpy as np

        def loads(F):
            return np.asarray(F, dtype=float)
    """),
    ("src/pkg/core/newmod.py", """\
        import numpy as np

        def loads(F):
            a = np.zeros(3, dtype="float64")
            return F.astype(float) + np.ones(2, "f64") + a
    """),
]


@pytest.mark.parametrize("path,src", _NUMPY_DTYPE_SOURCES)
def test_cfn102_numpy_sources_give_the_reference_findings(path, src):
    mine = hits(findings_for(src, path), "CFN102")
    theirs = hits(ref.analyze_source(textwrap.dedent(src), path=path),
                  "CFN102")
    assert [(f.line, f.severity) for f in mine] \
        == [(f.line, f.severity) for f in theirs]
    assert [f.message for f in mine if f.severity == "error"] \
        == [f.message for f in theirs if f.severity == "error"]


def test_cfn102_torch_float64_forms():
    fs = findings_for("""\
        import torch

        def loads(F):
            a = F.to(torch.float64)
            b = F.double()
            c = torch.zeros(3, dtype=torch.double)
            d = torch.ones(3, dtype=float)
            e = F.to(float)
            return a, b, c, d, e
    """, path="src/repro_torch/core/newmod.py")
    got = hits(fs, "CFN102")
    assert [f.line for f in got] == [4, 5, 6, 7, 8]
    assert all(f.severity == "error" for f in got)


def test_cfn102_whitelisted_oracle_path_clean():
    fs = findings_for("""\
        import torch

        def oracle(x):
            return x.double() + torch.zeros(3, dtype=torch.float64)
    """, path="src/repro_torch/kernels/ref.py")
    assert not hits(fs, "CFN102")


# ---------------------------------------------------------------------------
# CFN103: pytree hygiene
# ---------------------------------------------------------------------------

_PYTREE_BAD = """\
    import dataclasses
    from torch.utils import _pytree

    @dataclasses.dataclass(frozen=True)
    class Health:
        node_up: object
        link_up: object
        epoch: int

    def _flatten(h):
        return [h.node_up, h.link_up], None

    def _unflatten(children, ctx):
        return Health(*children, epoch=0)

    _pytree.register_pytree_node(Health, _flatten, _unflatten)
"""


def test_cfn103_unaccounted_field():
    got = hits(findings_for(_PYTREE_BAD), "CFN103")
    assert got and got[0].line == 10 and "epoch" in got[0].message


def test_cfn103_all_fields_accounted_clean():
    for fix in ("return [h.node_up, h.link_up], h.epoch",
                "return [getattr(h, f.name) for f in "
                "dataclasses.fields(h)], None"):
        fs = findings_for(_PYTREE_BAD.replace(
            "return [h.node_up, h.link_up], None", fix))
        assert not hits(fs, "CFN103")


def test_cfn103_degrade_must_not_change_shape():
    fs = findings_for("""\
        import torch

        def degrade(self, nodes):
            up = torch.cat([self.node_up, nodes])
            return up.reshape(nodes.shape[0], -1)
    """)
    assert rules_of(hits(fs, "CFN103")) == [("CFN103", 4), ("CFN103", 5)]


def test_cfn103_value_only_degrade_clean():
    fs = findings_for("""\
        import dataclasses
        import torch

        def degrade(self, problem):
            nu = torch.as_tensor(self.node_up, device=problem.device)
            return dataclasses.replace(problem,
                                       NS=torch.where(nu, problem.NS, 0.0))
    """)
    assert not hits(fs, "CFN103")


# ---------------------------------------------------------------------------
# CFN104: trace-counter coverage
# ---------------------------------------------------------------------------

def test_cfn104_uncounted_or_misnamed_entry_in_solvers():
    fs = findings_for("""\
        def count_traces(name):
            return lambda f: f

        def _sweep(problem, state):
            return state

        @count_traces("sweeps")
        def _anneal_scan_delta(problem, state):
            return state
    """, path="src/repro_torch/core/solvers.py")
    got = hits(fs, "CFN104")
    assert [f.line for f in got] == [4, 8]
    assert "`sweeps`" in got[1].message and "anneal_delta" in got[1].message


def test_cfn104_counted_entries_clean_and_not_enforced_elsewhere():
    counted = """\
        from . import solvers

        @solvers.count_traces("solve_regions")
        def _solve_regions(problems, auxes):
            return problems
    """
    assert not hits(findings_for(counted,
                                 path="src/repro_torch/core/federation.py"),
                    "CFN104")
    fs = findings_for("""\
        def _sweep(problem, state):
            return state
    """, path="src/repro_torch/core/power.py")
    assert not hits(fs, "CFN104")


def test_cfn104_counter_above_compile_is_flagged():
    fs = findings_for("""\
        import torch
        from .solvers import count_traces

        @count_traces("sweep")
        @torch.compile
        def _sweep(problem, state):
            return state

        @torch.compile
        def _other(x):
            return x
    """, path="src/repro_torch/core/solvers.py")
    got = hits(fs, "CFN104")
    assert [f.line for f in got] == [6, 10]
    assert "UNDER" in got[0].message


# ---------------------------------------------------------------------------
# CFN105: shared memory
# ---------------------------------------------------------------------------

def test_cfn105_mirror_over_the_block_limit():
    fs = findings_for("""\
        ROWS = 128

        def _tile(D):
            return ROWS * D * 4

        def big_launch_smem(D, Skv):
            return 2 * _tile(D) + Skv * 8
    """)
    got = hits(fs, "CFN105")
    assert got and got[0].line == 6 and got[0].severity == "error"
    assert f"D={MAX_SCALE['D']}" in got[0].message


def test_cfn105_mirror_that_fits_and_module_limit():
    src = """\
        SMEM_PER_BLOCK = 500

        def small_launch_smem(P, N):
            up = lambda b: (b + 15) // 16 * 16
            total = 0
            for part in (P, N):
                total += up(part)
            return total
    """
    fs = findings_for(src)
    got = hits(fs, "CFN105")
    assert got and "608 bytes" in got[0].message \
        and "over the block's 500" in got[0].message
    assert not hits(findings_for(src.replace("500", "232448")), "CFN105")


def test_cfn105_mirror_not_evaluable_is_a_warning():
    fs = findings_for("""\
        import math

        def odd_launch_smem(D, blocks):
            return math.prod([D, blocks])
    """)
    got = hits(fs, "CFN105")
    assert got and got[0].severity == "warning"


def test_cfn105_triton_loop_over_a_runtime_bound():
    fs = findings_for("""\
        import triton
        import triton.language as tl

        @triton.jit
        def kern(x_ptr, n, BLOCK: tl.constexpr):
            for i in range(n):
                tl.store(x_ptr + i, 0.0)
            for j in tl.static_range(BLOCK * 2):
                tl.store(x_ptr + j, 1.0)
    """)
    assert rules_of(hits(fs, "CFN105")) == [("CFN105", 6)]


# the launch shapes of chip_smoke's phases 1, 4 and 5-5f, and MAX_SCALE
_PLACEMENT_SHAPES = [(468, 126), (38, 33), (MAX_SCALE["P"], MAX_SCALE["N"])]
_ANNEAL_SHAPES = [  # C, J, P, N, D, K
    (1, 3072, 468, 126, 2, 14), (33, 3072, 468, 126, 2, 14),
    (141, 3072, 468, 126, 2, 14), (32, 3072, 468, 126, 5, 14),
    (32, 27000, 468, 126, 2, 14), (5, 26267, 468, 126, 2, 14),
    (5, 26268, 468, 126, 2, 14), (4, 30, 38, 33, 33, 14),
    tuple(MAX_SCALE[k] for k in ("C", "J", "P", "N", "deg", "K"))]
_SIMT_SHAPES = [(32, 32), (64, 64), (16, 16), (24, 24), (128, 128),
                (192, 128), (120, 120), (MAX_SCALE["D"], MAX_SCALE["Dv"])]
_SPLIT_SHAPES = [  # D, Dv, esz, rows, cps
    (128, 128, 2, 4, 2), (128, 128, 4, 4, 2), (64, 64, 2, 5, 1),
    (64, 64, 2, 1, 1), (120, 120, 2, 4, 2), (128, 128, 2, 2, 3),
    (256, 256, 4, 16, 16),
    tuple(MAX_SCALE[k] for k in ("D", "Dv", "esz", "rows", "cps"))]
_WGMMA_SHAPES = [  # D, Dv, Skv
    (128, 128, 1064), (192, 128, 1064), (64, 64, 1024), (64, 64, 1500),
    (120, 120, 4096), (32, 32, 32), (128, 128, 4168),
    (MAX_SCALE["D"], MAX_SCALE["Dv"], MAX_SCALE["Skv"])]


def _c_placement(P, N):
    # csrc/placement_power.cu: smem_bytes, kWarps = 8
    return (8 * 2 * P + 2 * 8 * (N + 1) + 2 * P + N + 1) * 4


def _c_anneal(C, J, P, N, D, K):
    # fused_anneal_variant, then param_bytes + cpb * chain_bytes
    if D > 32 or 2 * D * K > 1024:
        return 0
    up = lambda b: (b + 15) & ~15
    words = (2 * D + 31) // 32
    par = up(4 * (8 * P + 4 * (N + 1)))
    for gx in (False, True):
        ch = up(4 * ((N + 1) * words + (0 if gx else 2 * J) + 2 * P
                     + (N + 1) + 4 * D + 128))
        fit = min(32, (232448 - par) // ch)
        if fit > 0:
            return par + min(fit, max(1, -(-C // 132))) * ch
    return 0


def _c_simt(D, Dv):
    # csrc/flash_attention.cu: smem_bytes
    Dp, Dvp = (D + 3) & ~3, (Dv + 3) & ~3
    QS = Dp + 4 if Dp % 8 == 0 else Dp
    return (64 * QS + 64 * QS + 64 * Dvp + 64 * 65 + 2 * 64) * 4 \
        + (64 + 64) * 4


def _c_split(D, Dv, esz, rows, cps):
    # csrc/flash_attention_decode.cu: smem_bytes, nbuf_for
    units = (D * esz + 15) // 16
    ks = 16 * (units if units % 2 else units + 1)
    RP, parts = (rows + 3) & ~3, 128 // (Dv // 2)
    rest = 4 * (rows * D + rows * 64 + 64 * RP + parts * RP * Dv + 3 * RP) \
        + 4 * (cps * 64 + rows + cps + 1)
    two = 2 * 64 * (ks + Dv * esz) + rest
    return two if two <= 232448 else 64 * (ks + Dv * esz) + rest


def _c_wgmma(D, Dv, Skv):
    # csrc/flash_attention_wgmma.cu: smem_bytes(NCH, NCV, n_tiles)
    nch, ncv, tiles = -(-D // 64), -(-Dv // 64), -(-Skv // 64)
    return 1024 + nch * 16384 + 3 * (nch + ncv) * 8192 + 8 * 7 \
        + 4 * (4 + 2 * tiles)


_MIRRORS = (
    [(tpp, "placement_power_launch_smem", s, _c_placement)
     for s in _PLACEMENT_SHAPES]
    + [(tpp, "fused_anneal_launch_smem", s, _c_anneal)
       for s in _ANNEAL_SHAPES]
    + [(tfa, "simt_launch_smem", s, _c_simt) for s in _SIMT_SHAPES]
    + [(tfa, "split_kv_launch_smem", s, _c_split) for s in _SPLIT_SHAPES]
    + [(tfa, "wgmma_launch_smem", s, _c_wgmma) for s in _WGMMA_SHAPES])


@pytest.mark.parametrize("mod,name,shape,c_formula", _MIRRORS,
                         ids=[f"{m[1]}-{'x'.join(map(str, m[2]))}"
                              for m in _MIRRORS])
def test_smem_mirror_matches_the_cuda_formula_and_fits(mod, name, shape,
                                                       c_formula):
    fn = getattr(mod, name)
    got = fn(*shape)
    assert got == fn(*shape) == c_formula(*shape)
    assert isinstance(got, int) and 0 <= got <= SMEM_PER_BLOCK_BYTES
    # the linter's evaluator computes the same from the source alone
    path = Path(mod.__file__)
    ev = SmemEvaluator(engine.Module(path.read_text(), path=str(path)))
    node = ev.funcs[name]
    assert ev.call(node, shape, {}) == got


def test_smem_mirrors_guard_the_variant_switches():
    # the fused anneal's shared variant ends at J = 26267 at city_p468;
    # the split-KV launcher keeps one K/V buffer where two do not fit
    assert tpp.fused_anneal_variant(5, 26267, 468, 126, 2, 14)[0] == \
        "shared"
    assert tpp.fused_anneal_variant(5, 26268, 468, 126, 2, 14)[0] == \
        "global"
    assert tfa.split_kv_smem_bytes(256, 256, 4, 16, 16, 2) \
        > tfa.SMEM_PER_BLOCK >= tfa.split_kv_launch_smem(256, 256, 4, 16,
                                                         16)
    assert tfa.SMEM_PER_BLOCK == tpp.SMEM_PER_BLOCK == SMEM_PER_BLOCK_BYTES


def _exports(text):
    """extern "C" functions of a .cu source: name -> parameter list."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        out[m.group(1)] = [p.strip() for p in m.group(2).split(",")
                           if p.strip()]
    return out


def test_queries_and_launch_outputs_match_the_cuda_sources():
    from repro_torch.analysis.dataflow import LAUNCH_OUTPUTS
    from repro_torch.kernels import _build
    for name, queries in _build.QUERIES.items():
        ex = _exports((CSRC / f"{name}.cu").read_text())
        launcher, n_ptr, n_int, n_float = _build.LAUNCHERS[name]
        params = ex[launcher]
        assert len(params) == n_ptr + n_int + n_float + 1
        # outputs: the non-const pointers before the stream
        outs = tuple(i for i, p in enumerate(params[:-1])
                     if "*" in p and not p.startswith("const"))
        assert LAUNCH_OUTPUTS[launcher] == outs, launcher
        for q_name, n_in, n_out in queries:
            qp = ex[q_name]
            assert len(qp) == n_in + n_out
            assert all(p.startswith("int ") and "*" not in p
                       for p in qp[:n_in])
            assert all(p.startswith("int*") for p in qp[n_in:])


def test_cfn105_shipped_mirrors_evaluate_at_max_scale():
    for mod in (tpp, tfa):
        path = Path(mod.__file__)
        fs = analyze_source(path.read_text(), path=str(path))
        assert not hits(fs, "CFN105")
        tree = ast.parse(path.read_text())
        assert [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name.endswith("_launch_smem")]


# ---------------------------------------------------------------------------
# the CLI gate and the package's own discipline
# ---------------------------------------------------------------------------

def test_cli_shipped_port_is_clean_with_its_baseline():
    r = _run_cli("repro_torch.analysis",
                 ["--baseline", "analysis/baseline-torch.json",
                  "src/repro_torch", "chip_smoke.py"])
    assert r.returncode == 0, r.stdout + r.stderr


_SEEDED = {
    "CFN101": "import torch\n\ndef f(x, g):\n    with torch.cuda.graph(g):"
              "\n        return x.item()\n",
    "CFN102": "import torch\n\ndef f(x):\n    return x.double()\n",
    "CFN103": "import torch\n\ndef degrade(self, x):\n"
              "    return torch.cat([x, x])\n",
    "CFN104": "def _sweep(problem, state):\n    return state\n",
    "CFN105": "def big_launch_smem(Skv):\n    return Skv * 64\n",
    "CFN106": "import torch\n\ndef f():\n    return torch.rand(3)\n",
    "CFN107": "def f(lib, _ptr, x):\n    return lib.flash_attention_launch("
              "_ptr(x), _ptr(x), _ptr(x), 0, 0, _ptr(x))\n",
    "CFN108": "import time\n\ndef count_traces(n):\n    return lambda f: f\n"
              "\n@count_traces('kern')\ndef kern(x):\n    return x\n\n"
              "def run():\n    return kern(time.time())\n",
    "CFN109": "import torch\n\ndef f(x):\n    y = torch.sum(x)\n"
              "    return x\n",
}


@pytest.mark.parametrize("rule", sorted(_SEEDED))
def test_cli_seeded_violation_fails_with_its_id(tmp_path, rule):
    d = tmp_path / "src" / "repro_torch" / "core"
    d.mkdir(parents=True)
    bad = d / "solvers.py"
    bad.write_text(_SEEDED[rule])
    r = _run_cli("repro_torch.analysis", ["--format", "json", str(bad)])
    assert r.returncode == 1, r.stdout + r.stderr
    rules = {f["rule"] for f in json.loads(r.stdout)["findings"]}
    assert rule in rules


def test_package_imports_only_the_standard_library_and_no_jax():
    pkg = REPO / "src" / "repro_torch" / "analysis"
    for f in pkg.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top in sys.stdlib_module_names, (f.name, m)
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__;"
            " print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'torch', 'numpy')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_linter_passes_the_new_package():
    fs = ref.analyze_paths([str(REPO / "src" / "repro_torch" / "analysis")])
    assert fs == [], [f.render() for f in fs]
