"""The port's flow-sensitive tracelint rules (CFN106-CFN109) and their
dataflow engine (repro_torch.analysis.dataflow).

Pure AST, no device work: each rule family gets violation fixtures with
the rule id and line asserted and clean twins that must produce nothing
-- including the idioms the engine must NOT flag (a draw from a passed
generator, a seed that changes every iteration, distinct launch buffers,
bucketed shapes).  Also covers pragma suppression of the flow ids and
the move-stability contract of a baseline fingerprint.
"""
import json
import textwrap
from pathlib import Path

from repro_torch.analysis import (CACHE_CAPS, analyze_paths, analyze_source,
                                  apply_baseline, baseline_payload,
                                  compute_cache_bounds)
from repro_torch.analysis.engine import Module, Project

REPO = Path(__file__).resolve().parents[1]


def findings_for(src, path="<string>"):
    return analyze_source(textwrap.dedent(src), path=path)


def hits(findings, rule):
    return [f for f in findings if f.rule == rule]


def lines(findings, rule):
    return [f.line for f in hits(findings, rule)]


# ---------------------------------------------------------------------------
# CFN106: random-stream discipline
# ---------------------------------------------------------------------------

def test_cfn106_draws_on_the_global_stream():
    fs = findings_for("""\
        import torch

        def init(w, shape):
            a = torch.rand(shape)
            b = torch.randn(shape, generator=None)
            c = torch.randn_like(w)
            w.normal_(0.0, 0.02)
            torch.nn.init.xavier_uniform_(w)
            return a, b, c
    """)
    assert lines(fs, "CFN106") == [4, 5, 6, 7, 8]
    assert "global random stream" in hits(fs, "CFN106")[0].message


def test_cfn106_draws_from_a_generator_clean():
    fs = findings_for("""\
        import torch

        def init(w, shape, gen):
            a = torch.rand(shape, generator=gen)
            b = torch.randint(0, 10, shape, generator=gen)
            w.normal_(0.0, 0.02, generator=gen)
            torch.nn.init.normal_(w, generator=gen)
            return a + b
    """)
    assert not hits(fs, "CFN106")


def test_cfn106_loop_invariant_reseed():
    fs = findings_for("""\
        import torch

        def runs(n, seed):
            out = []
            for i in range(n):
                g = torch.Generator().manual_seed(seed)
                out.append(torch.rand(3, generator=g))
            while len(out) < 2 * n:
                torch.manual_seed(0)
                out.append(out[-1])
            return out
    """)
    got = hits(fs, "CFN106")
    assert [f.line for f in got] == [6, 9]
    assert "replays the same stream" in got[0].message


def test_cfn106_reseed_per_iteration_or_outside_loops_clean():
    fs = findings_for("""\
        import torch

        def runs(n, seed):
            g = torch.Generator().manual_seed(seed)
            out = []
            for i in range(n):
                gi = torch.Generator().manual_seed(seed + i)
                out.append(torch.rand(3, generator=gi))
            for s in range(n):
                g.manual_seed(s)
                out.append(torch.rand(3, generator=g))
            return out
    """)
    assert not hits(fs, "CFN106")


def test_cfn106_numpy_generators_not_flagged():
    fs = findings_for("""\
        import numpy as np

        def data(n):
            rng = np.random.default_rng(0)
            return rng.normal(size=n), rng.integers(0, 4, n)
    """)
    assert not hits(fs, "CFN106")


# ---------------------------------------------------------------------------
# CFN107: launch aliasing
# ---------------------------------------------------------------------------

_LAUNCHES = textwrap.dedent("""\
    import ctypes


    def _ptr(t):
        return ctypes.c_void_p(t.data_ptr())


    def _launch(fn, *args):
        return fn(*args, None)

""")


def test_cfn107_output_slot_also_an_input():
    fs = findings_for(_LAUNCHES + textwrap.dedent("""\
        def score(lib, X, s, d, F, H, route, pp, nn, B):
            lib.placement_power_launch(_ptr(X), _ptr(s), _ptr(d), _ptr(F),
                                       _ptr(H), _ptr(route), _ptr(pp),
                                       _ptr(nn), _ptr(F), B, 1, 1, 1, 1, 1,
                                       1)
    """))
    got = hits(fs, "CFN107")
    assert [f.line for f in got] == [12]
    assert "`F`" in got[0].message and "placement_power_launch" \
        in got[0].message


def test_cfn107_through_launch_helper_tuple_and_alias():
    fs = findings_for(_LAUNCHES + textwrap.dedent("""\
        def attend(lib, q, k, v, qp, kp):
            out = q
            p = lambda t: ctypes.c_void_p(t.data_ptr())
            ptrs = (p(q), p(k), p(v), p(qp), p(kp), p(out))
            lib.flash_attention_launch(*ptrs, 1, 1, 1, 1, 1, 8, 8, 1, 0, 0,
                                       0.0)

        def decode(lib, q, k, v, qp, kp, out, ml):
            _launch(lib.flash_attention_decode_launch, _ptr(q), _ptr(k),
                    _ptr(v), _ptr(qp), _ptr(kp), _ptr(out), _ptr(q),
                    _ptr(ml))
    """))
    assert lines(fs, "CFN107") == [15, 19]


def test_cfn107_distinct_buffers_clean():
    fs = findings_for(_LAUNCHES + textwrap.dedent("""\
        import torch

        def attend(lib, q, k, v, qp, kp):
            out = torch.empty_like(q)
            p = lambda t: ctypes.c_void_p(t.data_ptr())
            ptrs = (p(q), p(k), p(v), p(qp), p(kp), p(out))
            lib.flash_attention_launch(*ptrs, 1, 1, 1, 1, 1, 8, 8, 1, 0, 0,
                                       0.0)
            return out
    """))
    assert not hits(fs, "CFN107")


def test_cfn107_python_inplace_consumer(tmp_path):
    kern = tmp_path / "src" / "kernels"
    kern.mkdir(parents=True)
    (kern / "__init__.py").write_text("")
    (kern / "placement_power.py").write_text(textwrap.dedent("""\
        def placement_power_launch(out, X, *operands):
            return out
    """))
    (tmp_path / "src" / "run.py").write_text(textwrap.dedent("""\
        from kernels import placement_power as pp

        def bad(X, ops):
            pp.placement_power_launch(X, X, *ops)

        def good(res, X, ops):
            pp.placement_power_launch(res, X, *ops)
    """))
    fs = hits(analyze_paths([str(tmp_path)]), "CFN107")
    assert [(Path(f.path).name, f.line) for f in fs] == [("run.py", 4)]


# ---------------------------------------------------------------------------
# CFN108: shape-cardinality
# ---------------------------------------------------------------------------

_ENTRY = textwrap.dedent("""\
    import torch
    from .solvers import count_traces

    def _pow2(n, lo=2):
        b = lo
        while b < n:
            b *= 2
        return b

    @count_traces("kern")
    def kern(x):
        return x * 2

""")


def test_cfn108_unbounded_provenance_reaching_entry():
    fs = findings_for(_ENTRY + textwrap.dedent("""\
        def run():
            import time
            n = time.time()
            return kern(torch.zeros(int(n)))
    """), path="src/repro_torch/core/mymod.py")
    got = hits(fs, "CFN108")
    assert got and "unbounded" in got[0].message and got[0].line == 17


def test_cfn108_bucketed_shapes_clean():
    fs = findings_for(_ENTRY + textwrap.dedent("""\
        def run(xs):
            return kern(torch.zeros(_pow2(len(xs))))
    """), path="src/repro_torch/core/mymod.py")
    assert not hits(fs, "CFN108")


def test_cfn108_static_bound_over_cap():
    # three independent pow-2 bucket axes: 8^3 = 512 > the default cap
    fs = findings_for(_ENTRY + textwrap.dedent("""\
        def run(a, b, c):
            x = torch.zeros((_pow2(a), _pow2(b), _pow2(c)))
            return kern(x)
    """), path="src/repro_torch/core/mymod.py")
    got = hits(fs, "CFN108")
    assert got and "exceeds" in got[0].message and got[0].line == 11


def test_cfn108_bucket_axes_returned_by_a_helper_reach_the_entry():
    # a helper that buckets its shape and returns it (federation's
    # _batch_inputs) passes its axes to the caller's entry call
    src = _ENTRY + textwrap.dedent("""\
        TIERS = {"quick": 1, "standard": 2, "high": 3}

        def inputs(xs, effort):
            n = TIERS[effort]
            return torch.zeros(_pow2(len(xs))), n

        def run(xs, effort):
            return kern(*inputs(xs, effort))
    """)
    mod = Module(src, path="src/repro_torch/core/mymod.py")
    eb = compute_cache_bounds(Project([mod]))["kern"]
    kinds = sorted((a.kind, a.card) for a in eb.axes().values()
                   if a.kind != "param")
    assert kinds == [("bucket", None), ("finite", 3)]
    assert eb.static_bound() == 24


def test_cfn108_vmapped_entry_alias_is_a_site():
    src = _ENTRY + textwrap.dedent("""\
        from torch.func import vmap

        kerns = vmap(kern)

        def run(xs):
            return kerns(xs)
    """)
    mod = Module(src, path="src/repro_torch/core/mymod.py")
    eb = compute_cache_bounds(Project([mod]))["kern"]
    assert [s.context for s in eb.sites] == ["run"]


def test_cfn108_shipped_bounds_under_caps():
    project, errs = __import__(
        "repro_torch.analysis", fromlist=["load_project"]).load_project(
            [str(REPO / "src" / "repro_torch")])
    assert not errs
    bounds = compute_cache_bounds(project)
    for entry in ("sweep", "anneal_delta", "anneal_full", "solve_regions"):
        b = bounds[entry].static_bound()
        assert b is not None, f"{entry}: unbounded static provenance"
        assert b <= CACHE_CAPS[entry], f"{entry}: {b} > cap"


# ---------------------------------------------------------------------------
# CFN109: dead device compute
# ---------------------------------------------------------------------------

def test_cfn109_dead_tensors():
    fs = findings_for("""\
        import numpy as np
        import torch

        def f(x, v):
            y = torch.sum(x * x)
            z = x.to("cuda")
            a = torch.as_tensor(v)
            h = x.cpu()
            n = np.asarray(x)
            return x
    """)
    got = hits(fs, "CFN109")
    assert [f.line for f in got] == [5, 6, 7, 8, 9]
    assert "`y`" in got[0].message


def test_cfn109_consumed_underscore_and_non_tensor_calls_clean():
    fs = findings_for("""\
        import torch

        def f(x):
            y = torch.sum(x * x)
            _warm = torch.ones((4,))
            dev = torch.device("cuda")
            s = torch.cuda.current_stream()
            g = torch.Generator()
            return y
    """)
    assert not hits(fs, "CFN109")


# ---------------------------------------------------------------------------
# suppression + fingerprint stability
# ---------------------------------------------------------------------------

def test_flow_rule_pragma_right_id_suppresses_wrong_id_does_not():
    src = """\
        import torch

        def f(shape):
            a = torch.rand(shape)  # tracelint: allow[CFN106]
            return a
    """
    assert not hits(findings_for(src), "CFN106")
    wrong = src.replace("allow[CFN106]", "allow[CFN104]")
    assert hits(findings_for(wrong), "CFN106")


def test_baseline_fingerprint_survives_cross_file_move(tmp_path):
    body = textwrap.dedent("""\
        import torch

        def noisy(shape):
            return torch.randn(shape)
    """)
    (tmp_path / "alpha.py").write_text(body)
    (tmp_path / "beta.py").write_text("import torch\n")
    fs = analyze_paths([str(tmp_path)])
    assert hits(fs, "CFN106")
    baseline = set(json.loads(json.dumps(
        baseline_payload(fs)))["suppressions"])
    (tmp_path / "alpha.py").write_text("import torch\n")
    (tmp_path / "beta.py").write_text(
        "import torch\n\n\n" + body[len("import torch\n"):])
    moved = analyze_paths([str(tmp_path)])
    assert hits(moved, "CFN106")
    assert apply_baseline(moved, baseline) == []
