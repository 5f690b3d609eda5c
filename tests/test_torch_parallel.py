"""Logical-axis sharding, mesh construction, abstract specs and the int8
quantizer of the PyTorch port against the JAX package, in one process:
``parallel.sharding.logical_spec`` against the reference's over
(logical axes, shape, mesh shape) cases -- divisibility drops, an axis
never reused, rule overrides -- with a stand-in mesh (the reference's
``_resolve`` reads only ``mesh.shape``); each leaf's logical axes against
the reference's ``init_model(...)[1]`` without its stacked repeats axis,
for all ten configs; ``launch.specs`` against the reference's specs;
``train.compress.quantize`` byte-equal to the reference's; a mesh of one
process (gloo, an in-process store) on which the sharded step equals the
plain step bit for bit.  Every comparison here is exact."""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro.serve import cache as jcache
from repro.train import compress as jcompress
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh as mesh_mod, specs as tspecs
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as sh
from repro_torch.serve import cache as tcache
from repro_torch.train import compress as tcompress, step as tstep

REPO = Path(__file__).resolve().parents[1]

SPEC_CASES = [
    # logical axes, shape, mesh shape
    (("fsdp", "tp"), (64, 48), {"data": 2, "model": 4}),
    (("tp", "fsdp"), (92553, 2048), {"data": 16, "model": 16}),  # vocab
    (("heads",), (25,), {"data": 4, "model": 16}),                # hymba
    (("batch", None), (8, 5), {"pod": 2, "data": 2, "model": 2}),
    (("batch",), (6,), {"pod": 2, "data": 2}),          # pod only divides
    (("batch", "seq"), (4, 7), {"data": 4, "model": 2}),  # no pod axis
    (("tp", "tp"), (8, 8), {"model": 2}),               # never reused
    (("fsdp", "fsdp", "tp"), (8, 8, 8), {"data": 2, "model": 2}),
    (("expert", "fsdp", None), (64, 32, 16), {"data": 4, "model": 8}),
    (("pod",), (4,), {"pod": 2, "data": 2}),            # a mesh axis name
    (("foo", None), (4, 4), {"data": 2}),               # unknown name
    ((None, None), (3, 5), {"data": 2, "model": 2}),
    (("kv_seq", "q_seq"), (16, 16), {"model": 4}),
    (("batch", "tp"), (1, 6), {"pod": 1, "data": 1, "model": 1}),
]
RULES = [
    {"batch": ("data",)},
    {"fsdp": ("pod", "data"), "tp": ()},
    {"tp": ("model", "data"), "vocab": ("data",)},
]


def _ref_spec(logical, shape, sizes, rules=None):
    prev = jsh._CTX.rules
    jsh._CTX.rules = {**jsh.DEFAULT_RULES, **(rules or {})}
    try:
        return tuple(jsh.logical_spec(logical, shape,
                                      types.SimpleNamespace(shape=sizes)))
    finally:
        jsh._CTX.rules = prev


@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[f"s{i}" for i in range(len(SPEC_CASES))])
def test_logical_spec_matches_reference(case):
    logical, shape, sizes = case
    assert sh.logical_spec(logical, shape, sizes) == _ref_spec(
        logical, shape, sizes)


@pytest.mark.parametrize("rules", RULES, ids=["r0", "r1", "r2"])
def test_rule_overrides_match_reference(rules):
    with sh.mesh_context({"pod": 2, "data": 2, "model": 2}, rules) as mesh:
        assert sh.current_mesh() is mesh and sh.axis_size("data") == 2
        for logical, shape, sizes in SPEC_CASES:
            assert sh.logical_spec(logical, shape, sizes) == _ref_spec(
                logical, shape, sizes, rules)
    assert sh.current_mesh() is None and sh.axis_size("data") == 1
    assert sh.logical_spec(("fsdp",), (8,)) == ()


def test_placements_blocks_and_replicas():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert sh.placements((None,), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), mesh)
    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = (("pod", "data"), "model")
    x = np.arange(8 * 6).reshape(8, 6)
    seen = np.zeros_like(x)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                got = sh.block(spec, x.shape, sizes,
                               {"pod": p, "data": d, "model": m})
                assert got == (slice(2 * (2 * p + d), 2 * (2 * p + d) + 2),
                               slice(3 * m, 3 * m + 3))
                seen[got] += 1
    assert (seen == 1).all()
    assert sh.replicas(spec, sizes) == 1
    assert sh.replicas(("model", None), sizes) == 4
    assert sh.replicas((None,), sizes) == 8


def test_shard_params_by_leaf():
    """Placements of every leaf from its logical axes under a mesh; None
    for every leaf outside one."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = tconfigs.get_smoke("internvl2-2b")
    model = TM.init_model(cfg, device="meta")
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    got = sh.shard_params(model, model.axes, mesh)
    assert list(got) == list(model.axes)
    for name, p in model.named_parameters():
        want = sh.placements(sh.logical_spec(model.axes[name], p.shape,
                                             {"data": 2, "model": 4}), mesh)
        assert got[name] == want
    assert got["top.final_norm"] == [Replicate(), Replicate()]
    wq = next(n for n in got if n.endswith(".wq"))
    assert got[wq] == [Shard(0), Shard(1)]
    assert set(sh.shard_params(dict(model.named_parameters()),
                               model.axes).values()) == {None}


def _ref_axes(jcfg):
    box = {}

    def f(key):
        params, box["axes"] = JM.init_model(jcfg, key)
        return params

    jax.eval_shape(f, jax.random.key(0))
    return box["axes"]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_leaf_axes_match_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    ref = _ref_axes(jcfg)
    want = {}
    for key, a in ref.items():
        if isinstance(a, tuple):
            want[f"top.{key}"] = a
            continue
        tag = "enc_groups" if key.startswith("enc_g") else "groups"
        gi = int(key.split("g")[-1])
        plan = (TM.encoder_plan if tag == "enc_groups"
                else TM.layer_plan)(tcfg)
        for r in range(plan[gi].repeats):
            for b, leaves in a.items():
                for leaf, ax in leaves.items():
                    assert ax[0] is None                 # the stacked axis
                    want[f"{tag}.{gi}.{r}.{b}.{leaf}"] = ax[1:]
    model = TM.init_model(tcfg, device="meta", trainable=True)
    assert model.axes == want
    assert list(model.axes) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert len(model.axes[name]) == p.ndim


def test_params_from_numpy_keeps_init_order():
    """A model carried from the reference's tree (whose dicts JAX sorts)
    has init_model's leaf order, so states of one config flatten alike."""
    jcfg, tcfg = jconfigs.get_smoke("hymba-1.5b"), \
        tconfigs.get_smoke("hymba-1.5b")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = TM.params_from_numpy(tcfg, tree, device="cpu")
    assert [n for n, _ in model.named_parameters()] == list(model.axes)


def test_optimizer_state_axes_mirror_params():
    axes = {"a": ("fsdp", "tp"), "b": (None,)}
    ref = jadamw.state_axes(axes)
    got = tadamw.state_axes(axes)
    assert got.m == ref.m == got.v == ref.v and got.count == ref.count


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-base",
                                  "internvl2-2b"])
def test_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for seq in (64, 512, 1024):
        assert tspecs.dec_len(tcfg, seq) == jspecs.dec_len(jcfg, seq)
    for labels in (False, True):
        want = jspecs.token_specs(jcfg, 4, 512, labels)
        got = tspecs.token_specs(tcfg, 4, 512, labels)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert tuple(got[k].shape) == s.shape and got[k].is_meta
            assert str(got[k].dtype).split(".")[-1] == str(s.dtype)
    for compress in (False, True):
        jstate, jaxes = jspecs.train_state_specs(jcfg, compress)
        state, axes = tspecs.train_state_specs(tcfg, compress)
        n = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(jstate.params))
        assert TM.param_count(state.model) == n
        assert all(p.is_meta and p.dtype == torch.float32
                   for p in state.model.parameters())
        assert [tuple(m.shape) for m in state.opt.m] == \
            [tuple(p.shape) for p in state.model.parameters()]
        assert (state.err is None) == (jstate.err is None) == (not compress)
        assert axes.model == state.model.axes
        assert axes.opt.m == list(state.model.axes.values())
        assert (axes.err is None) == (not compress)
        assert axes.step == jaxes.step == ()
    for kind in ("prefill", "decode"):
        jp, _, jb, je, jc = jspecs.serve_specs(jcfg, 2, 256, kind)
        tp, taxes, tb, te, tc = tspecs.serve_specs(tcfg, 2, 256, kind)
        assert taxes == tp.axes
        assert all(p.dtype == torch.bfloat16 for p in tp.parameters())
        assert {k: tuple(v.shape) for k, v in tb.items()} == \
            {k: v.shape for k, v in jb.items()}
        assert sorted(te) == sorted(je)
        assert [s.shape for s in tcache.leaves(tc)] == \
            [s.shape for s in jax.tree_util.tree_leaves(
                jc, is_leaf=lambda x: isinstance(x, jcache.TSpec))]


def test_quantize_matches_reference_byte_for_byte():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(1000).astype(np.float32),
             (rng.standard_normal((33, 7)) * 1e-3).astype(np.float32),
             np.array([127.0, 0.5, 1.5, -2.5, -127.0], np.float32),  # ties
             np.zeros(5, np.float32)]
    for x in cases:
        jq, js = jcompress.quantize(jnp.asarray(x))
        tq, ts = tcompress.quantize(torch.tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.dtype == torch.float32
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        err = torch.tensor(x) - tcompress.dequantize(tq, ts)
        assert float(err.abs().max()) <= float(ts) * 0.500001
        np.testing.assert_array_equal(
            tcompress.dequantize(tq, ts).numpy(),
            np.asarray(jcompress.dequantize(jq, js)))


@pytest.fixture
def one_process_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_process_mesh_step_equals_plain_step(one_process_group):
    """A ("pod", "data", "model") (1, 1, 1) gloo mesh (the card's world of
    one, on the CPU): the sharded step, with and without the pod
    compression (the identity at one pod), equals the plain step bit for
    bit over 2 steps, bf16 compute."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    assert not dist.is_initialized()
    mesh = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    assert dist.get_world_size() == 1 and mesh.mesh_dim_names == (
        "pod", "data", "model")
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-4b"), n_layers=2)
    opt = tadamw.AdamWConfig(lr=5e-3)
    dcfg = DataConfig(seed=0, batch=4, seq_len=32)
    runs = {}
    for name, kw in (("plain", {}), ("sharded", dict(mesh=mesh)),
                     ("compressed", dict(mesh=mesh, compress_pod=True))):
        state = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", **kw)
        step = tstep.make_train_step(cfg, opt, accum=2, **kw)
        losses = []
        for i in range(2):
            state, m = step(state, make_batch(cfg, dcfg, i))
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        params = [p.full_tensor() if hasattr(p, "full_tensor") else p
                  for p in state.model.parameters()]
        runs[name] = (losses, [p.detach().clone() for p in params], state)
    for name in ("sharded", "compressed"):
        assert runs[name][0] == runs["plain"][0]
        for a, b in zip(runs[name][1], runs["plain"][1]):
            assert torch.equal(a, b)
    assert all(float(e.to_local().abs().max()) == 0
               for e in runs["compressed"][2].err)
    sync = tcompress.make_compressed_sync(mesh)
    g = [torch.ones(3)]
    assert sync(g, g) == (g, g)
    with pytest.raises(ValueError, match="mesh"):
        tstep.make_train_step(cfg, opt, compress_pod=True)
    with pytest.raises(ValueError, match="sharded"):
        tstep.make_train_step(cfg, opt, compress_pod=True, mesh=mesh)(
            runs["plain"][2], make_batch(cfg, dcfg, 0))


def _one_process_mesh():
    return mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")


def test_step_refuses_a_state_off_its_mesh(one_process_group):
    """``make_train_step(..., mesh=m)`` takes the mesh from the state and
    asserts it: a state sharded on another mesh, or not sharded at all,
    raises instead of running on whatever layout it has."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = _one_process_mesh()
    other = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-4b"), n_layers=1)
    opt = tadamw.AdamWConfig(lr=5e-3)
    batch = make_batch(cfg, DataConfig(seed=0, batch=2, seq_len=16), 0)
    gen = lambda: torch.Generator().manual_seed(0)
    on_mesh = tstep.init_state(cfg, gen(), device="cpu", mesh=mesh)
    plain = tstep.init_state(cfg, gen(), device="cpu")
    for state, step_mesh in ((on_mesh, other), (plain, mesh)):
        with pytest.raises(ValueError, match="not sharded on the step's mesh"):
            tstep.make_train_step(cfg, opt, mesh=step_mesh)(state, batch)
    state, m = tstep.make_train_step(cfg, opt, mesh=mesh)(on_mesh, batch)
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


def test_trainer_restores_onto_the_first_state_mesh(tmp_path,
                                                    one_process_group):
    """A ``ResilientTrainer`` given no ``mesh`` whose first state is
    sharded restores onto that state's mesh after a failure, and the
    replayed losses equal a clean run's (rtol 1e-5, the reference's
    bound, tests/test_substrate.py:98)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.fault import ResilientTrainer, SimulatedFailure
    mesh = _one_process_mesh()
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-4b"), n_layers=1,
                              dtype="float32")
    dcfg = DataConfig(seed=0, batch=2, seq_len=16)
    inner = tstep.make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3),
                                  compute_dtype=None)
    layouts = []

    def step(state, batch):
        layouts.append(isinstance(next(state.model.parameters()), DTensor))
        return inner(state, batch)

    init_fn = lambda: tstep.init_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu", mesh=mesh)
    runs = {}
    for name, fail in (("clean", {}), ("failed", {3: SimulatedFailure("x")})):
        trainer = ResilientTrainer(cfg, dcfg, step, init_fn,
                                   str(tmp_path / name), ckpt_every=2,
                                   device="cpu")
        runs[name] = trainer.run(4, fail_at=fail)
        assert trainer.mesh == mesh
    assert runs["failed"].restarts == 1
    assert len(layouts) == 4 + 3 + 2 and all(layouts)
    np.testing.assert_allclose(runs["failed"].losses[3:],
                               runs["clean"].losses[2:], rtol=1e-5)


def test_distributed_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.mesh, repro_torch.launch.specs, "
            "repro_torch.parallel.sharding, repro_torch.train.compress, "
            "repro_torch.checkpoint, repro_torch.fault.runner\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "from repro_torch.launch import mesh\n"
            "assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
