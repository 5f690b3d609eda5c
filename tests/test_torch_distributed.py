"""The port's sharded train step, int8 pod compression and elastic
restore on 4 (and 2) gloo ranks on the CPU, against the port's and the
JAX package's single-device steps.

One 4-rank job (``_torch_dist.sharded_training``) runs 2 float32 steps of
the reference's smoke qwen3-4b at 2 layers, from the reference's weights,
on a ("data", "model") (2, 2) and a ("pod", "data", "model") (2, 1, 2)
mesh -- each rank on its own block of the batch of 8 -- and with the
int8 pod compression on the latter, and checkpoints the (2, 2) state;
one 2-rank job (``_torch_dist.elastic_restore``) restores that checkpoint
on a (1, 2) mesh and takes the next step.

Tolerances: the sharded step against the single-device steps as
``tests/test_torch_train.py`` holds the port's step against the
reference's -- the loss and grad_norm rtol 1e-5, every leaf within 1e-4
of its largest magnitude (the batch mean is summed in another order);
the compressed step's loss within 5e-2 of the reference's (the bound of
``tests/test_multidevice.py:69``); the compression's residual equal to
x - dequantize(quantize(x)) with the reference's quantize (1e-6 of the
scale); the restored step's loss rtol 1e-5 of the unsharded
continuation's (the reference's bound there is 5e-3,
``tests/test_multidevice.py:88``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import compress as jcompress, step as jstep
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as sh
from repro_torch.train import step as tstep

N_STEPS = 2
MESHES = {"dm": ({"data": 2, "model": 2}, ("data",)),
          "pdm": ({"pod": 2, "data": 1, "model": 2}, ("pod", "data"))}


def _flat(model_tree):
    """The reference's stacked tree as the port's leaf names."""
    out = {}
    for name, a in model_tree.items():
        if not isinstance(a, dict):
            out[f"top.{name}"] = a
            continue
        for b, leaves in a.items():
            for leaf, arr in leaves.items():
                for r in range(arr.shape[0]):
                    out[f"groups.{name[1:]}.{r}.{b}.{leaf}"] = arr[r]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"), n_layers=2,
                               dtype="float32")
    tcfg = D.smoke_cfg()
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    dcfg = jdata.DataConfig(**D.DATA)
    batches = [jdata.make_batch(jcfg, dcfg, i) for i in range(N_STEPS + 1)]

    jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.AdamWConfig(lr=D.LR),
                                        compute_dtype=None))
    js = jstep.TrainState(params=params, opt=jadamw.init(params),
                          step=jnp.zeros((), jnp.int32))
    ref = dict(losses=[], norms=[])
    for i in range(N_STEPS):
        js, m = jfn(js, batches[i])
        ref["losses"].append(float(m["loss"]))
        ref["norms"].append(float(m["grad_norm"]))
    ref["params"] = _flat(jax.tree_util.tree_map(np.asarray, js.params))

    model = TM.params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    ts = tstep.TrainState(model, tadamw.init(model.parameters()),
                          torch.zeros((), dtype=torch.int32))
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(lr=D.LR),
                                compute_dtype=None)
    single = dict(losses=[], norms=[])
    for i in range(N_STEPS + 1):
        if i == N_STEPS:
            single["params"] = {n: p.detach().numpy().copy()
                                for n, p in ts.model.named_parameters()}
        ts, m = tfn(ts, batches[i])
        single["losses"].append(float(m["loss"]))
        single["norms"].append(float(m["grad_norm"]))

    root = tmp_path_factory.mktemp("dist")
    ckpt = root / "ckpt"
    (root / "job4").mkdir()
    (root / "job2").mkdir()
    four = D.run_ranks(D.sharded_training, 4, root / "job4", tree, N_STEPS,
                       str(ckpt))
    two = D.run_ranks(D.elastic_restore, 2, root / "job2", str(ckpt))
    return dict(ref=ref, single=single, four=four, two=two, tcfg=tcfg)


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("against", ["port", "reference"])
def test_sharded_step_matches_single_device(runs, mesh, against):
    want = runs["single"] if against == "port" else runs["ref"]
    for rank in runs["four"]:            # every rank reports the same
        got = rank[mesh]
        np.testing.assert_allclose(got["losses"], want["losses"][:N_STEPS],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["norms"], want["norms"][:N_STEPS],
                                   rtol=1e-5)
    got = runs["four"][0][mesh]["params"]
    assert sorted(got) == sorted(want["params"])
    for name, a in want["params"].items():
        _close(got[name], a, 0.0, 1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_leaves_are_split_by_their_axes(runs, mesh):
    """Each rank's block of a leaf is its shape over the sizes of the mesh
    axes its logical axes resolve to (divisibility drops included), and
    every rank's blocks tile the leaf."""
    sizes, _ = MESHES[mesh]
    axes = TM.leaf_axes(runs["tcfg"])
    split = 0
    for name, a in runs["four"][0][mesh]["params"].items():
        spec = sh.logical_spec(axes[name], a.shape, sizes)
        want = tuple(n // int(np.prod([sizes[x] for x in
                                       sh.entry_axes(e)] or [1]))
                     for n, e in zip(a.shape, spec))
        for rank in runs["four"]:
            assert rank[mesh]["local_shapes"][name] == want, name
        split += want != a.shape
    assert split > 0


def test_compressed_step_within_reference_bound(runs):
    want = runs["ref"]["losses"]
    for rank in runs["four"]:
        got = rank["compressed"]["losses"]
        # the first loss precedes any update: the same as uncompressed
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert abs(got[-1] - want[-1]) < 5e-2, (got, want)


def test_compressed_residual_is_the_quantization_error(runs):
    """Per rank and leaf: the residual is x - dequantize(quantize(x)) of
    x = g + err under the reference's quantize, the state's ``err`` holds
    it, and the pod-averaged gradient is the two pods' dequantized
    payloads summed in rank order, halved."""
    four = runs["four"]
    by_coord = {tuple(r["compressed"]["coordinate"].values()): r
                for r in four}
    for rank in four:
        comp = rank["compressed"]
        coord = comp["coordinate"]
        other = by_coord[(1 - coord["pod"], coord["data"], coord["model"])]
        assert len(comp["records"]) == len(comp["err_after_first"])
        for i, (g, err, new_g, new_err) in enumerate(comp["records"]):
            x = g + err
            q, scale = jcompress.quantize(jnp.asarray(x))
            want = np.asarray(x - jcompress.dequantize(q, scale))
            np.testing.assert_allclose(new_err, want, rtol=0,
                                       atol=1e-6 * float(scale))
            np.testing.assert_array_equal(comp["err_after_first"][i],
                                          new_err)
            pods = [None, None]
            for r, (pg, pe) in ((coord["pod"], (g, err)),
                                (1 - coord["pod"],
                                 other["compressed"]["records"][i][:2])):
                qq, ss = jcompress.quantize(jnp.asarray(pg + pe))
                pods[r] = np.asarray(jcompress.dequantize(qq, ss))
            np.testing.assert_allclose(new_g, (pods[0] + pods[1]) / 2,
                                       rtol=1e-6, atol=1e-6 * float(
                                           np.abs(new_g).max()))


def test_elastic_restore_continues_the_run(runs):
    """Saved on (2, 2), restored on 2 ranks (1, 2) into the meta
    skeleton: the next step's loss is the unsharded continuation's."""
    single = runs["single"]
    saved = runs["four"][0]["dm"]
    for rank in runs["two"]:
        assert rank["extra"] == {"data_step": N_STEPS}
        assert rank["count"] == rank["step"] == N_STEPS + 1
        np.testing.assert_allclose(rank["losses"][0],
                                   single["losses"][N_STEPS], rtol=1e-5)
        np.testing.assert_allclose(rank["norms"][0],
                                   single["norms"][N_STEPS], rtol=1e-5)
        for name, a in saved["params"].items():
            np.testing.assert_array_equal(rank["restored"]["params"][name],
                                          a)
    restored = runs["two"][0]["restored"]
    moved = [n for n, shape in saved["local_shapes"].items()
             if restored["local_shapes"][n] != shape]
    assert moved


def test_shard_lays_out_a_tensor_on_the_mesh(runs):
    for rank, r in enumerate(runs["four"]):
        got = r["shard"]
        assert got["placements"] == ["Shard(0)", "Replicate"]
        assert got["whole"] and got["rank_mismatch_raises"]
        data = rank // 2                     # (2, 2): rank = 2 data + model
        np.testing.assert_array_equal(
            got["local"], np.arange(24, dtype=np.float32).reshape(8, 3)[
                4 * data:4 * data + 4])
