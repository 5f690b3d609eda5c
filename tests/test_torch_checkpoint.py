"""The port's checkpoint store, resilient trainer and the train CLI's
``--ckpt-dir`` against the JAX package (the templates of
``tests/test_substrate.py:54-143``): the round trip and the LATEST
pointer, a writer's error raised at ``wait()``, each package reading the
other's checkpoint, restore into a ``meta`` skeleton, restart replay after
an injected failure (equal to the clean run and, from the same weights,
to the reference's trainer), the monitors reset on restart, and the CLI
resuming a run.

Tolerances: restored arrays exact; replayed losses rtol 1e-5 (the
reference's own bound, ``tests/test_substrate.py:98``); the port's
float32 trainer against the reference's rtol 1e-5 (as
``tests/test_torch_train.py`` holds one step); the CLI's resumed run
rtol 1e-5 of an uninterrupted one."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointStore as JStore
from repro.data import pipeline as jdata
from repro.fault import ResilientTrainer as JTrainer
from repro.fault import SimulatedFailure as JFailure
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointStore, store as store_mod
from repro_torch.data.pipeline import DataConfig
from repro_torch.fault import ResilientTrainer, SimulatedFailure
from repro_torch.launch import specs as tspecs, train as train_cli
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (the training tests' setting: several test
    workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return dict(a=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                b=[torch.ones(4), torch.zeros((), dtype=torch.int32)])


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _tree()
    store.save(7, tree, extra=dict(data_step=7))
    tree["a"].add_(1.0)               # a later in-place update: not saved
    store.wait()
    got, extra = store.restore(None, _tree(), device="cpu")
    assert extra["data_step"] == 7
    assert torch.equal(got["a"], _tree()["a"])
    assert got["b"][1].dtype == torch.int32 and got["b"][1].shape == ()
    assert store.latest_step() == 7
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["leaves"] == ["a", "b/0", "b/1"]
    assert sorted(manifest) == ["extra", "leaves", "step", "treedef"]
    assert sorted(p.name for p in (tmp_path / "step_7").iterdir()) == [
        "leaf_0.npy", "leaf_1.npy", "leaf_2.npy", "manifest.json"]


def test_checkpoint_keeps_latest_pointer(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = dict(x=torch.zeros(2))
    store.save(1, t, extra=dict(data_step=1))
    store.save(2, t, extra=dict(data_step=2))
    store.wait()
    assert store.latest_step() == 2
    assert not (tmp_path / "LATEST.tmp").exists()
    assert not list(tmp_path.glob(".tmp_step_*"))
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore(None, t)


def test_writer_error_is_raised_at_wait(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))
    store.save(1, dict(x=torch.zeros(2)), extra=dict(data_step=1))
    store.wait()

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(store_mod.np, "save", broken)
    store.save(2, dict(x=torch.ones(2)), extra=dict(data_step=2))
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.wait()                       # raised once
    assert store.latest_step() == 1    # the pointer never moved
    monkeypatch.undo()
    store.save(3, dict(x=torch.ones(2)), extra=dict(data_step=3))
    store.wait()
    assert store.latest_step() == 3


def test_port_reads_reference_checkpoint(tmp_path):
    jtree = dict(a=jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                 b=[jnp.ones(4), jnp.zeros((), jnp.int32)],
                 c=dict(z=jnp.full((2,), 3.0), y=jnp.arange(3)))
    js = JStore(str(tmp_path))
    js.save(5, jtree, extra=dict(data_step=5))
    js.wait()
    like = dict(a=torch.zeros(2, 3), b=[torch.zeros(4),
                                        torch.zeros((), dtype=torch.int32)],
                c=dict(z=torch.zeros(2), y=torch.zeros(3, dtype=torch.int32)))
    got, extra = CheckpointStore(str(tmp_path)).restore(None, like,
                                                        device="cpu")
    assert extra == {"data_step": 5}
    for k in ("a",):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jtree[k]))
    np.testing.assert_array_equal(got["c"]["z"].numpy(), [3.0, 3.0])
    np.testing.assert_array_equal(got["c"]["y"].numpy(), [0, 1, 2])
    assert list(got["c"]) == ["z", "y"]           # like's key order


def test_reference_reads_port_checkpoint(tmp_path):
    tree = dict(a=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                b=[torch.ones(4), torch.zeros((), dtype=torch.int32)],
                c=dict(z=torch.full((2,), 3.0), y=torch.arange(3)))
    store = CheckpointStore(str(tmp_path))
    store.save(4, tree, extra=dict(data_step=4))
    store.wait()
    like = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    got, extra = JStore(str(tmp_path)).restore(None, like)
    assert extra == {"data_step": 4} and JStore(str(tmp_path)) \
        .latest_step() == 4
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cfg():
    return dataclasses.replace(tconfigs.get_smoke("qwen3-4b"), n_layers=2)


def test_restore_into_meta_skeleton(tmp_path):
    """The mesh-free case of the elastic path: a state restored into its
    ``meta`` skeleton (``launch.specs.train_state_specs``) is the state,
    masters trainable, and a checkpoint of another tree is refused."""
    cfg = _cfg()
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu", compress_pod=True)
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(3, state, extra=dict(data_step=3))
    store.wait()
    like, _ = tspecs.train_state_specs(cfg, compress_pod=True)
    got, extra = store.restore(None, like, device="cpu")
    assert extra == {"data_step": 3}
    assert all(p.is_meta for p in like.model.parameters())   # untouched
    flat_a = [t for _, t in store_mod._flatten(state)]
    flat_b = [t for _, t in store_mod._flatten(got)]
    assert len(flat_a) == len(flat_b) == 4 * len(list(
        state.model.parameters())) + 2
    for a, b in zip(flat_a, flat_b):
        assert b.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a.detach(), b.detach())
    assert all(p.requires_grad for p in got.model.parameters())
    assert got.model.axes == state.model.axes
    with pytest.raises(ValueError, match="leaves"):
        store.restore(None, tspecs.train_state_specs(cfg)[0], device="cpu")


def _trainer(tmp_path, name, ckpt_every=4, weights=None):
    cfg = dataclasses.replace(_cfg(), dtype="float32")
    dcfg = DataConfig(seed=0, batch=2, seq_len=16)
    step = tstep.make_train_step(cfg, tadamw.AdamWConfig(lr=1e-3),
                                 compute_dtype=None)

    def init_fn():
        if weights is None:
            return tstep.init_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        model = TM.params_from_numpy(cfg, weights, device="cpu",
                                     trainable=True)
        return tstep.TrainState(model, tadamw.init(model.parameters()),
                                torch.zeros((), dtype=torch.int32))

    return ResilientTrainer(cfg, dcfg, step, init_fn, str(tmp_path / name),
                            ckpt_every=ckpt_every, device="cpu")


def test_restart_replays_identically(tmp_path):
    """The loss trajectory after a failure at step 6 and a restore of step
    4 equals the unfailed run's (step-indexed data, checkpointed state)."""
    ref = _trainer(tmp_path, "clean").run(8)
    faulty = _trainer(tmp_path, "faulty")
    rep = faulty.run(8, fail_at={6: SimulatedFailure("node died")})
    assert rep.restarts == 1 and rep.final_step == 8
    assert len(rep.losses) == 6 + 4                 # steps 0-5, then 4-7
    np.testing.assert_allclose(rep.losses[:6], ref.losses[:6], rtol=1e-5)
    np.testing.assert_allclose(rep.losses[6:], ref.losses[4:], rtol=1e-5)
    assert faulty.store.latest_step() == 8
    with pytest.raises(SimulatedFailure):
        _trainer(tmp_path, "hopeless").run(
            8, fail_at={1: SimulatedFailure("a"), 2: SimulatedFailure("b")},
            max_restarts=1)


def test_trainer_matches_reference_trainer(tmp_path):
    """From the reference's weights, the port's resilient run (with its
    restart) gives the reference's ResilientTrainer's losses."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"), n_layers=2,
                               dtype="float32")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    jstep_fn = jax.jit(jstep.make_train_step(
        jcfg, jadamw.AdamWConfig(lr=1e-3), compute_dtype=None))
    init_fn = lambda: jstep.TrainState(params=params,
                                       opt=jadamw.init(params),
                                       step=jnp.zeros((), jnp.int32))
    jrep = JTrainer(jcfg, jdata.DataConfig(seed=0, batch=2, seq_len=16),
                    jstep_fn, init_fn, str(tmp_path / "ref"),
                    ckpt_every=4).run(6, fail_at={5: JFailure("x")})
    rep = _trainer(tmp_path, "port", weights=jax.tree_util.tree_map(
        np.asarray, params)).run(6, fail_at={5: SimulatedFailure("x")})
    assert rep.restarts == 1
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-5)


def test_restart_resets_the_monitors(tmp_path):
    trainer = _trainer(tmp_path, "mon", ckpt_every=2)
    calls = []
    real = trainer.monitor.deregister
    trainer.monitor.deregister = lambda w: (calls.append(w), real(w))
    trainer.monitor.register("worker0")
    trainer.monitor.last_beat["worker0"] = -1e9         # long dead
    assert trainer.monitor.dead_workers() == ["worker0"]
    rep = trainer.run(4, fail_at={3: SimulatedFailure("x")})
    assert rep.restarts == 1 and calls == ["worker0"]
    # steps 2 and 3 after the restore: the pre-failure history is gone
    assert len(trainer.straggler.times) == 2
    assert trainer.monitor.healthy()


def test_train_cli_ckpt_dir_resumes(tmp_path, capsys):
    """``--ckpt-dir``: 12 steps, then ``--steps 24`` on the same directory
    resumes at step 12 and ends where an uninterrupted 24-step run ends."""
    common = ["--arch", "qwen3-4b", "--batch", "4", "--seq", "32", "--lr",
              "5e-3", "--device", "cpu"]
    ck = str(tmp_path / "D")
    out = []
    for argv in (["--steps", "12", "--ckpt-dir", ck],
                 ["--steps", "24", "--ckpt-dir", ck], ["--steps", "24"]):
        assert train_cli.main(common + argv) == 0
        out.append(json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1]))
    first, resumed, whole = out
    assert first["improved"] and first["first_loss"] == whole["first_loss"]
    assert resumed["first_loss"] != whole["first_loss"]     # from step 12
    np.testing.assert_allclose(resumed["last_loss"], whole["last_loss"],
                               rtol=1e-5)
    store = CheckpointStore(ck)
    assert store.latest_step() == 24 and (tmp_path / "D" / "step_12").is_dir()
    like, _ = tspecs.train_state_specs(tconfigs.get_smoke("qwen3-4b"))
    state, extra = store.restore(None, like, device="cpu")
    assert extra == {"data_step": 24}
    assert int(state.step) == int(state.opt.count) == 24
