"""Rank workers for the port's distributed CPU tests
(``tests/test_torch_distributed.py``): gloo process groups on a
``file://`` store in the test's directory, one torch thread a rank, a 60 s
timeout on every collective, and a deadline on the whole job, so a hung
collective fails one test.  Workers import the port only (no JAX); they
are module-level functions so that a spawned child can import them, and
each writes its results to ``rank<r>.pkl`` in the job's directory."""
import dataclasses
import datetime
import os
import pickle
import time

import numpy as np

COLLECTIVE_TIMEOUT_S = 60
JOB_DEADLINE_S = 150


def run_ranks(fn, world: int, out_dir, *args) -> list:
    """Run ``fn(rank, world, out_dir, *args)`` in ``world`` spawned
    processes; their pickled results, by rank."""
    import torch.multiprocessing as mp
    out_dir = str(out_dir)
    ctx = mp.start_processes(fn, args=(world, out_dir) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOB_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks still "
                                   f"running after {JOB_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _init(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _finish(rank: int, out_dir: str, out: dict) -> None:
    import torch.distributed as dist
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def smoke_cfg(n_layers: int = 2):
    """The smoke qwen3-4b at ``n_layers`` in float32 (both packages'
    tests hold float32 steps)."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("qwen3-4b"),
                               n_layers=n_layers, dtype="float32")


DATA = dict(seed=0, batch=8, seq_len=32)
LR = 5e-3


def _steps(state, step, cfg, n_steps, first=0):
    from repro_torch.data.pipeline import DataConfig, make_batch
    dcfg = DataConfig(**DATA)
    losses, norms = [], []
    for i in range(first, first + n_steps):
        state, m = step(state, make_batch(cfg, dcfg, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def placement_names(placements) -> list:
    """"Shard(d)" / "Replicate" a mesh dimension (their repr differs
    across torch versions)."""
    return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__
            for p in placements]


def _summary(state) -> dict:
    """Every leaf gathered whole (collective; copied: a replicated leaf's
    whole tensor is its block, which the next step updates in place),
    local block shapes and placements by name."""
    named = list(state.model.named_parameters())
    return dict(
        params={n: p.full_tensor().detach().numpy().copy()
                for n, p in named},
        local_shapes={n: tuple(p.to_local().shape) for n, p in named},
        placements={n: placement_names(p.placements) for n, p in named})


def sharded_training(rank, world, out_dir, tree, n_steps, ckpt_dir):
    """On 4 ranks: ``n_steps`` float32 steps from the reference's weights
    ``tree`` on a ("data", "model") (2, 2) mesh, then a checkpoint of
    that state; the same on ("pod", "data", "model") (2, 1, 2), and with
    the int8 pod compression there (each leaf's compressed_pod_sum
    inputs and outputs of the first step recorded); ``shard`` under a
    mesh context."""
    _init(rank, world, out_dir)
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import compress as C
    from repro_torch.train import step as T
    cfg = smoke_cfg()
    opt = adamw.AdamWConfig(lr=LR)

    def fresh(compress: bool):
        model = M.params_from_numpy(cfg, tree, device="cpu", trainable=True)
        err = ([torch.zeros(p.shape) for p in model.parameters()]
               if compress else None)
        return T.TrainState(model, adamw.init(model.parameters()),
                            torch.zeros((), dtype=torch.int32), err)

    out = {}
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    step = T.make_train_step(cfg, opt, compute_dtype=None)
    state, losses, norms = _steps(T.shard_state(fresh(False), mesh), step,
                                  cfg, n_steps)
    out["dm"] = dict(losses=losses, norms=norms, **_summary(state))
    store = CheckpointStore(ckpt_dir)
    store.save(n_steps, state, extra=dict(data_step=n_steps))
    store.wait()

    with sh.mesh_context(mesh):
        x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        d = sh.shard(x, "batch", None)
        try:
            sh.shard(x, "batch")
            raises = False
        except ValueError:
            raises = True
        out["shard"] = dict(placements=placement_names(d.placements),
                            whole=bool(torch.equal(d.full_tensor(), x)),
                            local=d.to_local().numpy(),
                            rank_mismatch_raises=raises)

    mesh3 = mesh_mod.make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    state, losses, norms = _steps(T.shard_state(fresh(False), mesh3), step,
                                  cfg, n_steps)
    out["pdm"] = dict(losses=losses, norms=norms, **_summary(state))

    records, real = [], C.compressed_pod_sum
    n_leaves = len(list(state.model.parameters()))

    def recorded(g, err, n_pods, group):
        new_g, new_err = real(g, err, n_pods, group)
        if len(records) < n_leaves:
            records.append(tuple(t.detach().clone().numpy()
                                 for t in (g, err, new_g, new_err)))
        return new_g, new_err

    C.compressed_pod_sum = recorded
    try:
        stepc = T.make_train_step(cfg, opt, compute_dtype=None,
                                  compress_pod=True, mesh=mesh3)
        state, losses, norms = _steps(T.shard_state(fresh(True), mesh3),
                                      stepc, cfg, 1)
        err_after_first = [e.to_local().numpy().copy() for e in state.err]
        state, more, _ = _steps(state, stepc, cfg, n_steps - 1, first=1)
    finally:
        C.compressed_pod_sum = real
    out["compressed"] = dict(losses=losses + more, records=records,
                             err_after_first=err_after_first,
                             coordinate=sh.coordinate(mesh3))
    _finish(rank, out_dir, out)


def elastic_restore(rank, world, out_dir, ckpt_dir):
    """On 2 ranks: the 4-rank checkpoint restored into the ``meta``
    skeleton on a ("data", "model") (1, 2) mesh, then one more step on
    the next batch of the stream."""
    _init(rank, world, out_dir)
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import mesh as mesh_mod, specs
    from repro_torch.optim import adamw
    from repro_torch.train import step as T
    cfg = smoke_cfg()
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cpu")
    like, axes = specs.train_state_specs(cfg)
    state, extra = CheckpointStore(ckpt_dir).restore(None, like, mesh=mesh,
                                                     axes=axes)
    restored = _summary(state)
    step = T.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                             compute_dtype=None)
    state, losses, norms = _steps(state, step, cfg, 1,
                                  first=int(extra["data_step"]))
    _finish(rank, out_dir, dict(extra=extra, losses=losses, norms=norms,
                                count=int(state.opt.count),
                                step=int(state.step),
                                restored=restored))


def _recording(M, L, fa):
    """Wrap the port's attention and MLP entry points to record what a
    rank computes: per call the step, the query's and keys' shapes
    (``attend`` / ``attend_lse``) and the MLP's hidden width by prefix;
    returns (records, restore)."""
    rec = {"step": 0, "attend": [], "mlp": []}
    real = (L.attend, fa.attend_lse, M.mlp)

    def attend(q, k, v, **kw):
        rec["attend"].append((rec["step"], "attend", tuple(q.shape),
                              tuple(k.shape)))
        return real[0](q, k, v, **kw)

    def attend_lse(q, k, v, *a, **kw):
        rec["attend"].append((rec["step"], "attend_lse", tuple(q.shape),
                              tuple(k.shape)))
        return real[1](q, k, v, *a, **kw)

    def mlp(params, x, prefix="", group=None):
        rec["mlp"].append((rec["step"], prefix,
                           int(params[prefix + "w_gate"].shape[1])))
        return real[2](params, x, prefix, group)

    L.attend, fa.attend_lse, M.mlp = attend, attend_lse, mlp

    def restore():
        L.attend, fa.attend_lse, M.mlp = real
    return rec, restore


def sharded_serving(rank, world, out_dir, cells):
    """On 4 ranks, a ("data", "model") (2, 2) mesh: for each cell (name,
    arch, reference weights ``tree``, float32 config overrides, global
    batch, max_len, encoder length, decode steps) the port's sharded
    serving -- ``shard_model``, the cache's blocks (``zeros(...,
    mesh=...)``), the rank's rows (``batch_block``) -- through prefill and
    greedy decode steps under ``mesh_context``, tensor-parallel over the
    model axis: the rank's logits of every step, its ids, its cache
    leaves and its coordinate; what its attention and MLP calls took
    (``_recording``); the leaves the model group splits
    (``models.model.tp_leaves``), those the served view all-gathers
    along "model" (``engine._gather_plan``) and those whose block keeps
    a larger storage alive."""
    _init(rank, world, out_dir)
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers as L, model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve import cache as C, engine
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"coordinate": sh.coordinate(mesh)}
    for cell in cells:
        cfg = dataclasses.replace(configs.get_smoke(cell["arch"]),
                                  **cell["overrides"])
        model = engine.shard_model(
            M.params_from_numpy(cfg, cell["tree"], device="cpu"), mesh)
        batch = engine.batch_block(
            {k: torch.as_tensor(v) for k, v in cell["batch"].items()}, mesh)
        spec = C.cache_spec(cfg, cell["batch"]["tokens"].shape[0],
                            cell["max_len"], enc_len=cell["enc_len"],
                            dtype=torch.float32)
        cache = C.zeros(spec, "cpu", mesh=mesh)
        prompt = batch["tokens"].shape[1] + (cfg.vision_prefix_tokens or 0)
        rec, restore = _recording(M, L, fa)
        try:
            with sh.mesh_context(mesh):
                logits, cache = engine.prefill(model, cfg, batch, cache)
                steps = [logits]
                for i in range(cell["steps"]):
                    rec["step"] = i + 1
                    tok = torch.argmax(steps[-1], -1).to(torch.int32)[:, None]
                    logits, cache = engine.decode_step(model, cfg, tok,
                                                       prompt + i, cache)
                    steps.append(logits)
        finally:
            restore()
        names = {id(p): n for n, p in model.named_parameters()}
        out[cell["name"]] = dict(
            logits=[t.numpy() for t in steps],
            ids=torch.stack([torch.argmax(t, -1) for t in steps], 1)
            .numpy(),
            cache=[t.numpy().copy() for t in C.leaves(cache)],
            attend=rec["attend"], mlp=rec["mlp"],
            tp_leaves=sorted(M.tp_leaves(cfg, 2)),
            pinned_storage=sorted(
                n for n, p in model.named_parameters()
                if p.to_local().untyped_storage().nbytes()
                > p.to_local().numel() * p.to_local().element_size()),
            gathered_along_model=sorted(
                names[i] for i, (_, gathers) in
                engine._gather_plan(model).items()
                if any(a == "model" for _, a, _, _ in gathers)))
    _finish(rank, out_dir, out)
