#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's kernels from ``src/repro_torch/csrc`` with nvcc (one
nvcc per source, in parallel), then

  1. holds each placement kernel against its plain PyTorch version on the
     card at city_p468 (P=468, 1024 VSRs of 3 VMs): placement_power at
     B = 1, 32, 33, 300, 4096 and the main path's re-score (B = 32), also
     against the float64 oracle; fused_anneal at C = 1, 5, 33, 141 chains and
     T = 1, 300 steps, on star VSRs (140 route slots), and at the main
     path's 32 chains x 4000 steps (every chain's best placement equal to
     the plain version's at T = 256 and below), and T = 12000 (the "high"
     effort) self-consistent; times each at the main path's shapes as a
     CUDA-graph replay (device time) and with CUDA events;
  2. runs the paper's quickstart (paper topology, 10 VSRs, cfn-milp)
     through ``CFNSession`` on the card, with the CDC/AF/MF baselines;
  3. runs cfn-milp at "standard" effort on city_p468 with 1024 VSRs;
  4. holds each flash-attention kernel (wgmma prefill, split-KV decode,
     SIMT) against its plain version and the reference's arithmetic on the
     reference's test shapes, their decode steps and more wgmma shapes,
     and at the serving path's prefill and decode shapes; times each new
     kernel there in turns with the SIMT kernel, beside SDPA (timed only,
     as a yardstick), and counts the wgmma kernel's tensor-core (HGMMA)
     and TMA (UTMALDG) instructions in its SASS;
  5. serves qwen3-4b at full width and depth (random bf16 weights from a
     seed) for 8 requests of 1024 prompt tokens and 32 generated tokens,
     checks that its 36 prefill attention calls went through the wgmma
     kernel and its 1116 decode calls through the split-KV kernel, checks
     cached decode against the forward pass, and places the served model
     on the datacenter CFN.

Each phase prints one JSON line; then the kernels line (launches on the
main paths: the placement kernels' in phase 3, the flash kernels' in
phase 5; errors and times), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
process exits non-zero.  Needs one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# float32 rate outside the tensor cores, the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float,
             flop_per_s: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def placement_power_bound(Xf, operands):
    """Least time of one placement_power call on these inputs: each input
    read once (of the route table, the rows the links use), each output
    written once; operations = one add per VM, two per link, one per route
    id walked, and ~16 / ~10 per processing / network node's terms."""
    link_src, link_dst, F, H, route, pp_, nn_ = operands
    B, J = Xf.shape
    L, P, N, K = H.shape[0], pp_.shape[1], nn_.shape[1], route.shape[1]
    a, b = Xf[:, link_src.long()].long(), Xf[:, link_dst.long()].long()
    pair = (a * P + b)[a != b]
    rows = int(pair.unique().numel())
    ids = int((route < N).sum(1)[pair].sum())
    n_bytes = 4 * (Xf.numel() + 3 * L + J + rows * K + pp_.numel()
                   + nn_.numel() + 4 * B)
    n_ops = B * (J + 2 * L + 16 * P + 10 * N) + ids
    return bound_ms(n_bytes, n_ops)


def _attended(q_pos, kv_pos):
    """[Sq, Skv] bool: the causal pairs some query attends (kv position
    >= 0 and <= the query's)."""
    rel = q_pos[:, None].long() - kv_pos[None, :].long()
    return (kv_pos >= 0)[None, :] & (rel >= 0)


def flash_attention_ops(q, k, v, q_pos, kv_pos) -> float:
    """Operations of one causal flash-attention call on these inputs: the
    two products, 2 * (D + Dv) per unmasked (query head, kv slot) pair."""
    B, _, H, D = q.shape
    pairs = int(_attended(q_pos, kv_pos).sum())
    return 2.0 * (D + v.shape[-1]) * pairs * B * H


def flash_attention_bound(q, k, v, q_pos, kv_pos):
    """Least time of one causal flash-attention call on these inputs: q
    and both position vectors read once, the K/V rows of the slots some
    query attends read once (an unwritten cache slot, position -1, never
    affects the output, so a kernel need not read it), the output written
    once; against ``flash_attention_ops`` at the bf16 dense tensor-core
    rate."""
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    slots = int(_attended(q_pos, kv_pos).any(0).sum())
    n_bytes = (q.element_size() * (q.numel() + B * Sq * H * Dv
                                   + B * slots * KH * (D + Dv))
               + 4 * (q_pos.numel() + kv_pos.numel()))
    return bound_ms(n_bytes, flash_attention_ops(q, k, v, q_pos, kv_pos),
                    BF16_FLOP_PER_S)


def fused_anneal_bound(args, rows_read, D):
    """Least time of one fused_anneal call: each input read once (of the
    route table, the rows the chains' steps read), each output written
    once; ~12 operations per touched route slot and ~80 per step for the
    processing terms and the Metropolis test."""
    (X, j, p, u, temps, io, ih, is_, om, th, lm, ob, F, route, pp_,
     nn_) = args
    C, T = j.shape
    K = route.shape[1]
    n_in = sum(t.numel() for t in (X, j, p, u, temps, io, ih, is_, om, th,
                                   lm, ob, F, pp_, nn_))
    n_bytes = 4 * (n_in + int(rows_read.sum()) * K + X.numel() + 2 * C)
    n_ops = C * T * (12 * 2 * D * K + 80)
    return bound_ms(n_bytes, n_ops)


def city_workload():
    """city_p468 with 1024 VSRs of 3 VMs, sources 64 IoT nodes (seed 0)."""
    from repro_torch.core import topology, vsr
    topo = topology.city_scale(n_olt=16, onus_per_olt=4, iot_per_onu=7)
    rng = np.random.default_rng(0)
    sources = rng.choice(topo.layer_indices("iot"), size=64, replace=False)
    return topo, vsr.random_vsrs(1024, rng=rng, n_vms=3,
                                 source_nodes=sources)


def ptxas_usage(log: str) -> list:
    """Registers and spill bytes of each entry function in an nvcc
    ``-Xptxas -v`` log: [{function, registers, spill_stores, spill_loads}],
    the function as "name<template args>" from its mangled name."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d+([a-z_]+_kernel)"
                      r"(I((?:Li-?\d+E)+)E)?", line)
        if m:
            args = re.findall(r"Li(-?\d+)E", m.group(3) or "")
            out.append({"function": m.group(1) + (
                f"<{', '.join(args)}>" if args else "")})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def timed_pair(launch, reps: int) -> dict:
    """``ms``: one call as a CUDA graph replays it (the device time);
    ``event_ms``: CUDA events around one call (its host cost included)."""
    return {"ms": graph_ms(launch, reps), "event_ms": cuda_ms(launch, reps)}


def phase_kernels(kernels: dict) -> None:
    """Phase 1: each placement kernel against its plain version at
    city_p468, at the main path's shapes and at the shapes its design has
    to take (cluster sizes 8, 4-8 and 1; chain counts that do not fill a
    block; one step; a star VSR's 140 route slots)."""
    import torch
    from repro_torch.core import power, solvers, topology, vsr
    from repro_torch.kernels import _build, placement_power as pp, ref
    topo, vsrs = city_workload()
    prob = power.build_problem(topo, vsrs, device="cuda")
    P, R, V = prob.P, prob.R, prob.V
    operands = pp.pack_problem(prob)
    rng = np.random.default_rng(1)
    out = {"P": P, "N": prob.N, "K": prob.K, "R": R, "V": V}

    def held_power(Xf, n_f64=0):
        """placement_power on Xf against its plain version (rtol 2e-5,
        atol 1e-2) and, on its first n_f64 rows, the float64 oracle."""
        got = pp.placement_power_cuda(Xf, *operands)
        want = pp.placement_power_ref(Xf, *operands)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-2)
        rec = {"cluster_size": pp.placement_power_cluster_size(Xf.shape[0]),
               "max_abs_err_vs_plain": float((got - want).abs().max())}
        if n_f64:
            Xr = Xf[:n_f64].reshape(n_f64, R, V)
            f64 = np.array([ref.placement_objective_f64(prob, X)
                            for X in Xr])
            np.testing.assert_allclose(got[:n_f64, 0].cpu().numpy(), f64,
                                       rtol=2e-5, atol=1e-2)
            rec["max_rel_err_vs_f64"] = float(np.max(np.abs(
                got[:n_f64, 0].cpu().numpy() - f64) / np.abs(f64)))
        return rec

    def timed_power(Xf):
        res = torch.empty((Xf.shape[0], 4), device="cuda")
        rec = timed_pair(lambda: pp.placement_power_launch(res, Xf,
                                                           *operands), 50)
        rec["plain_ms"] = cuda_ms(lambda: pp.placement_power_ref(
            Xf, *operands), 5)
        rec["bound_ms"], rec["bound_by"] = placement_power_bound(Xf,
                                                                 operands)
        return rec

    # ---- placement_power on random pinned candidates ---------------------
    for B in (1, 32, 33, 300, 4096):
        Xb = torch.as_tensor(rng.integers(0, P, (B, R, V), dtype=np.int32),
                             device="cuda")
        Xf = power.apply_pins(prob, Xb).reshape(B, -1).contiguous()
        rec = held_power(Xf, n_f64=16 if B == 4096 else 0)
        check((rec["cluster_size"] > 1) == (B <= 132),
              f"placement_power B={B}: cluster size {rec['cluster_size']}")
        if B == 4096:
            rec.update(timed_power(Xf))
        out[f"placement_power_B{B}"] = rec

    # ---- fused_anneal: chains from the IoT first-fit placement ----------
    def fused_args(problem, C, T, seed, t_hi=50.0):
        # every chain starts at the IoT first-fit placement and follows its
        # own proposal stream (objectives near 2e4 W: the float32 drift of
        # the carried objective stays inside the self-consistency check)
        r = np.random.default_rng(seed)
        aux = power.build_aux(problem)
        iot = solvers.fixed_layer(problem, topo, "iot").X
        Xc = power.apply_pins(problem, np.broadcast_to(
            iot, (C, problem.R, problem.V)))
        fi = torch.as_tensor(r.integers(0, aux.free_flat.shape[0], (C, T)),
                             device="cuda")
        j = aux.free_flat[fi].to(torch.int32).contiguous()
        p = torch.as_tensor(r.integers(0, problem.P, (C, T),
                                       dtype=np.int32), device="cuda")
        u = torch.as_tensor(r.random((C, T), dtype=np.float32),
                            device="cuda")
        temps = torch.as_tensor((t_hi * (0.05 / t_hi) ** (
            np.arange(T) / max(1, T - 1))).astype(np.float32),
            device="cuda")
        loads = [t.contiguous() for t in power.batched_hard_loads(problem,
                                                                  Xc)]
        _, _, F, _, route, pp_, nn_ = pp.pack_problem(problem)
        return (Xc.reshape(C, -1).contiguous(), j, p, u, temps,
                *pp.pack_aux(aux), *loads, F, route, pp_, nn_)

    def self_consistent(problem, bX, st, what):
        C = bX.shape[0]
        exact = power.objective_batch(problem, bX.reshape(C, problem.R,
                                                          problem.V))
        err = float((st[:, 0] - exact).abs().max())
        torch.testing.assert_close(st[:, 0], exact, rtol=1e-5, atol=5e-2,
                                   msg=f"fused_anneal {what}: best is not "
                                       f"the objective of best X")
        return err

    def held_anneal(problem, args, what, every_chain=True, rows_read=None):
        """The kernel's chains against its plain version's: best == exact
        objective of best X, best within 5e-2 of the plain version's; with
        every_chain, each chain's best placement equal to the plain's.
        rows_read, if given, is marked with the route rows the plain
        version reads."""
        C = args[0].shape[0]
        bk, sk = pp.fused_anneal_cuda(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        br, sr = pp.fused_anneal_ref(*args, rows_read=rows_read)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = int((bk == br).all(1).sum())
        err = float((sk[:, 0].min() - sr[:, 0].min()).abs())
        check(err <= 5e-2, f"fused_anneal {what}: best "
                           f"{float(sk[:, 0].min())} vs plain "
                           f"{float(sr[:, 0].min())}")
        check(not every_chain or equal == C,
              f"fused_anneal {what}: {equal} of {C} chains equal the "
              f"plain version's")
        return {"chains": C, "chains_equal_to_plain": equal,
                "plain_ms": plain_ms, "min_best": float(sk[:, 0].min()),
                "min_best_abs_err_vs_plain": err,
                "self_consistency_err": self_consistent(problem, bk, sk,
                                                        what)}, bk

    D = int(power.build_aux(prob).inc_h.shape[1])
    for C in (1, 5, 33, 141):   # 141: two chains a block, one in the last
        for T in (1, 300):
            out[f"fused_anneal_C{C}_T{T}"] = held_anneal(
                prob, fused_args(prob, C, T, seed=C + T, t_hi=5.0),
                f"C={C} T={T}")[0]
    # star VSRs of 6 VMs: D = 5, M = 2 D K = 140 route slots (> 64)
    star = power.build_problem(topo, vsr.random_vsrs(
        128, rng=0, n_vms=6, source_nodes=range(64), topology="star"),
        device="cuda")
    args = fused_args(star, 8, 300, seed=3, t_hi=5.0)
    M = 2 * args[6].shape[1] * args[13].shape[1]
    check(M > 64, f"fused_anneal star: M = {M}")
    out["fused_anneal_star_C8_T300"] = {
        "route_slots": M, **held_anneal(star, args, "star")[0]}

    C = 32
    for T in (256, 4000, 12000):
        args = fused_args(prob, C, T, seed=T)
        st = torch.empty((C, 2), device="cuda")
        bX = torch.empty((C, R * V), dtype=torch.int32, device="cuda")
        if T == 12000:  # the "high" effort's schedule: self-consistency
            bk, sk = pp.fused_anneal_cuda(*args)
            rec = {"min_best": float(sk[:, 0].min()),
                   "self_consistency_err": self_consistent(prob, bk, sk,
                                                           f"T={T}")}
        else:
            rows_read = torch.zeros(P * P, dtype=torch.bool, device="cuda")
            rec, bk = held_anneal(prob, args, f"T={T}",
                                  every_chain=T == 256, rows_read=rows_read)
            rec["bound_ms"], rec["bound_by"] = fused_anneal_bound(
                args, rows_read, D)
        rec.update(timed_pair(lambda: pp.fused_anneal_launch(bX, st, *args),
                              10 if T == 256 else 3))
        rec["us_per_step"] = rec["ms"] / T * 1e3
        out[f"fused_anneal_C32_T{T}"] = rec
        if T == 4000:   # the main path's shape: 32 chains x 4000 steps
            kernels["fused_anneal"].update(
                max_abs_err=rec["min_best_abs_err_vs_plain"], ms=rec["ms"],
                event_ms=rec["event_ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                us_per_step=rec["us_per_step"],
                chains_equal_to_plain=rec["chains_equal_to_plain"],
                shape="C=32 chains, T=4000 steps, city_p468",
                ptxas=ptxas_usage(_build.BUILD_LOG.get("fused_anneal", "")))
            # the main path re-scores the 32 chains' best placements
            Xm = bk.contiguous()
            rec_m = held_power(Xm, n_f64=C)
            rec_m.update(timed_power(Xm))
            out["placement_power_main_B32"] = rec_m
            kernels["placement_power"].update(
                max_abs_err=rec_m["max_abs_err_vs_plain"], ms=rec_m["ms"],
                event_ms=rec_m["event_ms"], plain_ms=rec_m["plain_ms"],
                bound_ms=rec_m["bound_ms"], bound_by=rec_m["bound_by"],
                cluster_size=rec_m["cluster_size"],
                shape="B=32 best placements of the anneal, city_p468",
                ptxas=ptxas_usage(_build.BUILD_LOG.get("placement_power",
                                                       "")))
    emit("kernels_vs_plain", **out)


def rescore(session, result) -> None:
    """The session's objective equals the placement_power re-score of its
    placement (rtol 1e-5, atol 5e-2)."""
    from repro_torch.kernels import ops
    got = float(ops.placement_objective(session.problem, result.X[None])[0, 0])
    check(abs(got - result.objective) <= 5e-2 + 1e-5 * abs(result.objective),
          f"re-score {got} vs objective {result.objective} ({result.method})")


def phase_paper() -> dict:
    """Phase 2: the quickstart on the card."""
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import topology, vsr
    from repro_torch.kernels import placement_power as pp
    topo = topology.paper_topology()
    vsrs = vsr.random_vsrs(10, rng=0, source_nodes=[0])
    spec = PlacementSpec(method="cfn-milp", bucket_rows=False,
                         bucket_cols=False)
    pp.reset_launches()
    t0 = time.perf_counter()
    session = CFNSession(topo, spec, device="cuda")
    result = session.solve(vsrs)
    seconds = time.perf_counter() - t0
    launches = dict(pp.LAUNCHES)
    check(result.feasible, "paper: cfn-milp placement is infeasible")
    for name, n in launches.items():
        check(n > 0, f"paper: kernel {name} was not launched")
    rescore(session, result)
    out = {"power_w": result.power, "objective": result.objective,
           "method": result.method, "seconds": seconds, "launches": launches}
    for pol in ("cdc", "af", "mf"):
        bs = CFNSession(topo, spec.replace(method=pol), device="cuda")
        base = bs.solve(vsrs)
        rescore(bs, base)
        check(result.power < base.power, f"paper: not below {pol}")
        out[f"{pol}_w"] = base.power
        out[f"saving_vs_{pol}"] = 1.0 - result.power / base.power
    check(0.19 <= out["saving_vs_cdc"] <= 0.91,
          f"paper: saving vs CDC {out['saving_vs_cdc']} outside 19-91%")
    emit("paper_quickstart", **out)
    return launches


def sweep_profile(prob, topo, n_pos: int = 256) -> dict:
    """Device activity of one coordinate sweep over ``n_pos`` free VM
    positions (the main path's hot loop): wall time per position, CUDA
    kernels per position and the share of the wall time the device was
    busy (summed kernel time; one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import power, solvers
    aux = power.build_aux(prob)
    state = power.init_state(prob, solvers.fixed_layer(prob, topo, "iot").X)
    pos = aux.free_pos.cpu().numpy()[:n_pos]
    solvers._sweep(prob, aux, state, pos[:16])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solvers._sweep(prob, aux, state, pos)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    return {"positions": len(pos), "ms_per_position": wall_s / len(pos) * 1e3,
            "kernels_per_position": len(kernels) / len(pos),
            "device_busy_share": busy_s / wall_s if kernels else None}


def phase_city() -> dict:
    """Phase 3: cfn-milp, standard effort, city_p468 with 1024 VSRs."""
    import torch
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import solvers
    from repro_torch.kernels import placement_power as pp
    topo, vsrs = city_workload()
    spec = PlacementSpec(method="cfn-milp", effort="standard",
                         bucket_rows=False, bucket_cols=False)
    stages = {"fixed_layer": [], "coordinate": [], "anneal": []}
    originals = {name: getattr(solvers, name) for name in stages}

    def timed(name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            stages[name].append(time.perf_counter() - t0)
            return res
        return run

    for name in stages:
        setattr(solvers, name, timed(name))
    try:
        pp.reset_launches()
        t0 = time.perf_counter()
        session = CFNSession(topo, spec, device="cuda")
        result = session.solve(vsrs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(pp.LAUNCHES)
    finally:
        for name, fn in originals.items():
            setattr(solvers, name, fn)
    for name, n in launches.items():
        check(n > 0, f"city: kernel {name} was not launched")
    cdc_session = CFNSession(topo, spec.replace(method="cdc"), device="cuda")
    cdc = cdc_session.solve(vsrs)
    check(result.objective <= cdc.objective,
          f"city: objective {result.objective} above CDC {cdc.objective}")
    rescore(session, result)
    rescore(cdc_session, cdc)
    profile = sweep_profile(session.problem, topo)
    emit("city_p468_R1024", power_w=result.power, objective=result.objective,
         feasible=result.feasible, method=result.method, cdc_w=cdc.power,
         saving_vs_cdc=1.0 - result.power / cdc.power,
         seconds_total=total, seconds_fixed_layer=stages["fixed_layer"],
         seconds_coordinate=stages["coordinate"],
         seconds_anneal=stages["anneal"], launches=launches,
         sweep_profile=profile)
    return launches


# the reference's kernel test shapes (tests/test_kernels.py:12-21):
# B, H, KH, Sq, Skv, D, causal, window, cap, dtype
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, None, "float32"),
    (1, 8, 8, 128, 256, 64, True, None, 50.0, "float32"),
    (2, 4, 1, 96, 160, 32, True, 32, None, "float32"),
    (1, 2, 2, 48, 80, 16, False, None, None, "float32"),
    (2, 8, 4, 200, 200, 64, True, 64, 30.0, "float32"),
    (1, 4, 2, 64, 128, 32, True, None, None, "bfloat16"),
    (2, 2, 2, 33, 65, 24, True, None, None, "float32"),
]
# the serving phase's shapes: 8 requests, qwen3-4b attention, a 1024-token
# prompt in a cache of max_len = 1024 + 32 + 8 slots
SERVE_B, SERVE_S, SERVE_GEN = 8, 1024, 32
SERVE_SMAX = SERVE_S + SERVE_GEN + 8


def graph_ms(fn, reps: int) -> float:
    """Milliseconds of one ``fn`` as a CUDA graph replays it: the device
    time of its launches without the host's cost of issuing them (a
    decode-sized call is shorter than that cost)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_call(q, k, v, q_pos, kv_pos):
    """SDPA on the same inputs (GQA, boolean mask from the positions): the
    library yardstick, timed here and used nowhere in the port."""
    import torch.nn.functional as F
    mask = (kv_pos[None, :] >= 0) & (q_pos[:, None] >= kv_pos[None, :])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def sass_counts(name: str) -> dict:
    """Instructions of the built library of csrc/<name>.cu, from
    ``cuobjdump -sass``: tensor-core products (HGMMA) and TMA loads
    (UTMALDG)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._library_path(
        name))], capture_output=True, text=True, check=True).stdout
    return {op: sass.count(op) for op in ("HGMMA.", "UTMALDG")}


# wgmma kernel shapes beside the reference's (which are float32, or bf16 at
# D = 32): B, H, KH, Sq, Skv, D, causal, window, cap -- bf16
WGMMA_CASES = [
    (1, 8, 8, 128, 256, 64, True, None, 50.0),    # G 1, softcap
    (2, 8, 4, 200, 200, 64, True, 64, 30.0),      # window and softcap
    (2, 10, 2, 33, 65, 64, True, 16, None),       # G 5 (hymba), ragged
    (1, 8, 2, 100, 80, 128, False, None, None),   # non-causal
    (1, 256, 1, 2, 70, 64, True, None, None),     # G > 128
]


def phase_flash(kernels: dict) -> None:
    """Phase 4: each flash-attention kernel against its plain version and
    the reference's ``attend`` arithmetic; the serving shapes timed in
    turns beside the SIMT kernel and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda shape, dt: torch.randn(shape, generator=gen, device=dev,
                                        dtype=torch.float32).to(dt)
    plains = {"wgmma": fa.tensor_core_attention_plain,
              "split_kv": fa.split_kv_attention_plain,
              "simt": fa.attention_plain}
    errs = {name: [] for name in fa.KERNELS}

    def held(q, k, v, qp, kp, tol, kernel=None, **kw):
        """Launch (``kernel`` or the dispatch's choice) and hold the result
        against the kernel's plain version and ``attention_plain``."""
        name = kernel or fa.choose_kernel(
            q.dtype, q.shape[-1], v.shape[-1],
            q.shape[1] * q.shape[2] // k.shape[2])
        got = fa.flash_attention_cuda(q, k, v, qp, kp, kernel=kernel,
                                      **kw).float()
        rec = {"kernel": name}
        for tag, plain in (("vs_plain", plains[name]),
                           ("vs_attention_plain", fa.attention_plain)):
            want = plain(q, k, v, q_positions=qp, kv_positions=kp, **kw)
            rec[tag] = float((got - want.to(q.dtype).float()).abs().max())
            check(rec[tag] <= tol, f"flash {name} {tuple(q.shape)}/"
                                   f"{tuple(k.shape)} {tag}: {rec[tag]}")
        errs[name].append(max(rec["vs_plain"], rec["vs_attention_plain"]))
        return rec

    out = {"cases": [], "wgmma_cases": [], "split_kv_cases": []}
    for B, H, KH, Sq, Skv, D, causal, window, cap, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        tol = 2e-2 if dtype == "bfloat16" else 2e-3
        k, v = rnd((B, Skv, KH, D), dt), rnd((B, Skv, KH, D), dt)
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        # as the reference's test runs it, through the dispatch
        q = rnd((B, Sq, H, D), dt)
        qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev)
        out["cases"].append({"shape": [B, H, KH, Sq, Skv, D], "dtype": dtype,
                             **held(q, k, v, qp, kp, tol, **kw)})
        # its decode step (the last position alone): the split-KV kernel
        q = rnd((B, 1, H, D), dt)
        qp = torch.tensor([Skv - 1], dtype=torch.int32, device=dev)
        out["split_kv_cases"].append(
            {"shape": [B, H, KH, 1, Skv, D], "dtype": dtype,
             **held(q, k, v, qp, kp, tol, kernel="split_kv", **kw)})
    for B, H, KH, Sq, Skv, D, causal, window, cap in WGMMA_CASES:
        bf = torch.bfloat16
        q, k, v = (rnd(s, bf) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                        (B, Skv, KH, D)))
        qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev)
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)
        out["wgmma_cases"].append(
            {"shape": [B, H, KH, Sq, Skv, D], "dtype": "bfloat16",
             **held(q, k, v, qp, kp, 2e-2, kernel="wgmma", causal=causal,
                    window=window, logit_cap=cap)})
    # q before every kv position: fully masked rows give 0, not NaN, in
    # every kernel
    out["fully_masked_max_abs"] = {}
    for name, dt, Sq in (("simt", torch.float32, 16),
                         ("wgmma", torch.bfloat16, 16),
                         ("split_kv", torch.float32, 2)):
        D = 16 if name == "simt" else 64
        q, k, v = (rnd(s, dt) for s in ((1, Sq, 2, D), (1, 200, 2, D),
                                        (1, 200, 2, D)))
        got = fa.flash_attention_cuda(
            q, k, v, torch.arange(-64, -64 + Sq, dtype=torch.int32,
                                  device=dev),
            torch.arange(200, dtype=torch.int32, device=dev), kernel=name)
        check(bool(torch.isfinite(got).all())
              and float(got.abs().max()) == 0.0,
              f"flash {name}: fully masked rows are not 0")
        out["fully_masked_max_abs"][name] = float(got.abs().max())

    # the serving path's shapes, positions as the ring-buffer cache holds
    # them: prefill writes slots 0-1023, decode then writes slot 1024.  Each
    # new kernel is timed in turns with the SIMT kernel on the same inputs
    # (SIMT, new, new, SIMT); "ms" are CUDA events around one call (the
    # host's issue cost included), "graph_ms" CUDA-graph replays (device
    # time alone)
    B, H, KH, D, S, Smax = SERVE_B, 32, 8, 128, SERVE_S, SERVE_SMAX
    bf = torch.bfloat16
    k, v = rnd((B, Smax, KH, D), bf), rnd((B, Smax, KH, D), bf)
    for name, Sq, written, kernel in (("prefill", S, S, "wgmma"),
                                      ("decode", 1, S + 1, "split_kv")):
        q = rnd((B, Sq, H, D), bf)
        qp = torch.arange(written - Sq, written, dtype=torch.int32,
                          device=dev)
        kp = torch.full((Smax,), -1, dtype=torch.int32, device=dev)
        kp[:written] = torch.arange(written, dtype=torch.int32, device=dev)
        check(fa.choose_kernel(bf, D, D, Sq * H // KH) == kernel,
              f"flash {name}: the dispatch does not choose {kernel}")
        # prefill: bf16 rounding of the early rows' large values sets the
        # limit; decode outputs average 1025 slots (|out| ~ 0.05), so a
        # limit of 2e-2 there would pass a kernel that dropped a slot
        tol = 2e-2 if name == "prefill" else 2e-3
        rec = {"shape": [B, H, KH, Sq, Smax, D], "kernel": kernel,
               kernel: held(q, k, v, qp, kp, tol),
               "simt": held(q, k, v, qp, kp, tol, kernel="simt")}
        reps = 20 if name == "prefill" else 200
        call = {kn: (lambda kn=kn: fa.flash_attention_cuda(
                    q, k, v, qp, kp, kernel=kn)) for kn in (kernel, "simt")}
        times = {kn: {"ms": [], "graph_ms": []} for kn in call}
        for kn in ("simt", kernel, kernel, "simt"):
            times[kn]["ms"].append(cuda_ms(call[kn], reps))
            times[kn]["graph_ms"].append(graph_ms(call[kn], reps))
        for kn in call:
            rec[kn].update(times[kn])
        sdpa = sdpa_call(q, k, v, qp, kp)
        rec["library_ms"] = cuda_ms(sdpa, reps)
        rec["library_graph_ms"] = graph_ms(sdpa, reps)
        rec["plain_ms"] = cuda_ms(lambda: plains[kernel](
            q, k, v, q_positions=qp, kv_positions=kp), 5)
        rec["simt_plain_ms"] = cuda_ms(lambda: fa.attention_plain(
            q, k, v, q_positions=qp, kv_positions=kp), 5)
        rec["bound_ms"], rec["bound_by"] = flash_attention_bound(
            q, k, v, qp, kp)
        n_ops = flash_attention_ops(q, k, v, qp, kp)
        for kn in call:
            best = min(rec[kn]["graph_ms"])
            rec[kn]["tflop_per_s"] = n_ops / (best * 1e-3) / 1e12
            check(max(rec[kn]["graph_ms"]) > 0, f"flash {name}: no time")
        check(max(rec[kernel]["graph_ms"]) < min(rec["simt"]["graph_ms"]),
              f"flash {name}: {kernel} not faster than the SIMT kernel")
        out[name] = rec

    # planted, at the decode shape of the loop's last pass: the slot decode
    # writes (position 1024) must reach the output; with its values at 4 it
    # moves outputs by ~4/1025 each, which the plain version without that
    # slot shows
    vp = v.clone()
    vp[:, S] = 4.0
    got = fa.flash_attention_cuda(q, k, vp, qp, kp).float()
    want = fa.attention_plain(q, k, vp, q_positions=qp, kv_positions=kp)
    kp_drop = kp.clone()
    kp_drop[S] = -1
    drop = fa.attention_plain(q, k, vp, q_positions=qp,
                              kv_positions=kp_drop)
    err = float((got - want.to(bf).float()).abs().max())
    gap = float((got - drop.to(bf).float()).abs().max())
    check(err <= 2e-3 and gap > 5e-3,
          f"flash decode, planted slot {S}: err {err}, gap without it {gap}")
    out["decode"]["planted_slot"] = {"max_abs_err": err,
                                     "max_abs_gap_without_slot": gap}
    out["sass_flash_attention_wgmma"] = sass_counts("flash_attention_wgmma")
    check(all(out["sass_flash_attention_wgmma"].values()),
          f"flash wgmma: SASS {out['sass_flash_attention_wgmma']}")
    for name, shape, kn in (("prefill", "prefill", "wgmma"),
                            ("decode", "decode", "split_kv"),
                            ("prefill", "prefill", "simt")):
        rec = out[name]
        kernels[f"flash_attention_{kn}"].update(
            max_abs_err=max(errs[kn]), ms=min(rec[kn]["graph_ms"]),
            event_ms=min(rec[kn]["ms"]),
            plain_ms=rec["simt_plain_ms" if kn == "simt" else "plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_graph_ms"],
            shape=f"{shape} [B, H, KH, Sq, Skv, D] = {rec['shape']}, bf16")
    emit("flash_attention_vs_plain", **out)


def serve_profile(model, cfg, tokens, cache) -> dict:
    """Device activity of one prefill and one decode step of the serving
    path (under the profiler, whose own host cost is in the wall time):
    wall ms, CUDA kernels, the share of the wall time the device was busy
    (summed kernel time; one stream), the flash kernels' share of the
    device time (every kernel named flash_attention*: wgmma, split and
    combine, SIMT), and the five kernels that took most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine
    B, S = tokens.shape
    steps = {"prefill": lambda: engine.prefill(
                 model, cfg, {"tokens": tokens}, cache),
             "decode_step": lambda: engine.decode_step(
                 model, cfg, tokens[:, -1:], S + SERVE_GEN - 1, cache)}
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() * 1e-3)
        busy_ms = sum(sum(v) for v in by_name.values())
        flash_ms = sum(sum(v) for k, v in by_name.items()
                       if "flash_attention" in k)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
        out[name] = {
            "wall_ms": wall_s * 1e3,
            "kernels": sum(len(v) for v in by_name.values()),
            "device_busy_share": busy_ms / (wall_s * 1e3),
            "flash_share_of_device_time": (flash_ms / busy_ms if busy_ms
                                           else None),
            "top_kernels_ms": [[k[:80], sum(v), len(v)] for k, v in top]}
    return out


def phase_serve() -> dict:
    """Phase 5: serve qwen3-4b at full width and depth, then place it."""
    import torch
    from repro_torch import configs
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import topology, vsr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C, engine
    cfg = configs.get("qwen3-4b")
    B, S, GEN, dev = SERVE_B, SERVE_S, SERVE_GEN, "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32, device=dev)
    spec = C.cache_spec(cfg, B, SERVE_SMAX)

    # the main path as a user runs it: greedy_generate, synchronized only
    # around the whole call.  The first call is cold (cuBLAS picks its
    # kernels, the allocator grows); the second, on a fresh cache, is the
    # one timed for tokens/s and whose launches are counted
    for cold in (True, False):
        cache = None    # free the last call's cache before the fresh one
        cache = C.zeros(spec, device=dev)
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        seq, cache = engine.greedy_generate(model, cfg, {"tokens": tokens},
                                            cache, GEN)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        if cold:
            cold_s, cold_seq = total_s, seq
    launches = {kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                for kn in fa.KERNELS}
    calls = fa.LAUNCHES["flash_attention"]
    check(bool(torch.equal(cold_seq, seq)),
          "serve: two greedy_generate calls chose different ids")
    # every layer's prefill through the wgmma kernel, every decode step's
    # through the split-KV kernel, none through the SIMT kernel
    want = {"wgmma": cfg.n_layers, "split_kv": cfg.n_layers * (GEN - 1),
            "simt": 0}
    check(launches == want and calls == cfg.n_layers * GEN,
          f"serve: flash-attention launches {launches} of {calls} calls, "
          f"want {want}")
    check(tuple(seq.shape) == (B, GEN), f"serve: ids {tuple(seq.shape)}")
    peak = torch.cuda.max_memory_allocated()

    # a second pass, step by step on a fresh cache, synchronized around each
    # step for its time; every step's logits must be finite and its ids
    # those of the call above
    times = {"prefill": [], "decode_step": []}
    cache = C.zeros(spec, device=dev)
    finite, ids = True, []
    for i in range(GEN):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:
            logits, cache = engine.prefill(model, cfg, {"tokens": tokens},
                                           cache)
        else:
            logits, cache = engine.decode_step(model, cfg, ids[-1][:, None],
                                               S + i - 1, cache)
        torch.cuda.synchronize()
        times["prefill" if i == 0 else "decode_step"].append(
            time.perf_counter() - t)
        finite = finite and bool(torch.isfinite(logits).all())
        ids.append(torch.argmax(logits, dim=-1).to(torch.int32))
    check(finite, "serve: a logit is not finite")
    check(bool(torch.equal(torch.stack(ids, 1), seq)),
          "serve: the step-by-step pass chose other ids than greedy_generate")
    profile = serve_profile(model, cfg, tokens, cache)

    # cached decode of the last prompt token against the uncached forward
    h = M.forward_hidden(model, cfg, {"tokens": tokens})
    ref = M.logits_fn(model, cfg, h[:, -1:])[:, 0]
    del h
    cache = C.zeros(spec, device=dev)
    _, cache = engine.prefill(model, cfg, {"tokens": tokens[:, :-1]}, cache)
    got, _ = engine.decode_step(model, cfg, tokens[:, -1:], S - 1, cache)
    rel = float((got - ref).abs().max() / ref.abs().max())
    check(bool(torch.isfinite(got).all()) and rel < 3e-2,
          f"serve: cached decode vs forward rel {rel} (bf16 bound 3e-2)")
    del model, cache

    tok_s = B * GEN / total_s
    vsrs = vsr.from_architecture(cfg, tokens_per_s=tok_s, n_stages=4)
    spec_p = PlacementSpec(method="cfn-milp", bucket_rows=False,
                           bucket_cols=False)
    session = CFNSession(topology.datacenter_topology(), spec_p,
                         device=dev)
    result = session.solve(vsrs)
    rescore(session, result)
    sav = session.savings_vs_baseline("cdc")
    check(sav["saving_frac"] > 0.0,
          f"serve: no saving vs CDC ({sav['saving_frac']})")
    emit("serve_qwen3_4b", config=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=M.param_count(M.init_model(
             cfg, device="meta")),
         batch=B, prompt_len=S, gen=GEN, max_len=SERVE_SMAX,
         cache_bytes=C.cache_bytes(spec), init_s=init_s,
         prefill_s=times["prefill"][0],
         decode_ms_per_step=1e3 * statistics.mean(times["decode_step"]),
         decode_ms_median=1e3 * statistics.median(times["decode_step"]),
         cold_total_s=cold_s, total_s=total_s, tokens_per_s=tok_s,
         max_memory_allocated=peak, first_row_ids=seq[0].tolist(),
         flash_launches=calls,
         flash_launches_by_kernel=launches, decode_vs_forward_rel=rel,
         profile=profile,
         vsr_F=vsrs.F[0].tolist(), placement_power_w=result.power,
         placement_feasible=result.feasible, placement_method=result.method,
         cdc_w=sav["baseline_w"], saving_vs_cdc=sav["saving_frac"])
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit("setup", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.splitlines()[-1],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    build_s = _build.build_all()
    emit("build", seconds=build_s, ptxas={
        name: [ln.strip()[:160] for ln in log.splitlines()
               if "registers" in ln or "Performance Loss" in ln]
        for name, log in _build.BUILD_LOG.items()})

    kernels = {
        "placement_power": {
            "name": "placement_power", "route": "cuda",
            "source": "src/repro_torch/csrc/placement_power.cu",
            "replaces": "src/repro/kernels/placement_power.py:160"},
        "fused_anneal": {
            "name": "fused_anneal", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_anneal.cu",
            "replaces": "src/repro/kernels/placement_power.py:377"},
        **{f"flash_attention_{kn}": {
            "name": f"flash_attention_{kn}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81"}
           for kn, src in (("wgmma", "flash_attention_wgmma"),
                           ("split_kv", "flash_attention_decode"),
                           ("simt", "flash_attention"))},
    }
    phase_kernels(kernels)
    phase_paper()
    launches = phase_city()
    for name in ("placement_power", "fused_anneal"):
        kernels[name]["launches"] = launches[name]
        # no single PyTorch call computes either placement function
        kernels[name]["library_ms"] = None
    phase_flash(kernels)
    for kn, n in phase_serve().items():
        kernels[f"flash_attention_{kn}"]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
