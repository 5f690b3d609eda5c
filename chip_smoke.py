#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Builds both placement kernels from ``src/repro_torch/csrc`` with nvcc, then

  1. holds each kernel against its plain PyTorch version on the card at
     city_p468 (P=468, 1024 VSRs of 3 VMs) and times both, at the phase's
     shapes and at the shapes the main path gives them;
  2. runs the paper's quickstart (paper topology, 10 VSRs, cfn-milp)
     through ``CFNSession`` on the card, with the CDC/AF/MF baselines;
  3. runs cfn-milp at "standard" effort on city_p468 with 1024 VSRs.

Each phase prints one JSON line; then the kernels line (launches on the
phase-3 main path, errors and times), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
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


def phase_kernels(kernels: dict) -> None:
    """Phase 1: each kernel against its plain version at city_p468."""
    import torch
    from repro_torch.core import power, solvers
    from repro_torch.kernels import placement_power as pp, ref
    topo, vsrs = city_workload()
    prob = power.build_problem(topo, vsrs, device="cuda")
    P, R, V = prob.P, prob.R, prob.V
    operands = pp.pack_problem(prob)
    rng = np.random.default_rng(1)
    out = {"P": P, "N": prob.N, "K": prob.K, "R": R, "V": V}

    # ---- placement_power on 4096 random pinned candidates ---------------
    B = 4096
    Xb = torch.as_tensor(rng.integers(0, P, (B, R, V), dtype=np.int32),
                         device="cuda")
    Xf = power.apply_pins(prob, Xb).reshape(B, -1).contiguous()
    got = pp.placement_power_cuda(Xf, *operands)
    want = pp.placement_power_ref(Xf, *operands)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-2)
    f64 = np.array([ref.placement_objective_f64(prob, Xb[i])
                    for i in range(16)])
    np.testing.assert_allclose(got[:16, 0].cpu().numpy(), f64, rtol=2e-5,
                               atol=1e-2)
    out["placement_power_B4096"] = {
        "max_abs_err_vs_plain": float((got - want).abs().max()),
        "max_rel_err_vs_f64": float(np.max(np.abs(
            got[:16, 0].cpu().numpy() - f64) / np.abs(f64))),
        "ms": cuda_ms(lambda: pp.placement_power_cuda(Xf, *operands), 20),
        "plain_ms": cuda_ms(lambda: pp.placement_power_ref(Xf, *operands),
                            3),
        "bound_ms": placement_power_bound(Xf, operands)[0]}
    del got, want

    # ---- fused_anneal: 32 chains, shared proposals ----------------------
    aux = power.build_aux(prob)
    iot = solvers.fixed_layer(prob, topo, "iot").X
    C = 32

    def fused_args(T, seed):
        # every chain starts at the IoT first-fit placement and follows its
        # own proposal stream (objectives near 2e4 W: the float32 drift of
        # the carried objective stays inside the self-consistency check)
        r = np.random.default_rng(seed)
        Xc = power.apply_pins(prob, np.broadcast_to(iot, (C, R, V)))
        M = aux.free_flat.shape[0]
        fi = torch.as_tensor(r.integers(0, M, (C, T)), device="cuda")
        j = aux.free_flat[fi].to(torch.int32).contiguous()
        p = torch.as_tensor(r.integers(0, P, (C, T), dtype=np.int32),
                            device="cuda")
        u = torch.as_tensor(r.random((C, T), dtype=np.float32),
                            device="cuda")
        temps = torch.as_tensor((50.0 * (0.05 / 50.0) ** (
            np.arange(T) / (T - 1))).astype(np.float32), device="cuda")
        loads = [t.contiguous() for t in power.batched_hard_loads(prob, Xc)]
        _, _, F, _, route, pp_, nn_ = operands
        return (Xc.reshape(C, -1).contiguous(), j, p, u, temps,
                *pp.pack_aux(aux), *loads, F, route, pp_, nn_)

    D = int(aux.inc_h.shape[1])
    for T in (256, 4000):
        args = fused_args(T, seed=T)
        bk, sk = pp.fused_anneal_cuda(*args)
        rows_read = torch.zeros(P * P, dtype=torch.bool, device="cuda")
        t0 = time.perf_counter()
        br, sr = pp.fused_anneal_ref(*args, rows_read=rows_read)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for bX, st in ((bk, sk), (br, sr)):
            exact = power.objective_batch(prob, bX.reshape(C, R, V))
            torch.testing.assert_close(st[:, 0], exact, rtol=1e-5, atol=5e-2)
        err = float((sk[:, 0].min() - sr[:, 0].min()).abs())
        check(err <= 5e-2, f"fused_anneal T={T}: best {float(sk[:, 0].min())}"
                           f" vs plain {float(sr[:, 0].min())}")
        rec = {"min_best": float(sk[:, 0].min()),
               "min_best_abs_err_vs_plain": err,
               "chains_equal_to_plain": int((bk == br).all(1).sum()),
               "ms": cuda_ms(lambda: pp.fused_anneal_cuda(*args),
                             10 if T == 256 else 5),
               "plain_ms": plain_s * 1e3}
        rec["bound_ms"], rec["bound_by"] = fused_anneal_bound(
            args, rows_read, D)
        out[f"fused_anneal_C32_T{T}"] = rec
        if T == 4000:   # the main path's shape: 32 chains x 4000 steps
            kernels["fused_anneal"].update(
                max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"])
            # the main path re-scores the 32 chains' best placements
            Xm = bk.contiguous()
            got = pp.placement_power_cuda(Xm, *operands)
            want = pp.placement_power_ref(Xm, *operands)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-2)
            b_ms, b_by = placement_power_bound(Xm, operands)
            kernels["placement_power"].update(
                max_abs_err=float((got - want).abs().max()),
                ms=cuda_ms(lambda: pp.placement_power_cuda(Xm, *operands),
                           50),
                plain_ms=cuda_ms(
                    lambda: pp.placement_power_ref(Xm, *operands), 10),
                bound_ms=b_ms, bound_by=b_by)
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
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
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
    }
    phase_kernels(kernels)
    phase_paper()
    launches = phase_city()
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
        rec["library_ms"] = None   # no single PyTorch call computes either
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
