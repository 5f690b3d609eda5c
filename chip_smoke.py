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
     effort) self-consistent; the global-state variant at 9000 VSRs
     (C = 5, 33 x T = 1, 300, every chain equal to the plain version's;
     C = 32 x T = 4000); times each at the main path's shapes as a
     CUDA-graph replay (device time) and with CUDA events;
  2. runs the paper's quickstart (paper topology, 10 VSRs, cfn-milp)
     through ``CFNSession`` on the card, with the CDC/AF/MF baselines;
  3. runs cfn-milp at "standard" effort on city_p468 with 1024 VSRs, then
     builds the result's loads 16 times, each bit-equal to the first (the
     order-fixed sums; beside them the atomic sums, timed and counted);
  3a. runs the paper's drivers (``repro_torch.paper_figures``: fig3 at
     1..20 VSRs, fig4, solver_gap) on the card: cfn-milp's gap 0 on the
     five solver_gap seeds, fig3's savings in the paper's 19%-91% band;
  3b. runs ``relax`` at city_p468 (128 VSRs), its loss falling, beside
     coordinate from CDC;
  3c. runs the default anneal on 9000 VSRs (J = 27000 VMs, past the
     shared-memory cap) through the fused kernel's global-state variant,
     and on star VSRs with D = 33 links, where it takes the delta backend;
  3d. replays churn through the online engine (``CFNSession``) at
     city_p468: 64 services bootstrapped, then two departures and
     arrivals, each an incremental re-solve re-scored by placement_power,
     the fourth with the periodic full solve; each event held to the
     float64 oracle and to its warm start, its seconds split by stage; a
     second session from the same generator seed bootstraps the same
     placement and objective bit for bit (the ``determinism`` line);
  3e. replays a flash crowd there in waves on 3d's bootstrap placement,
     adopted (two ticks of 8 departures
     and 8 arrivals, each one batched re-solve re-scored by
     placement_power, then an amortized defrag tick over 8 rows), each
     wave held to the oracle and its warm start, its seconds split by
     stage beside 3d's per event; then the admission plane on 16 of
     those services, placed by a solve of their own and adopted: a
     zero-watt brownout, a wave whose class-0 arrival
     preempts the two class-1 services, the queue's order and counters,
     and its drain when the brownout ends;
  3f. drives the fault plane there with a ``PlacementMonitor``: on the
     adopted 3e bootstrap placement, a hosting node's, the busiest
     network element's, a source's and an idle node's failure, then their
     recoveries, one of them with the periodic full solve on the degraded
     problem; then a rack storm of one node around a flash-crowd wave,
     replayed in waves; each event held to the float64 oracle on the
     degraded problem, no VM on a dead node, no service lost;
  3g. runs the federation (``FederatedSession``) at four city-scale
     regions (merged P = 1864): 512 VSRs through the region-batched
     solve (lockstep sweeps and anneal vmapped over the regions), its
     seconds split and one lockstep position profiled, the exact fleet
     accounting held to the float64 oracle of the merged placement; then,
     at 4 live services a region, the coordinator's budget migration,
     adds, removes, a wave, the regional defrag (fused_anneal), a region's
     failure and recovery, a region brownout and the scheduler on the
     federation, every call held to the oracles and the fleet invariants,
     a ``Telemetry`` attached: every fleet ledger sample's regions plus
     inter-region equal to its total;
  3h. measures the telemetry plane's overhead (the JAX package's recipe,
     ``benchmarks/kernel_bench.py::telemetry_overhead``, at phase 3e's
     size): 64 services adopted from a least-loaded placement, one warm and
     four measured replace waves of 16 events, four fresh engines from one
     generator seed in turns, telemetry off, on, off, on (spans, ledger,
     attribution, a JSONL stream); placements off and on byte-equal, the
     stream valid, the attribution agreeing with the live counters;
  4. holds each flash-attention kernel (wgmma prefill, split-KV decode,
     SIMT) against its plain version and the reference's arithmetic on the
     reference's test shapes, their decode steps and more wgmma shapes
     (head dims 120, 32, (48, 32) and (128, 64) in zero-padded boxes, a
     partial kv tile, fully masked rows),
     and at the serving path's prefill and decode shapes, at hymba-1.5b's
     (G 5, D 64, a 1024-slot window ring: the prefill, and the decode
     step that wraps to slot 0), at phase 5d's (whisper-base's
     non-causal encoder and cross-attention prefill on the wgmma kernel,
     its non-causal cross-attention decode on split-KV, internvl2-2b's
     prefill), and deepseek-v2's
     MLA prefill shape (D 192, Dv 128, 128 heads) and h2o-danube-3-4b's
     (D 120, 32 / 8 heads), where the dispatch takes the wgmma kernel;
     times each new kernel there in turns with the SIMT kernel, beside
     SDPA (timed only, as a yardstick), the SIMT kernel at qwen3-4b's
     prefill shape in float32 (its own role since the wgmma kernel took
     every bf16 shape of the configurations) beside SDPA in float32, and
     counts the wgmma kernel's tensor-core (HGMMA) and TMA (UTMALDG)
     instructions in its SASS; holds the split-KV kernel's lse output
     (sharded serving's decode) against its plain version at qwen3-4b's
     decode shape and at 5g's (96 heads on 8 kv heads), and times the
     launch with and without it at both;
  5. serves qwen3-4b at full width and depth (random bf16 weights from a
     seed) for 8 requests of 1024 prompt tokens and 32 generated tokens,
     checks that its 36 prefill attention calls went through the wgmma
     kernel and its 1116 decode calls through the split-KV kernel, checks
     cached decode against the forward pass, and places the served model
     on the datacenter CFN, directly and through the energy-aware
     scheduler (a ``Telemetry`` attached: the ledger's joules by tier)
     beside an olmoe-1b-7b service; then prefills the smoke gemma2-27b 20
     times with 88 tokens, past its 64-slot local ring: every run's cache
     byte-equal to the first's, every ring slot's K/V those of the
     position its pos_ids names;
  5b. serves the MoE family through the same protocol: olmoe-1b-7b at full
     width and depth (64 experts, top-8; 16 wgmma prefill and 496 split-KV
     decode calls, checked) and deepseek-v2-236b at full width, 4 of its
     60 layers (MLA and 160 routed + 2 shared experts, top-6; 4 wgmma
     prefill calls at D 192 / Dv 128, the absorbed decode calling no
     kernel, checked); deepseek's first MLA layer's prefill attention on
     the wgmma kernel against the SIMT kernel forced; the first MoE
     layer's dropped (token, k) share; cached decode against the forward
     pass in float32 at the lossless capacity factor (the reference's own
     test's setting; its attention on the SIMT kernel, counted apart);
     then places the served olmoe on the datacenter CFN;
  5c. serves the recurrent families through the same protocol, at full
     width and depth: xlstm-1.3b (42 mLSTM and 6 sLSTM blocks; no flash
     call, checked; its state's bytes independent of max_len, checked)
     and hymba-1.5b (attention beside mamba in every layer; 32 wgmma
     prefill and 992 split-KV decode calls, 0 SIMT, checked; the first
     decode step wraps its 1024-slot windowed ring buffers); cached decode
     at position 1024, past the window, against the forward pass over
     1025 tokens in float32 on 2 prompts (attention on the SIMT kernel
     and split-KV, counted apart; xlstm, which has no window, at position
     512); places each served model on the datacenter CFN;
  5d. serves whisper-base (6 encoder and 6 decoder layers, 1500 frames,
     a 187-token decoder prompt; 18 wgmma prefill calls -- encoder,
     self- and cross-attention -- and 372 split-KV decode calls, 0 SIMT,
     checked; its cross cache unchanged by the decode steps, checked) and
     internvl2-2b (256 patches before 768 text tokens; 24 wgmma and 744
     split-KV calls, checked) at full width and depth through the same
     protocol; cached decode against the forward pass in bf16 and in
     float32 on 2 prompts (both checked); places each served model on
     the datacenter CFN, both placement kernels launched;
  5e. serves h2o-danube-3-4b (24 layers, 32 / 8 heads of 120, a 4096-slot
     window) at full width and depth through the same protocol: 24 wgmma
     prefill calls (head dim 120 in zero-padded boxes) and 744 split-KV
     decode calls, 0 SIMT, checked; cached decode against the forward pass
     in bf16 and in float32 on 2 prompts (both checked); places it on the
     datacenter CFN, both placement kernels launched;
  5f. serves gemma2-27b (46 layers alternating local and global
     attention, 28.41 B parameters, 56.8 GB in bf16) at full width and
     depth through the same protocol, every earlier model freed: 46 wgmma
     prefill and 1426 split-KV decode calls, 0 SIMT, checked; cached
     decode against the forward pass in bf16 (checked); in float32 at 2
     layers (one local, one global) on a prompt of 4160 tokens, the
     4096-slot local ring filled by the prefill and wrapped by 64 decode
     steps (checked); the peak under 90% of the card; places it on the
     datacenter CFN, both placement kernels launched;
  5g. serves command-r-plus-104b at full width and 19 of its 64 layers
     (the deepest the dry run puts under 90% of the card, checked against
     20) through the same protocol, first on the plain engine, then
     through the sharded entry on a ("data", "model") (1, 1) NCCL mesh
     over the same weights (sharded in place, no copy, checked): the
     cache the rank's blocks, every decode attention through split-KV's
     lse output and the log-sum-exp combine; ids equal and logits
     bit-equal to the plain run's (checked), 19 wgmma and 589 split-KV
     launches in each run (the sharded run's all with lse), cached decode
     against the forward pass in bf16 and in float32 at 2 layers, the
     peak under 90% of the card (all checked);
  5h. serves tensor-parallel on two ranks of the one card: two spawned
     processes on cuda:0 in gloo groups (NCCL puts no two ranks of a
     group on one device), a ("data", "model") (1, 2) mesh: qwen3-4b at
     full width and depth (its heads, kv heads, ffn columns and
     vocabulary split across the two ranks) and hymba-1.5b at full width
     and 2 of 32 layers (25 heads: its prefill splits the query rows),
     8 prompts of 1024 tokens, the weights a plain run in this process
     drew: each rank's logits at every step (prefill, decode
     teacher-forced on the plain run's ids) within 3e-2 of the largest
     plain logit in bf16 and 1e-4 in float32 at 2 layers, the ranks
     equal, each rank's flash launches and attention shapes (16 / 4
     heads a rank at qwen3-4b's prefill, 512 query rows at hymba's; all
     heads over the rank's half of the slots at decode) checked; where
     greedy ids part, the top-2 margins, prefill s and decode ms a step
     beside the plain run's, each rank's prefill peak against the dry
     run's at {"data": 1, "model": 2}, recorded;
  6. trains on the card: (6a) the differentiable attention (the kernel's
     forward, the reference's chunked backward in plain torch) against
     the same function with the plain forward and against float32
     autograd through the plain version, on the wgmma kernel at D 128
     (qwen3-4b's heads), 120 (h2o-danube-3-4b's), 64 and 32 and on the
     SIMT kernel in float32, with windows, softcaps and dead kv slots, and
     one attention block at qwen3-4b's and at h2o-danube-3-4b's full
     width, its wq / wk / wv gradients non-zero; (6b)
     qwen3-4b at full width and a cut depth (float32 masters, a bf16
     compute copy, remat "full"), 8 steps of 4 x 4096 tokens as 2
     microbatches on one batch, the loss falling, every gradient finite,
     each step split into forward, backward (the attention's backward
     apart) and optimizer with CUDA events; (6c) the train CLI
     (``repro_torch.launch.train``) on the smoke configuration with
     ``--report-energy``: the loss improving, the trained architecture
     placed on the datacenter CFN;
  7. trains distributed and resiliently on a ("pod", "data", "model")
     (1, 1, 1) mesh over NCCL: (7a) qwen3-4b at full width and 2 layers,
     its state sharded by each leaf's logical axes, 2 steps of 2 x 4096
     tokens with and without the int8 pod compression, against the plain
     step (losses and every leaf), each step's seconds; (7b) one
     checkpoint of that state (~11.8 GB): bytes, free space, the
     caller's stall in save(), the write's and the restore's seconds, the
     restored state's next step equal to the continuing one's; (7c)
     ResilientTrainer on the smoke configuration, a clean run and one
     failing at step 6 (one restart, the replayed losses equal), and the
     train CLI with ``--ckpt-dir`` resuming a run;
  8. runs the dry run (``repro_torch.launch.dryrun.run_cell``, on the
     meta device: no card work) on a (1, 1) mesh of sizes for
     gemma2-27b's prefill and decode at 5f's shapes and qwen3-4b's train
     step at 6b's, and holds it against 5f's and 6b's measurements: the
     predicted peak within 15% of the measured one for the prefill and the
     train step, and their temporaries (the peak above what was live
     before the step) within 5%, every cell fitting the card (checked);
     the same for command-r-plus-104b's prefill at 5g's depth against
     5g's sharded run (a serving cell traces the rank's sharded step);
     the roofline's bound against the measured seconds, and the model
     FLOPs' share of the card's bf16 peak (MFU), printed;
  9. holds the static-analysis plane (``repro_torch.analysis``) against
     the card: (9a) the port's linter (``python -m repro_torch.analysis
     --baseline analysis/baseline-torch.json src/repro_torch
     chip_smoke.py``) exits 0 with no finding; (9b) for every CUDA
     template this run launched, at every launched shape, the Python
     shared-memory mirror equals what the ``.cu`` query says its launcher
     requests, static plus dynamic bytes fit the card's opt-in limit per
     block, which equals ``SMEM_PER_BLOCK``; (9c) every entry 3h's
     telemetry recorded is within its CFN108 static bound, and a fresh
     two-bucket churn wave on the card (the fingerprint cache cleared)
     counts within its scenario bounds and within 2x of them.

Each phase prints one JSON line (3a-3f also their seconds; every line
its seconds since the start, ``at_s``); then the
kernels line (launches on the main paths: the placement kernels' in phase
3 and, as ``launches_churn`` / ``launches_waves`` / ``launches_faults`` /
``launches_federation`` / ``launches_telemetry``, in phases 3d / 3e / 3f /
3g / 3h, the global anneal
variant's in phase 3c, the flash
kernels' in phase 5, and every kernel's in phases 5b, 5c, 5d, 5e and 5f
as ``launches_moe`` / ``launches_ssm`` / ``launches_encdec`` /
``launches_danube`` / ``launches_gemma2`` (the placement kernels' in the
served models' placements) and, for the flash kernels,
``launches_moe_float32`` / ``launches_ssm_float32`` /
``launches_encdec_float32`` / ``launches_danube_float32`` /
``launches_gemma2_float32`` (the float32 checks), the flash kernels' in
phase 5g as ``launches_cmdr`` / ``launches_cmdr_sharded`` /
``launches_cmdr_float32``, the flash kernels' of rank 0 in phase 5h as
``launches_tensor_parallel`` / ``launches_tensor_parallel_float32``, and
as
``launches_train`` the flash kernels' in phases 6b and 6c and the
placement kernels' in 6c, and as ``launches_parallel`` the flash
kernels' in phase 7;
errors and times), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
process exits non-zero.  Needs one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the script's start: each phase line carries its seconds since (``at_s``),
# so the phases without a seconds field of their own are timed too
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# float32 rate outside the tensor cores, the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T0}), flush=True)


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


def _attended(q_pos, kv_pos, causal=True):
    """[Sq, Skv] bool: the pairs some query attends: kv position >= 0 and,
    with ``causal``, <= the query's."""
    ok = (kv_pos >= 0)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        ok = ok & (q_pos[:, None].long() >= kv_pos[None, :].long())
    return ok


def flash_attention_ops(q, k, v, q_pos, kv_pos, causal=True) -> float:
    """Operations of one flash-attention call on these inputs: the two
    products, 2 * (D + Dv) per unmasked (query head, kv slot) pair."""
    B, _, H, D = q.shape
    pairs = int(_attended(q_pos, kv_pos, causal).sum())
    return 2.0 * (D + v.shape[-1]) * pairs * B * H


def flash_attention_bound(q, k, v, q_pos, kv_pos, causal=True):
    """Least time of one flash-attention call on these inputs: q and both
    position vectors read once, the K/V rows of the slots some query
    attends read once (an unwritten cache slot, position -1, never
    affects the output, so a kernel need not read it), the output written
    once; against ``flash_attention_ops`` at the bf16 dense tensor-core
    rate (float32 inputs: the float32 rate outside the tensor cores)."""
    B, Sq, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    slots = int(_attended(q_pos, kv_pos, causal).any(0).sum())
    n_bytes = (q.element_size() * (q.numel() + B * Sq * H * Dv
                                   + B * slots * KH * (D + Dv))
               + 4 * (q_pos.numel() + kv_pos.numel()))
    rate = FP32_FLOP_PER_S if q.element_size() == 4 else BF16_FLOP_PER_S
    return bound_ms(n_bytes, flash_attention_ops(q, k, v, q_pos, kv_pos,
                                                 causal), rate)


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


def city_sources():
    """city_p468, its 64 IoT source nodes (numpy seed 0) and the numpy
    generator after that draw."""
    from repro_torch.core import topology
    topo = topology.city_scale(n_olt=16, onus_per_olt=4, iot_per_onu=7)
    rng = np.random.default_rng(0)
    sources = rng.choice(topo.layer_indices("iot"), size=64, replace=False)
    return topo, sources, rng


def city_workload(n_vsrs: int = 1024):
    """city_p468 with ``n_vsrs`` VSRs of 3 VMs, sources 64 IoT nodes (numpy
    seed 0)."""
    from repro_torch.core import vsr
    topo, sources, rng = city_sources()
    return topo, vsr.random_vsrs(n_vsrs, rng=rng, n_vms=3,
                                 source_nodes=sources)


# VSRs of the instance past the fused anneal's shared-memory cap: J = 27000
# VMs, where one chain's X and best X (216 KB) no longer fit a block
R_PAST_CAP = 9000
# the placement kernels every cfn-milp solve below the cap launches (the
# anneal's shared-state variant and the re-score)
MAIN_PATH_KERNELS = ("placement_power", "fused_anneal")


def ptxas_usage(log: str) -> list:
    """Registers and spill bytes of each entry function in an nvcc
    ``-Xptxas -v`` log: [{function, registers, spill_stores, spill_loads}],
    the function as "name<template args>" from its mangled name."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d+([a-z_]+_kernel)"
                      r"(I((?:L[ib]-?\d+E)+)E)?", line)
        if m:
            args = [v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(-?\d+)E",
                                           m.group(3) or "")]
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


# phase 1's float64 oracle: the dense one (``ref.placement_objective_f64``:
# [L, P] one-hots and a [P, P] traffic matrix) takes 1.5-2.3 s a placement
# at R = 1024 on a host CPU, 48 of them most of the phase
ORACLE_CUT = ("the float64 oracle of the 16 + 32 checked rows evaluated "
              "link by link (ref.placement_objective_f64_links, equal to "
              "the dense oracle at rel 1e-12: tests/test_torch_federation."
              "py::test_link_oracle_equals_dense_oracle) in place of the "
              "dense one, ~2 s a row at R = 1024: pays for phase 5h")


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
        atol 1e-2) and, on its first n_f64 rows, the float64 oracle
        (``ORACLE_CUT``)."""
        got = pp.placement_power_cuda(Xf, *operands)
        want = pp.placement_power_ref(Xf, *operands)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-2)
        rec = {"cluster_size": pp.placement_power_cluster_size(Xf.shape[0]),
               "max_abs_err_vs_plain": float((got - want).abs().max())}
        if n_f64:
            Xr = Xf[:n_f64].reshape(n_f64, R, V)
            f64 = np.array([ref.placement_objective_f64_links(
                prob, X.cpu().numpy()) for X in Xr])
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
    iot_of = {}     # problem id -> its IoT first-fit placement (host Python)

    def fused_args(problem, C, T, seed, t_hi=50.0):
        # every chain starts at the IoT first-fit placement and follows its
        # own proposal stream (objectives near 2e4 W: the float32 drift of
        # the carried objective stays inside the self-consistency check)
        r = np.random.default_rng(seed)
        aux = power.build_aux(problem)
        if id(problem) not in iot_of:
            iot_of[id(problem)] = solvers.fixed_layer(problem, topo, "iot").X
        iot = iot_of[id(problem)]
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

    def held_anneal(problem, args, what, every_chain=True, rows_read=None,
                    variant="shared"):
        """The kernel's chains against its plain version's: best == exact
        objective of best X, best within 5e-2 of the plain version's; with
        every_chain, each chain's best placement equal to the plain's.
        rows_read, if given, is marked with the route rows the plain
        version reads.  The launch must be of the given variant."""
        C = args[0].shape[0]
        key = {"shared": "fused_anneal", "global": "fused_anneal_global"}[
            variant]
        n = pp.LAUNCHES[key]
        bk, sk = pp.fused_anneal_cuda(*args)
        torch.cuda.synchronize()
        check(pp.LAUNCHES[key] == n + 1,
              f"fused_anneal {what}: not the {variant} variant")
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
                ptxas=[f for f in ptxas_usage(_build.BUILD_LOG.get(
                    "fused_anneal", "")) if f["function"].endswith(
                        "false>")])
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

    # ---- fused_anneal past the shared-memory cap: the global variant ----
    t0 = time.perf_counter()
    topo_b, vsrs_b = city_workload(R_PAST_CAP)
    big = power.build_problem(topo_b, vsrs_b, device="cuda")
    J, Db, Kb = big.R * big.V, int(power.build_aux(big).inc_h.shape[1]), big.K
    out["fused_anneal_variant"] = {
        str(j): list(pp.fused_anneal_variant(32, j, P, prob.N, Db, Kb))
        for j in (26267, 26268, J)}
    check(out["fused_anneal_variant"]["26267"][0] == "shared"
          and out["fused_anneal_variant"]["26268"][0] == "global"
          and out["fused_anneal_variant"][str(J)][0] == "global",
          f"fused_anneal_variant: {out['fused_anneal_variant']}")
    for C in (5, 33):
        for T in (1, 300):
            out[f"fused_anneal_global_R{big.R}_C{C}_T{T}"] = held_anneal(
                big, fused_args(big, C, T, seed=C + T, t_hi=5.0),
                f"global R={big.R} C={C} T={T}", variant="global")[0]
    C, T = 32, 4000
    args = fused_args(big, C, T, seed=T)
    rows_read = torch.zeros(P * P, dtype=torch.bool, device="cuda")
    rec = held_anneal(big, args, f"global R={big.R} T={T}",
                      every_chain=False, rows_read=rows_read,
                      variant="global")[0]
    rec["bound_ms"], rec["bound_by"] = fused_anneal_bound(args, rows_read,
                                                          Db)
    st = torch.empty((C, 2), device="cuda")
    bX = torch.empty((C, J), dtype=torch.int32, device="cuda")
    rec.update(timed_pair(lambda: pp.fused_anneal_launch(bX, st, *args), 3))
    rec["us_per_step"] = rec["ms"] / T * 1e3
    rec["J"] = J
    rec["phase_seconds"] = time.perf_counter() - t0
    out[f"fused_anneal_global_R{big.R}_C32_T{T}"] = rec
    kernels["fused_anneal_global"].update(
        max_abs_err=rec["min_best_abs_err_vs_plain"], ms=rec["ms"],
        event_ms=rec["event_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        us_per_step=rec["us_per_step"],
        chains_equal_to_plain=rec["chains_equal_to_plain"],
        shape=f"C=32 chains, T=4000 steps, city_p468, R={big.R} (J={J})",
        ptxas=[f for f in ptxas_usage(_build.BUILD_LOG.get("fused_anneal",
                                                           ""))
               if f["function"].endswith("true>")])
    emit("kernels_vs_plain", cut=ORACLE_CUT, **out)


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
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0, f"paper: kernel {name} was not launched")
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
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0, f"city: kernel {name} was not launched")
    cdc_session = CFNSession(topo, spec.replace(method="cdc"), device="cuda")
    cdc = cdc_session.solve(vsrs)
    check(result.objective <= cdc.objective,
          f"city: objective {result.objective} above CDC {cdc.objective}")
    rescore(session, result)
    rescore(cdc_session, cdc)
    profile = sweep_profile(session.problem, topo)
    det = determinism_loads(session.problem,
                            torch.as_tensor(result.X, device="cuda"))
    emit("city_p468_R1024", power_w=result.power, objective=result.objective,
         feasible=result.feasible, method=result.method, cdc_w=cdc.power,
         saving_vs_cdc=1.0 - result.power / cdc.power,
         seconds_total=total, seconds_fixed_layer=stages["fixed_layer"],
         seconds_coordinate=stages["coordinate"],
         seconds_anneal=stages["anneal"], launches=launches,
         sweep_profile=profile)
    return launches, det


DETERMINISM_REPEATS = 16


def determinism_loads(prob, X, n: int = DETERMINISM_REPEATS) -> dict:
    """``power.init_state(prob, X)`` ``n`` times: how many builds differ
    from the first, per load (omega, theta, lam, tm) and the objective,
    with the order-fixed sums (``power._scatter_rows`` /
    ``fixed_order``; must be none) and with CUDA's atomic
    ``scatter_add_`` / ``index_add_`` in their place (for comparison); ms
    per build and per ``delta_sweep`` (one position) for each, timed in
    turns (fixed, atomic, atomic, fixed)."""
    import contextlib
    import torch
    from repro_torch.core import power
    names = ("omega", "theta", "lam", "tm", "obj")
    aux = power.build_aux(prob)
    st = power.init_state(prob, X)

    def differ() -> dict:
        bits = lambda s: [getattr(s, k).cpu().numpy().tobytes()
                          for k in names]
        first = bits(power.init_state(prob, X))
        out = dict.fromkeys(names, 0)
        for _ in range(n - 1):
            for k, a, b in zip(names, bits(power.init_state(prob, X)),
                               first):
                out[k] += a != b
        return out

    def ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    fixed = (power._scatter_rows, power.fixed_order)
    atomic = (lambda n, idx, val: val.new_zeros(idx.shape[:-1] + (n,))
              .scatter_add_(-1, idx, val),
              lambda x: contextlib.nullcontext())
    routes = {"fixed": fixed, "atomic": atomic}
    out = {r: dict(differ=None, init_ms=[], sweep_ms=[]) for r in routes}
    try:
        for r in ("fixed", "atomic", "atomic", "fixed"):
            power._scatter_rows, power.fixed_order = routes[r]
            if out[r]["differ"] is None:
                out[r]["differ"] = differ()
            out[r]["init_ms"].append(ms(lambda: power.init_state(prob, X)))
            out[r]["sweep_ms"].append(ms(lambda: power.delta_sweep(
                prob, aux, st, 0, 1)))
    finally:
        power._scatter_rows, power.fixed_order = fixed
    check(not any(out["fixed"]["differ"].values()),
          f"determinism: order-fixed loads differ {out['fixed']['differ']}")
    check(not torch.are_deterministic_algorithms_enabled(),
          "determinism: the deterministic flag was left on")
    return dict(repeats=n, R=prob.R, P=prob.P, **out)


# fig3's saving vs CDC over 1..20 VSRs as the JAX package computes it
# (benchmarks/paper_figures.py, on the CPU): mean, minimum (18 VSRs, where
# the IoT layer saturates and spills to the CDC) and maximum (1 VSR).  The
# paper reports 68%, 19% and 91%; the reproduction's minimum and maximum
# lie outside that band, the mean inside.  tests/test_torch_paper_figures.py
# pins these values and holds the port's statistics to them on the CPU.
REF_FIG3_SAVINGS = {"saving_vs_cdc": 0.6241, "saving_min": 0.0562,
                    "saving_max": 0.968}


def phase_paper_figures() -> dict:
    """The paper's drivers on the card (``repro_torch.paper_figures``):
    fig3 at 1..20 VSRs, fig4, and solver_gap, where cfn-milp must reach
    the exhaustive optimum on all five seeds; fig3's mean saving vs CDC
    must lie in the paper's 19%-91% band, and its mean, minimum and
    maximum within 0.01 of the JAX package's (``REF_FIG3_SAVINGS``)."""
    import torch
    from repro_torch import paper_figures
    from repro_torch.kernels import placement_power as pp
    pp.reset_launches()
    seconds = {}
    rows = {}
    for name, fn in (("fig3", paper_figures.fig3),
                     ("fig4", paper_figures.fig4),
                     ("solver_gap", paper_figures.solver_gap)):
        t0 = time.perf_counter()
        rows[name] = fn(device="cuda")
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    launches = dict(pp.LAUNCHES)
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0,
              f"paper_figures: kernel {name} was not launched")
    stats = rows["fig3"][-1]
    band = {k: stats[k] for k in ("saving_vs_cdc", "saving_min",
                                  "saving_max")}
    check(0.19 <= band["saving_vs_cdc"] <= 0.91,
          f"paper_figures: fig3 mean saving {band['saving_vs_cdc']} "
          f"outside 19-91%")
    check(all(abs(band[k] - v) <= 0.01 for k, v in REF_FIG3_SAVINGS.items()),
          f"paper_figures: fig3 savings {band} vs the JAX package's "
          f"{REF_FIG3_SAVINGS}")
    for rec in rows["fig3"][:-1]:
        check(rec["cfn-milp_w"] <= rec["cdc_w"],
              f"paper_figures: fig3 n={rec['n_vsrs']} above CDC")
    gaps = {m: [rec[f"{m}_gap"] for rec in rows["solver_gap"]]
            for m in paper_figures.GAP_METHODS}
    check(all(g == 0.0 for g in gaps["cfn-milp"]),
          f"paper_figures: cfn-milp gaps {gaps['cfn-milp']}")
    check(all(np.isfinite(g).all() for g in gaps.values()),
          f"paper_figures: gaps {gaps}")
    method_s = {m: [rec[f"{m}_s"] for rec in rows["solver_gap"]]
                for m in ("exhaustive",) + paper_figures.GAP_METHODS}
    emit("paper_figures", seconds=seconds, fig3_savings=band,
         fig3=[{k: rec[k] for k in ("n_vsrs", "cdc_w", "af_w", "mf_w",
                                    "cfn-milp_w", "saving_vs_cdc",
                                    "layers_used")}
               for rec in rows["fig3"][:-1]],
         fig4=rows["fig4"], solver_gap=gaps, solver_seconds=method_s,
         launches=launches)
    return launches


# phase 3b's VSRs
RELAX_R = 128


def phase_relax_city() -> None:
    """relax at city_p468, full topology width (P=468, N=126, K=14), on
    ``RELAX_R`` VSRs of 3 VMs: cut from phase 3's 1024 because its repair
    is up to 4 host-bound coordinate sweeps at ~11 ms a position.  Every value must
    be finite, and the loss must fall below its start.  It need not end
    there: each recorded loss is taken at a lower temperature, and on
    this instance it rises again by two orders of magnitude once the
    soft assignment sharpens onto the overloaded source nodes (the
    argmax and the repair then give the placement).  The objective is
    printed beside coordinate from CDC on the same instance."""
    import torch
    from repro_torch.core import power, solvers
    topo, vsrs = city_workload(RELAX_R)
    prob = power.build_problem(topo, vsrs, device="cuda")
    repair_s = []
    coordinate = solvers.coordinate

    def timed_coordinate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = coordinate(*args, **kwargs)
        repair_s.append(time.perf_counter() - t0)
        return res

    steps = 800
    solvers.coordinate = timed_coordinate
    try:
        t0 = time.perf_counter()
        res = solvers.relax(prob, solvers.default_generator(0), steps=steps)
        total_s = time.perf_counter() - t0
    finally:
        solvers.coordinate = coordinate
    n_loss = len(range(0, steps, max(1, steps // 40)))
    loss = res.history[:n_loss]
    check(len(repair_s) == 1, f"relax_city: {len(repair_s)} repairs")
    check(bool(np.isfinite(res.history).all())
          and np.isfinite(res.objective) and np.isfinite(res.power),
          f"relax_city: non-finite values {res.history[:3]} ...")
    check(min(loss) < loss[0],
          f"relax_city: the loss never fell below its start {loss[0]}")
    t0 = time.perf_counter()
    cdc = topo.layer_indices("cdc")[0]
    coord = solvers.coordinate(prob, np.full((prob.R, prob.V), cdc,
                                             dtype=np.int32))
    coord_s = time.perf_counter() - t0
    emit("relax_city", cut=f"R={RELAX_R} VSRs (phase 3 runs 1024): the "
         "4-sweep repair is host-bound at ~11 ms a position (256 before "
         "phases 5f and 8, which this cut pays for)", P=prob.P, N=prob.N,
         K=prob.K, R=prob.R, V=prob.V, steps=steps, loss_first=loss[0],
         loss_last=loss[-1], loss_min=min(loss), n_loss=n_loss, loss=loss,
         seconds_descent=total_s - repair_s[0], seconds_repair=repair_s[0],
         seconds_total=total_s, objective=res.objective, power_w=res.power,
         feasible=res.feasible, coordinate_from_cdc_objective=coord.objective,
         coordinate_from_cdc_s=coord_s)


def phase_anneal_past_cap() -> dict:
    """The default anneal past the shared-memory cap: R = 9000 VSRs of 3
    VMs at city_p468 (J = 27000), from the IoT first-fit warm start,
    through the global-state variant (no coordinate sweep: 18000
    positions); then star VSRs of 34 VMs (D = 33), where "auto" takes the
    delta backend and "fused" raises."""
    import torch
    from repro_torch.core import power, solvers, vsr
    from repro_torch.kernels import placement_power as pp
    t_all = time.perf_counter()
    topo, vsrs = city_workload(R_PAST_CAP)
    prob = power.build_problem(topo, vsrs, device="cuda")
    warm = solvers.fixed_layer(prob, topo, "iot")
    variant = pp.fused_anneal_variant(
        32, prob.R * prob.V, prob.P, prob.N,
        int(power.build_aux(prob).inc_h.shape[1]), prob.K)
    pp.reset_launches()
    t0 = time.perf_counter()
    res = solvers.anneal(prob, solvers.default_generator(0), warm.X,
                         backend="auto")
    torch.cuda.synchronize()
    anneal_s = time.perf_counter() - t0
    launches = dict(pp.LAUNCHES)
    check(launches["fused_anneal_global"] == 1
          and launches["fused_anneal"] == 0
          and launches["placement_power"] > 0,
          f"anneal_past_cap: launches {launches}")
    check(res.method == "anneal(fused)",
          f"anneal_past_cap: method {res.method}")
    check(np.isfinite(res.objective) and np.isfinite(res.power),
          f"anneal_past_cap: objective {res.objective}")
    # no worse than the warm start, to the tolerance of PERF.md section 2
    check(res.objective <= warm.objective + 5e-2 + 1e-5 * abs(
        warm.objective), f"anneal_past_cap: {res.objective} above the "
        f"warm start's {warm.objective}")
    # star VSRs: the hub has D = 33 incident links, past the kernel's 32
    star = power.build_problem(topo, vsr.random_vsrs(
        8, rng=0, n_vms=34, source_nodes=range(8), topology="star"),
        device="cuda")
    D = int(power.build_aux(star).inc_h.shape[1])
    X0 = solvers.fixed_layer(star, topo, "iot").X
    pp.reset_launches()
    t0 = time.perf_counter()
    res_star = solvers.anneal(star, solvers.default_generator(0), X0,
                              n_steps=300, backend="auto")
    star_s = time.perf_counter() - t0
    check(D == 33 and res_star.method == "anneal"
          and not any(pp.LAUNCHES.values()),
          f"anneal_past_cap: star D={D} ran {res_star.method}, "
          f"launches {dict(pp.LAUNCHES)}")
    try:
        solvers.anneal(star, solvers.default_generator(0), X0, n_steps=300,
                       backend="fused")
        fused_raised = False
    except ValueError as e:
        fused_raised = "D <= 32" in str(e)
    check(fused_raised, "anneal_past_cap: backend='fused' did not raise "
                        "at D = 33")
    emit("anneal_past_cap", R=prob.R, J=prob.R * prob.V, variant=variant,
         warm_objective=warm.objective, objective=res.objective,
         power_w=res.power, method=res.method, seconds_anneal=anneal_s,
         launches=launches, star_D=D, star_method=res_star.method,
         star_objective=res_star.objective, star_warm_objective=float(
             power.objective(star, X0)), star_seconds=star_s,
         star_fused_raises=fused_raised,
         seconds_total=time.perf_counter() - t_all)
    return launches


# phase 3d: live services and churn events.  Cut from phase 3's 1024
# services: an event's polish sweeps every free VM (padded to R x (V - 1)
# positions) twice, at ~10 ms a position.  Events cut from 8 to 4 to pay
# for phases 5f and 8 (6-7 s an incremental re-solve on the card, the
# checks of each event and of the periodic full solve kept)
CHURN_R = 64
CHURN_EVENTS = 4
# phase 3e: a flash crowd of replace waves (8 departures and 8 arrivals a
# tick) at phase 3d's size, a defrag tick of 8 rows after each wave; cut
# from 4 waves to 2 with 3d's events
WAVES = 2
WAVE_SIZE = 16
TICK_ROWS = 8
# phase 3e (ii): the admission plane on the first 16 of those services,
# placed by a cfn-milp solve of their own (a 64-service placement cut to
# 16 leaves nodes on that a re-solve switches off, and the zero-watt
# brownout then admits).  Cut from 64: each refused, preempted or drained
# admission re-solves the live set (73.5 s of the script's 942 s at 64,
# NVIDIA H100 80GB HBM3, 700.00 W)
ADMISSION_R = 16


def churn_vsr(sources, sid: int):
    """The arrival with service id ``sid`` in phases 3d and 3e: one VSR of
    3 VMs from seed 1000 + sid at source ``sources[sid % 64]``."""
    from repro_torch.core import vsr
    return vsr.random_vsrs(1, rng=1000 + sid, n_vms=3,
                           source_nodes=[sources[sid % CHURN_R]])


class StageTimer:
    """Inside ``with``: every incremental re-solve's seconds split by stage
    on the card (``split``: targeted_sweep, anneal, rescore, polish, and
    full_solve for a periodic full solve), by wrapping the solver functions
    with synchronized timers; ``resolves`` holds each re-solve's problem,
    warm-start X, keyword arguments and result."""

    STAGES = {"_sweep": "sweep", "_anneal_scan_delta": "anneal",
              "placement_objective": "rescore", "_embed": "full_solve"}

    def __init__(self):
        from repro_torch.core import embed, solvers
        from repro_torch.kernels import ops
        self.split: dict = {}
        self.resolves: list = []
        self._in_resolve = self._rescored = False
        targets = [(solvers, "resolve_incremental"), (solvers, "_sweep"),
                   (solvers, "_anneal_scan_delta"),
                   (ops, "placement_objective"), (embed, "_embed")]
        self._originals = {name: getattr(mod, name) for mod, name in targets}
        self._patches = [(mod, name, self._resolve
                          if name == "resolve_incremental"
                          else self._timed(name)) for mod, name in targets]

    def _timed(self, name):
        import torch
        fn, stage = self._originals[name], self.STAGES[name]

        def run(*args, **kwargs):
            if stage != "full_solve" and not self._in_resolve:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            name = stage
            if stage == "sweep":
                name = "polish" if self._rescored else "targeted_sweep"
            self._rescored |= stage == "rescore"
            self.split[name] = (self.split.get(name, 0.0)
                                + time.perf_counter() - t0)
            return out
        return run

    def _resolve(self, problem, **kwargs):
        self._in_resolve, self._rescored = True, False
        try:
            res = self._originals["resolve_incremental"](problem, **kwargs)
        finally:
            self._in_resolve = False
        self.resolves.append(dict(problem=problem, X_warm=kwargs["state"].X,
                                  kwargs=kwargs, result=res))
        return res

    def take_split(self, seconds: float) -> dict:
        """The split since the last call, with ``other_s`` the rest of
        ``seconds``; clears it."""
        out = dict(split_s=dict(self.split),
                   other_s=seconds - sum(self.split.values()))
        self.split.clear()
        return out

    def __enter__(self):
        for mod, name, fn in self._patches:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self._patches:
            setattr(mod, name, self._originals[name])
        return False


def hold_to_oracle(session, what: str) -> float:
    """The session's objective is the float64 oracle's (5e-2 + 1e-5
    |obj|); returns the oracle's."""
    from repro_torch.kernels import ref
    obj = session.objective()
    f64 = ref.placement_objective_f64(session.problem, session.X)
    check(abs(obj - f64) <= 5e-2 + 1e-5 * abs(f64),
          f"{what}: objective {obj} vs float64 oracle {f64}")
    return f64


def phase_churn() -> tuple:
    """Phase 3d: the online churn engine at city_p468, through
    ``CFNSession``.  Bootstrap 64 services of ``city_workload`` (one
    cfn-milp solve), then replay ``churn_trace(64, 4, rng=0)``'s four
    events (departures and arrivals in turn; an arrival's VSR from
    ``churn_vsr``) under ``PlacementSpec(defrag_every=4)``: each event
    detaches or attaches one service's loads, re-solves incrementally
    (targeted sweeps, a 600-step x 8-chain delta anneal, the
    placement_power re-score, two polish sweeps), and the last also runs
    the periodic full solve against its incremental incumbent.  After
    every event the committed objective must be the float64 oracle's
    (5e-2 + 1e-5 |obj|) and no more than 1e-3 above the exact objective of
    the event's warm start; then the live sids must be the trace's, the
    per-tenant watts must sum to the fleet's (1e-6 relative), and a detach
    / attach round trip must give back ``init_state``'s loads (rtol 1e-5,
    atol 1e-2).  Returns the launches and each event's seconds."""
    import torch
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import dynamic, power
    from repro_torch.kernels import placement_power as pp
    t_all = time.perf_counter()
    topo, batch = city_workload(CHURN_R)
    sources = city_sources()[1]
    events = dynamic.churn_trace(CHURN_R, CHURN_EVENTS, rng=0)[CHURN_R:]
    timer = StageTimer()
    per_event = []
    clock = {}

    def on_event(ev, res):
        torch.cuda.synchronize()
        seconds = time.perf_counter() - clock["t0"]
        check(res is not None and len(timer.resolves) == len(per_event) + 1,
              f"churn: event {ev} gave {res} after {len(timer.resolves)} "
              "re-solves")
        obj = session.objective()
        f64 = hold_to_oracle(session, f"churn: {ev}")
        r = timer.resolves[-1]
        warm = float(power.objective(r["problem"], r["X_warm"]))
        check(obj <= warm + 1e-3,
              f"churn: {ev}: objective {obj} above its warm start {warm}")
        per_event.append(dict(
            kind=ev.kind, sid=ev.sid, method=res.method, objective=obj,
            power_w=session.power_w(), f64_objective=f64,
            warm_objective=warm,
            incremental_objective=r["result"].objective,
            n_live=session.n_live, seconds=seconds,
            **timer.take_split(seconds)))
        clock["t0"] = time.perf_counter()

    spec = PlacementSpec(defrag_every=CHURN_EVENTS)
    pp.reset_launches()
    t0 = time.perf_counter()
    session = CFNSession(topo, spec, device="cuda")
    boot = session.solve(batch)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boot_launches = dict(pp.LAUNCHES)
    with timer:
        clock["t0"] = t_events = time.perf_counter()
        session.replay(events, lambda sid: churn_vsr(sources, sid),
                       on_event=on_event)
        events_s = time.perf_counter() - t_events
        launches = dict(pp.LAUNCHES)

    check(len(per_event) == CHURN_EVENTS,
          f"churn: {len(per_event)} of {CHURN_EVENTS} events ran")
    live = set(range(CHURN_R))
    for ev in events:
        (live.add if ev.kind == "arrive" else live.discard)(ev.sid)
    check(sorted(session.sids) == sorted(live),
          f"churn: live sids {sorted(session.sids)} != {sorted(live)}")
    last = per_event[-1]
    check(last["method"].startswith(("cfn-milp", "defrag-kept"))
          and session.stats[-1].objective <= last["incremental_objective"]
          + 1e-6, f"churn: the last event's full solve: {last}")
    check(launches["placement_power"] >= CHURN_EVENTS + 1
          and launches["fused_anneal"] >= 2,
          f"churn: launches {launches}")
    per = session.attribute()
    check(set(per) == set(session.sids)
          and abs(sum(per.values()) - session.power_w())
          <= 1e-6 * max(1.0, session.power_w()),
          f"churn: per-tenant watts sum {sum(per.values())} vs "
          f"{session.power_w()}")
    prob, X = session.problem, session.X
    st0 = power.init_state(prob, X)
    back = power.attach_vsrs(prob, power.detach_vsrs(prob, st0, [5]), [5])
    rt_err = {}
    for name in ("omega", "tm", "theta", "lam"):
        a, b = getattr(back, name), getattr(st0, name)
        rt_err[name] = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-2)),
              f"churn: round trip {name} off by {rt_err[name]}")
    rescore(session, session.result)
    # a second session from the same generator seed (after the count)
    t0 = time.perf_counter()
    again = CFNSession(topo, spec, device="cuda").solve(batch)
    torch.cuda.synchronize()
    det = dict(X_equal=again.X.tobytes() == boot.X.tobytes(),
               objective=[boot.objective, again.objective],
               objective_equal=again.objective == boot.objective,
               seconds=time.perf_counter() - t0)
    check(det["X_equal"] and det["objective_equal"],
          f"determinism: a second bootstrap differs {det}")
    polish = [e["split_s"].get("polish", 0.0) for e in per_event]
    emit("churn_city_p468_R64",
         cut=f"R={CHURN_R} live services (phase 3 runs 1024): an event's "
             "polish sweeps every free VM, padded to R x (V - 1) "
             "positions, twice, at ~10 ms a position; "
             f"{CHURN_EVENTS} events (8 before phases 5f and 8, which "
             "this cut pays for, with 3e's waves and 3b's VSRs)",
         P=prob.P, N=prob.N, K=prob.K, R=prob.R, V=prob.V,
         bootstrap_s=boot_s, bootstrap_objective=boot.objective,
         bootstrap_method=boot.method, bootstrap_launches=boot_launches,
         events=per_event, events_s=events_s,
         polish_positions=2 * prob.R * (prob.V - 1),
         polish_ms_per_position_median=statistics.median(polish) * 1e3
         / (2 * prob.R * (prob.V - 1)),
         launches=launches, live_sids=sorted(session.sids),
         attribute_sum_w=sum(per.values()), power_w=session.power_w(),
         roundtrip_max_abs_err=rt_err,
         seconds_total=time.perf_counter() - t_all)
    return launches, [e["seconds"] for e in per_event], det, boot.X[:CHURN_R]


def phase_waves(churn_event_s: list, boot_X) -> dict:
    """Phase 3e: churn waves and the admission plane at city_p468, through
    ``CFNSession``, at phase 3d's size.

    (i) Adopt phase 3d's bootstrap placement ``boot_X`` of the 64
    ``city_workload`` services (``bootstrap(X0=...)``, no solve: the
    ``determinism`` line shows that a second bootstrap solve repeats it
    bit for bit; its objective held to the float64 oracle), then replay
    ``flash_crowd_trace(64, 2, 16, rng=0)``'s two replace waves (8
    departures and 8 arrivals a tick, arrivals from
    ``churn_vsr``) with ``waves=True`` under
    ``PlacementSpec(defrag_every=0, defrag_rows_per_tick=8)``: each wave
    is one fused detach, one ``resolve_wave`` (targeted sweeps over its
    arrivals' 16 free positions, padded to their power-of-two bucket, the
    delta anneal, the placement_power re-score, two polish sweeps), then
    one ``defrag_tick`` over 8 rows.  After every wave the objective must
    be the float64 oracle's (5e-2 + 1e-5 |obj|), no more than 1e-3 above
    the wave's warm start, with 64 live services; every tick must not
    raise the objective and must advance its cursor by 8 mod 64.

    (ii) Adopt a cfn-milp placement of (i)'s first ``ADMISSION_R``
    services (no solve in the adopting engine) under
    ``PlacementSpec(defrag_every=0, priority_classes=2,
    queue_rejected=True, preempt=True)`` with the last two in class 1, ``brownout(0.0)``, then one wave of a class-0 and a class-1
    arrival: both refused, the class-0 one preempting the two class-1
    services (newest first), four services queued in class-then-FIFO
    order; ``brownout_end()`` drains all four in that order, every commit
    held to the float64 oracle.  Returns the phase's launches."""
    import torch
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import dynamic, power, solvers, vsr
    from repro_torch.kernels import placement_power as pp
    t_all = time.perf_counter()
    topo, batch = city_workload(CHURN_R)
    sources = city_sources()[1]
    events = dynamic.flash_crowd_trace(CHURN_R, WAVES, WAVE_SIZE,
                                       rng=0)[CHURN_R:]
    timer = StageTimer()

    # (i) the flash crowd, on 3d's bootstrap placement
    spec = PlacementSpec(defrag_every=0, defrag_rows_per_tick=TICK_ROWS)
    pp.reset_launches()
    t0 = time.perf_counter()
    session = CFNSession(topo, spec, device="cuda")
    boot = session.engine.bootstrap(
        [vsr.VSRBatch(F=batch.F[i:i + 1], H=batch.H[i:i + 1],
                      src=batch.src[i:i + 1],
                      input_vm=batch.input_vm[i:i + 1])
         for i in range(batch.R)], X0=boot_X)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    hold_to_oracle(session, "waves: adopted")
    boot_launches = dict(pp.LAUNCHES)
    eng = session.engine
    apply_wave, defrag_tick = eng.apply_wave, eng.defrag_tick
    waves, ticks = [], []

    def timed_wave(arrivals, departures):
        n0 = len(timer.resolves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wr = apply_wave(arrivals, departures)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        what = f"waves: wave {len(waves) + 1}"
        check(len(timer.resolves) == n0 + 1,
              f"{what}: {len(timer.resolves) - n0} re-solves")
        check(wr.admitted == [sid for _, sid in arrivals]
              and wr.departed == list(departures) and not wr.rejected
              and not wr.queued and wr.result.method == "wave",
              f"{what}: {wr}")
        check(session.n_live == CHURN_R, f"{what}: {session.n_live} live")
        obj = session.objective()
        f64 = hold_to_oracle(session, what)
        r = timer.resolves[-1]
        warm = float(power.objective(r["problem"], r["X_warm"]))
        check(obj <= warm + 1e-3,
              f"{what}: objective {obj} above its warm start {warm}")
        rows = r["kwargs"]["changed_rows"]
        n_pos = int((~r["problem"].host.fixed_mask[rows]).sum())
        pad = r["kwargs"]["pad_changed_to"]
        check(pad == solvers._pow2(n_pos) and pad & (pad - 1) == 0,
              f"{what}: {n_pos} changed positions padded to {pad}")
        waves.append(dict(
            n_arrive=len(arrivals), n_depart=len(departures),
            objective=obj, power_w=session.power_w(), f64_objective=f64,
            warm_objective=warm, n_live=session.n_live,
            changed_positions=n_pos, pad_changed_to=pad, seconds=seconds,
            events_per_s=(len(arrivals) + len(departures)) / seconds,
            **timer.take_split(seconds)))
        return wr

    def timed_tick(rows=None):
        before, cursor = session.objective(), eng._defrag_cursor
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = defrag_tick(rows)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = session.objective()
        check(after <= before,
              f"waves: defrag tick raised the objective {before} -> {after}")
        check(eng._defrag_cursor == (cursor + TICK_ROWS) % session.n_live,
              f"waves: tick cursor {cursor} -> {eng._defrag_cursor}")
        ticks.append(dict(seconds=seconds, committed=res is not None,
                          objective_before=before, objective_after=after,
                          cursor=eng._defrag_cursor))
        return res

    eng.apply_wave, eng.defrag_tick = timed_wave, timed_tick
    with timer:
        t0 = time.perf_counter()
        session.replay(events, lambda sid: churn_vsr(sources, sid),
                       waves=True)
        replay_s = time.perf_counter() - t0
    del eng.apply_wave, eng.defrag_tick
    wave_launches = {k: v - boot_launches[k] for k, v in pp.LAUNCHES.items()}
    check(len(waves) == WAVES and len(ticks) == WAVES,
          f"waves: {len(waves)} waves, {len(ticks)} ticks")
    live = set(range(CHURN_R))
    for ev in events:
        (live.add if ev.kind == "arrive" else live.discard)(ev.sid)
    check(sorted(session.sids) == sorted(live),
          f"waves: live sids {sorted(session.sids)} != {sorted(live)}")
    check(wave_launches["placement_power"] >= WAVES,
          f"waves: launches in the waves {wave_launches}")
    wave_s = sum(w["seconds"] for w in waves)

    # (ii) the admission plane, on (i)'s bootstrap placement
    n_adm = ADMISSION_R
    services = [vsr.VSRBatch(F=batch.F[i:i + 1], H=batch.H[i:i + 1],
                             src=batch.src[i:i + 1],
                             input_vm=batch.input_vm[i:i + 1])
                for i in range(n_adm)]
    adm = CFNSession(topo, PlacementSpec(
        defrag_every=0, priority_classes=2, queue_rejected=True,
        preempt=True), device="cuda")
    aeng = adm.engine
    placed = CFNSession(topo, PlacementSpec(defrag_every=0),
                        device="cuda").solve(vsr.concat_all(services))
    adopted = aeng.bootstrap(services, X0=placed.X[:n_adm],
                             priorities=[0] * (n_adm - 2) + [1] * 2)
    check(abs(adopted.objective - placed.objective)
          <= 1e-3 + 1e-6 * abs(placed.objective),
          f"admission: adopted {adopted.objective} vs {placed.objective}")
    hold_to_oracle(adm, "admission: adopted")
    commit, commits = aeng._commit, []

    def held_commit(res, event):
        commit(res, event)
        commits.append(dict(event=event, objective=res.objective,
                            f64_objective=hold_to_oracle(
                                adm, f"admission: {event} commit"),
                            n_live=adm.n_live))

    aeng._commit = held_commit
    victims = [sid for sid, p in zip(adm.sids, aeng._prio) if p == 1][::-1]
    arrivals = [(churn_vsr(sources, 200), 200, 0),
                (churn_vsr(sources, 201), 201, 1)]
    adm.brownout(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wr = adm.apply_wave(arrivals)
    torch.cuda.synchronize()
    refused_s = time.perf_counter() - t0
    queued = aeng.queued_sids
    check(wr.admitted == [] and wr.rejected == []
          and sorted(wr.queued) == [200, 201] and wr.n_preempted == 2,
          f"admission: wave verdicts {wr}")
    check(queued == [200, 201] + victims,
          f"admission: queue {queued}, victims {victims}")
    check(adm.admission == dict(admitted=n_adm, rejected=2, queued=2,
                                preempted=2),
          f"admission: counters {adm.admission}")
    check(adm.n_live == n_adm - 2 and not set(victims) & set(adm.sids),
          f"admission: {adm.n_live} live after preemption")
    n_commits = len(commits)
    t0 = time.perf_counter()
    adm.brownout_end()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    del aeng._commit
    check(adm.sids[-4:] == queued and not aeng.queued_sids
          and adm.n_live == n_adm + 2,
          f"admission: drained {adm.sids[-4:]}, queue {aeng.queued_sids}")
    check([c["event"] for c in commits[n_commits:]] == ["add"] * 4,
          f"admission: drain commits {commits[n_commits:]}")
    launches = dict(pp.LAUNCHES)
    check(launches["fused_anneal"] >= 1,
          f"waves: launches in the phase {launches}")
    rescore(session, session.result)      # after the count: a check only
    events_3d = len(churn_event_s) / sum(churn_event_s)
    emit("waves_city_p468_R64",
         cut=f"R={CHURN_R} live services and {WAVES} waves of "
             f"{WAVE_SIZE} events (phase 3d's size): a wave's polish "
             "sweeps every free VM, padded to R x (V - 1) positions, "
             f"twice ({WAVES} waves: 4 before phases 5f and 8, which "
             "this cut pays for); (i) adopts 3d's bootstrap placement "
             "instead of "
             "solving it again (7.6-12.6 s on the card; the determinism "
             "line holds a second solve bit-equal to it); (ii) on the "
             f"first {n_adm} of them (cut from {CHURN_R}: each admission "
             "re-solves the live set)",
         P=session.problem.P, N=session.problem.N, K=session.problem.K,
         R=session.problem.R, V=session.problem.V,
         bootstrap_s=boot_s, bootstrap_objective=boot.objective,
         bootstrap_method=boot.method, bootstrap_launches=boot_launches,
         waves=waves, ticks=ticks, replay_s=replay_s,
         wave_events_per_s=WAVES * WAVE_SIZE / wave_s,
         wave_events_per_s_with_ticks=WAVES * WAVE_SIZE / (
             wave_s + sum(t["seconds"] for t in ticks)),
         churn_3d_events_per_s=events_3d,
         churn_3d_events_per_s_incremental=(len(churn_event_s) - 1) / sum(
             churn_event_s[:-1]),
         wave_speedup_vs_3d=WAVES * WAVE_SIZE / wave_s / events_3d,
         live_sids=sorted(session.sids), launches_waves=wave_launches,
         admission=dict(
             wave_seconds=refused_s, drain_seconds=drain_s,
             queued_sids=queued, victims=victims, counters=adm.admission,
             drained_sids=adm.sids[-4:], commits=commits),
         launches=launches, seconds_total=time.perf_counter() - t_all)
    return launches, boot_X


def hosted_vms(session, topo) -> tuple:
    """Live VMs per node of the session's placement, and its sources."""
    eng = session.engine
    hosted = np.bincount(np.concatenate([session.X[r, :eng.service_vms(r)]
                                         for r in range(session.n_live)]),
                         minlength=topo.P)
    return hosted, [int(sv.src[0]) for sv in eng._vsrs]


# phase 3f (ii)'s rack storm: the non-source nodes hosting the most, cut
# from 2 to 1 in PR 32 (a failure and a recovery fewer) to pay for 5h
STORM_NODES = 1


def fault_targets(session, topo) -> dict:
    """Phase 3f's fault targets on the adopted placement: the non-source
    node hosting the most live VMs, the network element with the most
    traffic, the source of fewest live services, and the
    ``STORM_NODES`` non-source nodes hosting the most."""
    hosted, srcs = hosted_vms(session, topo)
    non_src = [int(p) for p in np.argsort(-hosted, kind="stable")
               if p not in set(srcs) and hosted[p] > 0]
    count = {p: srcs.count(p) for p in set(srcs)}
    return dict(node=non_src[0], storm=non_src[:STORM_NODES],
                link=int(session.engine._state.lam.argmax()),
                source=min(count, key=lambda p: (count[p], p)))


def phase_faults(boot_X) -> dict:
    """Phase 3f: the fault plane at city_p468, through ``CFNSession`` with
    a ``PlacementMonitor``, at phase 3d's size.

    (i) Adopt phase 3d's bootstrap placement of 64 ``city_workload``
    services (passed on by 3e; ``bootstrap(X0=...)``, no solve), then
    call the handlers on the engine's clock (``tick`` t = 1, 2, ...):
    ``fail_node`` on the non-source node hosting the most live VMs (a
    mass re-embed),
    ``fail_link`` on the network element with the most traffic,
    ``fail_node`` on the source of fewest live services (they strand),
    ``fail_node`` on a node that then hosts nothing and sources nothing
    ("untouched": a re-score, no solver work), then the four recoveries
    in reverse order.
    ``defrag_every`` = 7 + the stranded count, so the seventh handler call
    (the link's recovery, with the first node still down) runs the
    periodic full solve, on the degraded problem, once.

    (ii) Adopt it again under ``defrag_every=0`` and replay a
    ``rack_storm`` of the ``STORM_NODES`` non-source nodes hosting the
    most (failing from t = 0.5, 0.05 apart, each recovering an hour
    later) merged with one tick of
    ``flash_crowd_trace(64, 1, 16, rng=0)`` (8 departures, 8 arrivals at
    t = 1, a wave on the degraded substrate), ``waves=True``.

    After every event: the commit within 5e-2 + 1e-5 |obj| of the float64
    oracle on the degraded problem, no live VM on a dead node, the cut
    link at <= 1e-2 Mbps while it is down, live + queued == admitted, and
    every re-solve re-scored by exactly one placement_power launch.  At
    the end every service is live, no strand window open, availability
    below 1, and the monitor's counts those of the handler calls.
    Returns the phase's launches."""
    import torch
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import dynamic, vsr
    from repro_torch.fault import PlacementMonitor
    from repro_torch.kernels import placement_power as pp
    t_all = time.perf_counter()
    topo, batch = city_workload(CHURN_R)
    sources = city_sources()[1]
    services = [vsr.VSRBatch(F=batch.F[i:i + 1], H=batch.H[i:i + 1],
                             src=batch.src[i:i + 1],
                             input_vm=batch.input_vm[i:i + 1])
                for i in range(batch.R)]
    timer = StageTimer()
    pp.reset_launches()

    def adopt(spec):
        mon = PlacementMonitor()
        ses = CFNSession(topo, spec, device="cuda", monitor=mon)
        res = ses.engine.bootstrap(services, X0=boot_X)
        hold_to_oracle(ses, "faults: adopted")
        return ses, mon, res

    def held(ses, what, admitted, cut=None) -> dict:
        """The checks after one event; returns its numbers."""
        f64 = hold_to_oracle(ses, what)
        h, eng = ses.health, ses.engine
        if h is not None:
            dead = [int(x) for r in range(ses.n_live)
                    for x in ses.X[r, :eng.service_vms(r)]
                    if not h.node_up[x]]
            check(not dead, f"{what}: live VMs on dead nodes {dead}")
            if cut is not None and not h.link_up[cut]:
                lam = float(eng._state.lam[cut])
                check(lam <= 1e-2, f"{what}: cut link {cut} carries {lam}")
        live, queued = set(ses.sids), set(eng.queued_sids)
        check(live | queued == admitted and not live & queued,
              f"{what}: live {sorted(live)} + queued {sorted(queued)} != "
              f"admitted {sorted(admitted)}")
        return dict(objective=ses.objective(), f64_objective=f64,
                    n_live=ses.n_live, queued=sorted(queued))

    def counted(fn, what, ses, mon):
        """Run one event; its seconds, split, launches and monitor deltas,
        with placement_power launched once per re-solve (the periodic full
        solve's launches apart)."""
        n_res, launch0 = len(timer.resolves), dict(pp.LAUNCHES)
        mon0 = dict(mon.counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v - launch0[k] for k, v in pp.LAUNCHES.items()}
        resolves = len(timer.resolves) - n_res
        split = timer.take_split(seconds)
        full = "full_solve" in split["split_s"]
        check(launches["placement_power"] == resolves
              or (full and launches["placement_power"] >= resolves),
              f"{what}: {launches} for {resolves} re-solves")
        delta = {k: v - mon0.get(k, 0) for k, v in mon.counters.items()
                 if v != mon0.get(k, 0)}
        return res, dict(seconds=seconds, resolves=resolves,
                         full_solve=full, launches=launches,
                         re_embedded=delta.get("re_embedded", 0),
                         stranded=delta.get("service_stranded", 0),
                         monitor=delta, **split)

    # (i) direct handler calls
    probe = CFNSession(topo, PlacementSpec(defrag_every=0), device="cuda")
    probe.engine.bootstrap(services, X0=boot_X)
    tg = fault_targets(probe, topo)
    m = sum(int(sv.src[0]) == tg["source"] for sv in services)
    del probe
    ses, mon, adopted = adopt(PlacementSpec(defrag_every=7 + m))
    admitted = set(ses.sids)
    plan = [("fail_node", tg["node"]), ("fail_link", tg["link"]),
            ("fail_node", tg["source"]), ("fail_node", None)]
    events, full_degraded = [], []
    with timer:
        for i in range(1, 2 * len(plan) + 1):
            if i == 4:                    # idle now, after three re-solves
                hosted, srcs = hosted_vms(ses, topo)
                tg["idle"] = next(p for p in range(topo.P) if hosted[p] == 0
                                  and p not in srcs and ses.health.node_up[p])
                plan[-1] = ("fail_node", tg["idle"])
                plan += [(k.replace("fail", "recover"), t)
                         for k, t in plan[::-1]]
            kind, target = plan[i - 1]
            ses.tick(float(i))
            what = f"faults: {kind}({target})"
            res, rec = counted(lambda: getattr(ses, kind)(target), what,
                               ses, mon)
            check(res is not None, f"{what} gave no result")
            if rec["full_solve"]:
                full_degraded.append(not ses.health.all_up)
                check(rec["launches"]["fused_anneal"] >= 1,
                      f"{what}: the full solve launched {rec['launches']}")
            events.append(dict(kind=kind, target=target, method=res.method,
                               **rec, **held(ses, what, admitted,
                                             tg["link"])))
    by_kind = {k: sum(e["kind"] == k for e in events)
               for k in ("fail_node", "fail_link", "recover_node",
                         "recover_link")}
    check(mon.get("node_failed") == by_kind["fail_node"] == 3
          and mon.get("link_failed") == by_kind["fail_link"] == 1
          and mon.get("node_recovered") == by_kind["recover_node"] == 3
          and mon.get("link_recovered") == by_kind["recover_link"] == 1,
          f"faults: monitor {mon.counters} vs handler calls {by_kind}")
    check(events[3]["method"] == "untouched"
          and events[3]["resolves"] == 0
          and not any(events[3]["launches"].values()),
          f"faults: the idle node's failure {events[3]}")
    check(events[2]["stranded"] == m and mon.get("service_stranded") == m,
          f"faults: stranded {events[2]['stranded']} of {m}")
    check(full_degraded == [True],
          f"faults: full solves on a degraded problem {full_degraded}")
    check(ses.health.all_up and set(ses.sids) == admitted
          and not ses.engine.queued_sids and not mon.stranded_since,
          f"faults: after recovery {len(ses.sids)} live, queue "
          f"{ses.engine.queued_sids}, open {mon.stranded_since}")
    horizon = float(len(plan))
    avail = mon.availability(horizon, CHURN_R)
    check(avail < 1.0 and mon.stranded_service_s > 0,
          f"faults: availability {avail}")
    launches_i = dict(pp.LAUNCHES)

    # (ii) a rack storm merged with a flash-crowd tick, replayed in waves
    ses2, mon2, _ = adopt(PlacementSpec(defrag_every=0))
    storm = dynamic.rack_storm(topo, nodes=tg["storm"], t_fail=0.5,
                               outage_h=1.0)
    crowd = dynamic.flash_crowd_trace(CHURN_R, 1, WAVE_SIZE,
                                      rng=0)[CHURN_R:]
    timeline = dynamic.merge_timelines(storm, crowd)
    admitted2 = set(ses2.sids)
    for ev in crowd:
        (admitted2.add if ev.kind == "arrive" else admitted2.discard)(ev.sid)
    replayed, seen = [], {}

    def on_event(ev, res):
        key = id(res)
        if key in seen:                   # the rest of a wave's events
            return
        seen[key] = res                   # held, so no id is reused
        torch.cuda.synchronize()
        seconds = time.perf_counter() - clock["t0"]
        is_wave = isinstance(res, dynamic.WaveResult)
        what = f"faults (ii): {'wave' if is_wave else ev.kind}"
        want = (admitted2 if is_wave or ev.t > 1.0
                else set(range(CHURN_R)))
        launches = {k: v - clock["launches"][k]
                    for k, v in pp.LAUNCHES.items()}
        resolves = len(timer.resolves) - clock["resolves"]
        check(launches["placement_power"] == resolves,
              f"{what}: {launches} for {resolves} re-solves")
        replayed.append(dict(
            kind="wave" if is_wave else ev.kind,
            target=None if is_wave else ev.target,
            method=(res.result if is_wave else res).method,
            seconds=seconds, resolves=resolves, launches=launches,
            **timer.take_split(seconds), **held(ses2, what, want)))
        clock.update(t0=time.perf_counter(), launches=dict(pp.LAUNCHES),
                     resolves=len(timer.resolves))

    clock = dict(launches=dict(pp.LAUNCHES))
    with timer:
        clock.update(t0=time.perf_counter(), resolves=len(timer.resolves))
        t0 = time.perf_counter()
        ses2.replay(timeline, lambda sid: churn_vsr(sources, sid),
                    on_event=on_event, waves=True)
        replay_s = time.perf_counter() - t0
    check([e["kind"] for e in replayed]
          == ["fail_node"] * STORM_NODES + ["wave"]
          + ["recover_node"] * STORM_NODES,
          f"faults (ii): events {[e['kind'] for e in replayed]}")
    check(mon2.get("node_failed") == mon2.get("node_recovered")
          == STORM_NODES
          and ses2.health.all_up and set(ses2.sids) == admitted2
          and ses2.n_live == CHURN_R and not mon2.stranded_since,
          f"faults (ii): monitor {mon2.counters}, {ses2.n_live} live")
    launches = dict(pp.LAUNCHES)
    rescore(ses2, ses2.result)            # after the count: a check only
    emit("faults_city_p468_R64",
         cut=f"R={CHURN_R} live services (phase 3 runs 1024), 8 handler "
             f"calls and a rack storm of {STORM_NODES} node (cut from 2 in "
             "PR 32 to pay for phase 5h) with one 16-event wave: each "
             "re-solve's polish sweeps every free VM, padded to R x (V - 1) "
             "positions, twice",
         P=ses.problem.P, N=ses.problem.N, R=ses.problem.R,
         V=ses.problem.V, targets=tg, stranded_services=m,
         defrag_every=7 + m, adopted_objective=adopted.objective,
         events=events, events_s=sum(e["seconds"] for e in events),
         monitor=mon.snapshot(), stranded_service_h=mon.stranded_service_s,
         availability=avail, horizon_h=horizon,
         launches_i=launches_i, storm=replayed, storm_replay_s=replay_s,
         storm_monitor=mon2.snapshot(), launches=launches,
         seconds_total=time.perf_counter() - t_all)
    return launches


# phase 3g: four city-scale regions -- each the city_p468 fabric (P_r = 466)
# -- over the 14-node NSFNET core (merged P = 1864, N = 486); 16 IoT
# sources a region (64 in all, as city_p468's).  (i) a batch of 512 VSRs,
# cut from phase 3's 1024 for the script's time: its lockstep sweeps are
# host-bound (~24 ms a position; R pads to 256 a region instead of 512,
# half the positions); (ii) the coordinator, churn and region faults at 4
# live services a region: cut from 256, because every churn or fault call
# re-solves once per service it touches, 1.7-4 s a re-solve on the card
FED_TOPO = dict(n_regions=4, n_olt=16, onus_per_olt=4, iot_per_onu=7)
FED_SOURCES = 16
FED_R = 512
FED_LIVE = 4
FED_PROFILE_POSITIONS = 64
# (ii)'s coordinator passes: on the H100 every migration off region 0 RAISED
# its watts (the cut links' egress path draws idle network power at home),
# so the default 4 passes all ran (34 s at 8 services a region); one pass
# shows the migration and its re-solve
FED_COORD_PASSES = 1
# (ii)'s wave: a departure and an arrival in each of these regions (cut in
# PR 32 from one departure in every region and two arrivals in each of 2
# and 3, to pay for phase 5h: each region touched re-solves, ~4.5 s)
FED_WAVE_REGIONS = (2, 3)


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def fed_sources(part, rng) -> list:
    """``FED_SOURCES`` IoT sources of each region (merged ids), drawn from
    ``rng`` region by region."""
    topo = part.topo
    iot = set(topo.layer_indices("iot"))
    return [rng.choice([p for p in reg.proc_ids if p in iot],
                       size=FED_SOURCES, replace=False)
            for reg in part.regions]


class FedTimer:
    """Inside ``with``: the batched solves' seconds split into sweeps (from
    the end of the warm-start init to the exact refresh), anneal and the
    float64 breakdowns, by wrapping the federation module's functions with
    synchronized timers; ``args`` / ``out`` keep the last batched solve's
    inputs and result."""

    NAMES = ("_init_states", "_anneal_scans", "federated_breakdown",
             "_solve_regions")

    def __init__(self):
        from repro_torch.core import federation
        self.mod = federation
        self.orig = {n: getattr(federation, n) for n in self.NAMES}
        self.inits: list = []
        self.split = {"sweeps": 0.0, "anneal": 0.0, "breakdown": 0.0}
        self.args = self.out = None

    def _wrap(self, name):
        fn = self.orig[name]

        def run(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            t1 = time.perf_counter()
            if name == "_init_states":
                self.inits.append((t0, t1))
                if len(self.inits) % 2 == 0:        # the exact refresh
                    self.split["sweeps"] += t0 - self.inits[-2][1]
            elif name == "_anneal_scans":
                self.split["anneal"] += t1 - t0
            elif name == "federated_breakdown":
                self.split["breakdown"] += t1 - t0
            else:
                self.args, self.out = args, out
            return out
        return run

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.mod, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)
        return False


def lockstep_profile(args, n_pos: int = FED_PROFILE_POSITIONS) -> dict:
    """Device activity of ``n_pos`` lockstep sweep positions of a batched
    solve (``args``: its ``_solve_regions`` inputs): wall ms, CUDA kernels
    and the device's busy share per position, as phase 3's
    ``sweep_profile`` for the flat sweep."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import federation
    problems, auxes, X0, el, pos = args[:5]
    st = federation._init_states(problems, X0)
    step = lambda st, k: federation._lockstep(problems, auxes, st,
                                              pos[:, k, 0], pos[:, k, 1], el)
    for k in range(8):
        st = step(st, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(8, 8 + n_pos):
            st = step(st, k % pos.shape[1])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the raw event list (``device_events``): the FunctionEvent tree costs
    # ~65 us an event on the host, seconds at ~33 k kernels
    kernels = [ms for v in device_events(prof, tree=False).values()
               for ms in v]
    busy_s = sum(kernels) * 1e-3
    return {"positions": n_pos, "regions": int(X0.shape[0]),
            "ms_per_position": wall_s / n_pos * 1e3,
            "kernels_per_position": len(kernels) / n_pos,
            "device_busy_share": busy_s / wall_s if kernels else None}


def phase_federation(device: str = "cuda", topo_kw: dict = FED_TOPO,
                     n_batch: int = FED_R, n_live: int = FED_LIVE,
                     profile: bool = True) -> dict:
    """Phase 3g: the federation at four city-scale regions, through
    ``FederatedSession``.

    (i) Batch: ``federated_scale(4, 16, 4, 7)`` (4 regions of P_r = 466,
    merged P = 1864), ``FED_R`` = 512 VSRs of 3 VMs (``random_vsrs``, numpy seed 0,
    sources 16 IoT nodes a region), cfn-milp "standard" (the batched
    effort: 2 lockstep coordinate sweeps + a 2000-step x 8-chain delta
    anneal a region), no budgets.  Seconds for the topology and partition
    builds, the batched sweeps, the batched anneal and the float64
    breakdowns; a ``lockstep_profile``; regional and inter-region watts.
    Checks: regional + inter-region == total (1e-9 x total), the total
    equal to the float64 oracle of the merged placement (1e-7 x
    max(1, |oracle|), the reference's acceptance bound), no VM of the
    batch on a pad node.

    (ii) The coordinator, churn and region faults at 4 live services a
    region: a budget-free solve gives region 0's watts W0; a session with
    ``region_power_budget_w = [W0 - 1, 1e9, 1e9, 1e9]`` (one coordinator
    pass, ``FED_COORD_PASSES``), a ``PlacementMonitor`` and per-region
    monitors solves the same services (the coordinator must migrate),
    then 4 ``add``s homed in regions 2 and 3 (one with ``region=``), 2
    ``remove``s, one ``apply_wave`` of an arrival and a departure in
    each region of ``FED_WAVE_REGIONS``,
    ``defrag()`` (the regional full solves: ``fused_anneal``),
    ``fail_region(1)`` / ``recover_region(1)``, ``brownout_region(2, w)``
    under region 2's watts / ``brownout_end_region(2)``, and
    ``EnergyAwareScheduler(session=...)`` with two h2o-danube-3-4b
    services of 2 stages at 5 tokens/s from regions 2 and 3, one then
    removed.  Per call: seconds, launches, fleet watts.  After every call:
    every region engine's commit within 5e-2 + 1e-5 |obj| of its float64
    oracle and the fleet's exact objective within that of the merged
    placement's oracle, conservation as (i), each service's free VMs in
    its assigned region (an ``add(region=)`` lands there) and its
    input VM at its source, no live service homed in a down region, live +
    queued == admitted, and the ``fleet_monitor()`` roll-up equal to the
    monitors' sum.  Returns the phase's launches."""
    import torch
    from repro_torch.api import FederatedSession, PlacementSpec
    from repro_torch.configs.h2o_danube_3_4b import CONFIG as DANUBE
    from repro_torch.core import federation, power, topology, vsr
    from repro_torch.fault import PlacementMonitor
    from repro_torch.kernels import placement_power as pp, ref
    from repro_torch.telemetry import Telemetry
    from repro_torch.serve.scheduler import EnergyAwareScheduler, Service
    t_all = time.perf_counter()
    pp.reset_launches()
    t0 = time.perf_counter()
    topo = topology.federated_scale(**topo_kw)
    topology_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = federation.RegionPartition.from_topology(topo)
    part.padded_substrates(device)
    _sync()
    partition_s = time.perf_counter() - t0
    merged_sub = power.substrate_arrays(topo, "cpu")
    rng = np.random.default_rng(0)
    srcs = fed_sources(part, rng)

    def conserved(bd, what):
        check(abs(bd.regional_w.sum() + bd.inter_region_w - bd.total_w)
              <= 1e-9 * max(1.0, bd.total_w),
              f"{what}: regional {bd.regional_w.sum()} + inter "
              f"{bd.inter_region_w} != total {bd.total_w}")

    def merged_oracle(services, X) -> float:
        vs = vsr.concat_all(services)
        prob = power.build_problem(topo, vs, substrate=merged_sub)
        return ref.placement_objective_f64_links(
            prob, np.asarray(X)[:vs.R, :vs.V])

    # (i) the batch at full width
    batch = vsr.random_vsrs(n_batch, rng=rng, n_vms=3,
                            source_nodes=np.concatenate(srcs))
    ses = FederatedSession(topo, PlacementSpec(), device=device,
                           partition=part)
    with FedTimer() as timer:
        t0 = time.perf_counter()
        res = ses.solve(batch)
        _sync()
        solve_s = time.perf_counter() - t0
    bd = res.breakdown
    conserved(bd, "federation (i)")
    services = [vsr.VSRBatch(F=batch.F[i:i + 1], H=batch.H[i:i + 1],
                             src=batch.src[i:i + 1],
                             input_vm=batch.input_vm[i:i + 1])
                for i in range(batch.R)]
    f64 = merged_oracle(services, res.X)
    check(abs(f64 - bd.objective) <= 1e-7 * max(1.0, abs(f64)),
          f"federation (i): objective {bd.objective} vs float64 oracle {f64}")
    Xb = timer.out[0]
    for g, reg in enumerate(part.regions):
        check(bool((Xb[g] < reg.P).all()),
              f"federation (i): region {g} placed a VM on a pad node")
    G, R_pad, V_pad = (int(s) for s in timer.args[2].shape)
    batch_out = dict(
        P=topo.P, N=topo.N, P_region=[r.P for r in part.regions],
        R_pad=R_pad, V_pad=V_pad,
        lockstep_positions=2 * R_pad * max(1, V_pad - 1),
        per_region=np.bincount(res.assignments, minlength=G).tolist(),
        topology_s=topology_s, partition_s=partition_s, solve_s=solve_s,
        sweeps_s=timer.split["sweeps"], anneal_s=timer.split["anneal"],
        breakdown_s=timer.split["breakdown"],
        regional_w=bd.regional_w.tolist(), inter_region_w=bd.inter_region_w,
        total_w=bd.total_w, objective=bd.objective, f64_objective=f64,
        violation=bd.violation, region_obj=res.region_obj.tolist(),
        migrations=res.migrations)
    if profile:
        batch_out["sweep_profile"] = lockstep_profile(timer.args)
    launches_i = dict(pp.LAUNCHES)
    del ses, res, timer, Xb

    # (ii) coordinator, churn and region faults at n_live a region
    live = vsr.concat_all([vsr.random_vsrs(n_live, rng=rng, n_vms=3,
                                           source_nodes=s) for s in srcs])
    live_svcs = [vsr.VSRBatch(F=live.F[i:i + 1], H=live.H[i:i + 1],
                              src=live.src[i:i + 1],
                              input_vm=live.input_vm[i:i + 1])
                 for i in range(live.R)]
    t0 = time.perf_counter()
    probe = FederatedSession(topo, PlacementSpec(), device=device,
                             partition=part).solve(live)
    probe_s = time.perf_counter() - t0
    W0 = float(probe.breakdown.regional_w[0])
    budget = [W0 - 1.0] + [1e9] * (part.G - 1)
    mon, tel = PlacementMonitor(), Telemetry()
    ses = FederatedSession(topo, PlacementSpec(region_power_budget_w=budget),
                           device=device, partition=part, monitor=mon,
                           telemetry=tel)
    ses.MAX_COORD_PASSES = FED_COORD_PASSES
    regional = ses.attach_region_monitors()
    svc_of = {i: s for i, s in enumerate(live_svcs)}
    admitted = set(range(live.R))
    calls = []

    def held(what) -> dict:
        """The checks after one call; returns its numbers."""
        bd = ses.breakdown()
        conserved(bd, what)
        for g, eng in ses._engines.items():
            if eng.problem is None:
                continue
            obj = eng.objective()
            f = ref.placement_objective_f64_links(eng.problem, eng.X)
            check(abs(obj - f) <= 5e-2 + 1e-5 * abs(f),
                  f"{what}: region {g} objective {obj} vs float64 {f}")
        f = merged_oracle([svc_of[s] for s in ses.sids], ses.X)
        check(abs(bd.objective - f) <= 5e-2 + 1e-5 * abs(f),
              f"{what}: fleet objective {bd.objective} vs float64 {f}")
        X = ses.X
        for row, sid in enumerate(ses.sids):
            plan = ses._plans[sid]
            reg = part.regions[plan.assigned]
            iv = int(plan.vsr.input_vm[0])
            free = [v for v in range(plan.vsr.V) if v != iv]
            check(X[row, iv] == int(plan.vsr.src[0])
                  and bool(np.isin(X[row, free], reg.proc_ids).all()),
                  f"{what}: sid {sid} off its region {plan.assigned}")
            check(plan.home not in ses.down_regions,
                  f"{what}: sid {sid} live in down region {plan.home}")
        lv, qd = set(ses.sids), set(ses.queued_sids)
        check(lv | qd == admitted and not lv & qd,
              f"{what}: live {sorted(lv)} + queued {sorted(qd)} != "
              f"admitted {sorted(admitted)}")
        fleet = ses.fleet_monitor()
        for kind, n in fleet.counters.items():
            check(n == mon.get(kind) + sum(m.get(kind)
                                           for m in regional.values()),
                  f"{what}: roll-up {kind} {n}")
        return dict(total_w=bd.total_w, regional_w=bd.regional_w.tolist(),
                    inter_region_w=bd.inter_region_w, objective=bd.objective,
                    f64_objective=f, n_live=len(lv), queued=sorted(qd))

    def call(what, fn) -> object:
        launch0 = dict(pp.LAUNCHES)
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        seconds = time.perf_counter() - t0
        calls.append(dict(call=what, seconds=seconds,
                          launches={k: v - launch0[k]
                                    for k, v in pp.LAUNCHES.items()},
                          returned=out if isinstance(out, int) else None,
                          **held(what)))
        return out

    def arrival(sid, g, k=0):
        sv = vsr.random_vsrs(1, rng=3000 + sid, n_vms=3,
                             source_nodes=[int(srcs[g][k])])
        svc_of[sid] = sv
        admitted.add(sid)
        return sv

    res = call("solve", lambda: ses.solve(live))
    check(res.migrations >= 1 and mon.get("cross_region_migration")
          == res.migrations and mon.get("region_budget_breach") >= 1,
          f"federation (ii): coordinator migrations {res.migrations}, "
          f"monitor {mon.counters}")
    coord = dict(W0=W0, budget_w=budget[0], migrations=res.migrations,
                 breaches=mon.get("region_budget_breach"),
                 region0_w=float(res.breakdown.regional_w[0]),
                 cut_links=len(ses._cuts_merged()),
                 assignments=np.bincount(res.assignments,
                                         minlength=part.G).tolist(),
                 probe_s=probe_s)
    def local(g):
        """The first live service homed and hosted in region ``g``."""
        return next(s for s in ses.sids if ses._plans[s].home == g
                    and not ses._plans[s].migrated)

    nid = live.R
    for k, (g, region) in enumerate(((2, None), (3, None), (2, None),
                                     (3, 2))):
        sid = nid + k
        sv = arrival(sid, g, k)
        out = call(f"add({sid}, home {g}"
                   + (f", region={region})" if region is not None else ")"),
                   lambda: ses.add(sv, sid=sid, region=region))
        check(out is not None and (region is None
                                   or ses.assignment(sid) == region),
              f"federation (ii): add {sid} refused or misplaced")
    nid += 4
    for sid in (next(s for s in ses.sids if ses._plans[s].migrated),
                local(2)):
        admitted.discard(sid)
        call(f"remove({sid})", lambda: ses.remove(sid))
    deps = [local(g) for g in FED_WAVE_REGIONS]
    arr = [(arrival(nid + k, g, k), nid + k)
           for k, g in enumerate(FED_WAVE_REGIONS)]
    admitted.difference_update(deps)
    wr = call(f"apply_wave({len(arr)} arrivals, {len(deps)} departures)",
              lambda: ses.apply_wave(arr, deps))
    check(sorted(wr.admitted) == [nid + k for k in range(len(arr))]
          and not wr.rejected and not wr.queued and wr.departed == deps,
          f"federation (ii): wave {wr}")
    nid += len(arr)
    n0 = dict(pp.LAUNCHES)
    call("defrag()", ses.defrag)
    check(pp.LAUNCHES["fused_anneal"] > n0["fused_anneal"],
          "federation (ii): defrag launched no fused_anneal")
    homed1 = [s for s in ses.sids if ses._plans[s].home == 1]
    ses.tick(1.0)
    n_evac = call("fail_region(1)", lambda: ses.fail_region(1))
    check(set(homed1) <= set(ses.queued_sids)
          and mon.get("region_failed") == 1,
          f"federation (ii): fail_region stranded {ses.queued_sids}")
    ses.tick(2.0)
    n_back = call("recover_region(1)", lambda: ses.recover_region(1))
    check(n_back == len(homed1) and not ses.queued_sids
          and not mon.stranded_since,
          f"federation (ii): recovered {n_back} of {len(homed1)}")
    w2 = float(ses.region_watts()[2])
    shed = call(f"brownout_region(2, {w2 - 1.0})",
                lambda: ses.brownout_region(2, w2 - 1.0))
    # within the budget, or best effort: a shed that cannot cool the
    # region further stops
    check(mon.get("brownout") == 1
          and (float(ses.region_watts()[2]) <= w2 - 1.0 or shed >= 1),
          f"federation (ii): brownout shed {shed}, region 2 at "
          f"{float(ses.region_watts()[2])} W")
    call("brownout_end_region(2)", lambda: ses.brownout_end_region(2))
    sched = EnergyAwareScheduler(topo, session=ses)
    served = [Service(f"danube-r{g}", DANUBE, tokens_per_s=5.0, n_stages=2,
                      source_node=int(srcs[g][0])) for g in (2, 3)]
    for sv in served:
        sid = ses._next_sid
        svc_of[sid] = sched._to_vsr(sv)
        admitted.add(sid)
        pls = call(f"scheduler add {sv.name}",
                   lambda: sched.add_service(sv))
        check(ses.sids[-1] == sid, f"federation (ii): {sv.name} refused")
    for p, g in zip(pls, (2, 3)):
        nodes = set(part.regions[g].topo.proc_names)
        check(p.power_w > 0 and all(n in nodes for n in p.stage_nodes),
              f"federation (ii): {p.service} left region {g}")
    check(sched.total_power_w() == ses.power_w(),
          "federation (ii): scheduler fleet watts")
    gone = next(s for s, sv in sched._by_sid.items()
                if sv.name == served[0].name)
    admitted.discard(gone)
    pls = call(f"scheduler remove {served[0].name}",
               lambda: sched.remove_service(served[0].name))
    check([p.service for p in pls] == [served[1].name],
          f"federation (ii): scheduler after removal {pls}")
    launches = dict(pp.LAUNCHES)
    for name in MAIN_PATH_KERNELS:
        check(launches[name] > 0,
              f"federation: kernel {name} was not launched")
    conservation = []
    for smp in tel.ledger.samples:
        err = abs(sum(smp["region_w"].values()) - smp["total_w"])
        conservation.append(err / smp["total_w"])
        check(err <= 1e-9 * smp["total_w"],
              f"federation (ii): ledger sample {smp} regions + "
              f"inter_region off the total by {err}")
    check(len(tel.ledger.samples) == tel.counters["span.federated_add"]
          + tel.counters["span.federated_remove"]
          + tel.counters["span.federated_wave"]
          + tel.counters["span.federated_solve"],
          f"federation (ii): {len(tel.ledger.samples)} ledger samples, "
          f"spans {tel.counters}")
    emit("federation_4x_city_p468",
         cut=f"(i) {n_batch} VSRs (cut from phase 3's 1024 for the "
             "script's time: the lockstep sweeps are host-bound, and R "
             "pads to half the positions), its lockstep profile read from "
             "the profiler's raw event list, not its FunctionEvent tree "
             f"(~65 us an event on the host); (ii) {n_live} live services "
             "a region: a region failure re-solves once per stranded or "
             "evacuated service; its wave touches regions "
             f"{list(FED_WAVE_REGIONS)} (cut from all four in PR 32 to pay "
             "for phase 5h)",
         batch=batch_out, launches_i=launches_i, coordinator=coord,
         calls=calls, evacuated=n_evac,
         fleet_monitor=ses.fleet_monitor().snapshot(),
         ledger=dict(samples=len(tel.ledger.samples),
                     max_conservation_rel_err=max(conservation),
                     energy=tel.ledger.integrate(),
                     spans={k: v for k, v in tel.counters.items()
                            if k.startswith("span.")}),
         launches=launches, seconds_total=time.perf_counter() - t_all)
    return launches


# phase 3h: the JAX package's telemetry-overhead recipe
# (benchmarks/kernel_bench.py::telemetry_overhead) at phase 3e's size: 64
# live services (the reference runs 1024) and replace waves of 16 events
# (the reference's 64), one warm and four measured, two engines an arm
OBS_LIVE = 64
OBS_WAVE = 16
OBS_WAVES = 4
OBS_RUNS = 2
MICRO_REPS = 20000


def phase_telemetry() -> tuple:
    """Phase 3h: the telemetry plane's overhead on the churn-wave workload,
    through ``OnlineEmbedder``.

    city_p468; 64 services of 3 VMs (numpy seed = sid, sources the first
    quarter of the IoT nodes) adopted from the reference's least-loaded
    placement (each VM on the least-loaded mf / af / cdc node);
    ``flash_crowd_trace(64, 5, 16, rng=0, replace=True)``: one warm wave,
    then four measured waves of 8 departures and 8 arrivals; spec
    ``effort="quick", anneal_steps=0, defrag_every=0, polish_sweeps=1``.
    Four fresh engines from generator seed 0 in turns: telemetry off, on,
    off, on (on: spans, the energy ledger with the per-tenant split every
    8 commits, the shape and launch attribution, a JSONL stream).  Per
    run: seconds per measured wave (synchronized); per arm the best of
    its two totals; ``overhead_pct`` of on over off.  Checks: every run's
    placement byte-equal to the first's, no fresh shape fingerprint in a
    measured wave, each stream valid (``validate_events`` and the CLI's
    ``validate``), ``compiles.agree`` and ``launches.agree`` (the kernel
    launches mirrored), ledger ticks equal to commits.  The 2% bar of the
    reference is printed, not checked: host-driven times vary between
    runs.  Returns the phase's launches and its two telemetry runs."""
    import torch
    from repro_torch.api import PlacementSpec
    from repro_torch.core import dynamic, solvers, vsr
    from repro_torch.kernels import placement_power as pp
    from repro_torch.telemetry import Telemetry, load_events, validate_events
    t_all = time.perf_counter()
    topo = city_sources()[0]
    iot = topo.layer_indices("iot")
    srcs = iot[:max(8, len(iot) // 4)]
    mk = lambda sid: vsr.random_vsrs(1, rng=np.random.default_rng(sid),
                                     n_vms=3, source_nodes=srcs)
    events = dynamic.flash_crowd_trace(OBS_LIVE, OBS_WAVES + 1, OBS_WAVE,
                                       rng=0, replace=True)
    groups = list(dynamic.iter_waves(events))
    warm_wave, measured = groups[1], groups[2:]
    check(len(measured) == OBS_WAVES
          and all(len(g) == OBS_WAVE for g in measured),
          f"telemetry: waves {[len(g) for g in groups]}")
    services = [mk(sid) for sid in range(OBS_LIVE)]
    hosts = [p for layer in ("mf", "af", "cdc")
             for p in topo.layer_indices(layer)]
    load = {p: 0.0 for p in hosts}
    X0 = np.zeros((OBS_LIVE, 3), np.int32)
    for r, sv in enumerate(services):
        for v in range(3):
            p = min(hosts, key=load.get)
            X0[r, v] = p
            load[p] += float(sv.F[0, v])
    spec = PlacementSpec(effort="quick", anneal_steps=0, defrag_every=0,
                         polish_sweeps=1)

    def split(group):
        return ([(mk(ev.sid), ev.sid) for ev in group
                 if ev.kind == "arrive"],
                [ev.sid for ev in group if ev.kind == "depart"])

    def replay(tel) -> dict:
        eng = dynamic.OnlineEmbedder(
            topo, spec=spec, generator=solvers.default_generator(0),
            device="cuda", telemetry=tel)
        eng.bootstrap(services, X0=X0)
        eng.tick(1.0)                  # an hour a wave, for the ledger
        eng.apply_wave(*split(warm_wave))
        before, launch0 = dict(solvers.TRACE_COUNTS), dict(pp.LAUNCHES)
        waves = []
        for i, group in enumerate(measured):
            arrs, deps = split(group)
            eng.tick(2.0 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wr = eng.apply_wave(arrs, deps)
            torch.cuda.synchronize()
            waves.append(time.perf_counter() - t0)
            check(wr.admitted == [sid for _, sid in arrs]
                  and wr.departed == deps and eng.n_live == OBS_LIVE,
                  f"telemetry: wave {wr}")
        fresh = {k: v - before.get(k, 0)
                 for k, v in solvers.TRACE_COUNTS.items()
                 if v != before.get(k, 0)}
        check(not fresh, f"telemetry: measured waves saw fresh shapes "
              f"{fresh}")
        return dict(eng=eng, waves_s=waves, total_s=sum(waves),
                    launches={k: v - launch0[k]
                              for k, v in pp.LAUNCHES.items()})

    out_dir = ROOT / "build" / "telemetry"
    out_dir.mkdir(parents=True, exist_ok=True)
    pp.reset_launches()
    runs, tels = [], []
    for i in range(OBS_RUNS):
        runs.append(dict(arm="off", **replay(None)))
        path = out_dir / f"run{i}.jsonl"
        path.unlink(missing_ok=True)
        tel = Telemetry(jsonl_path=str(path), attribution_every=8)
        run = dict(arm="on", **replay(tel))
        rep = tel.report()
        tel.close()
        evs = load_events(str(path))
        problems = validate_events(evs)
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry", "validate",
             str(path)], capture_output=True, text=True,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
        check(not problems and cli.returncode == 0,
              f"telemetry: stream {path.name}: {problems[:3]} "
              f"{cli.stderr[-400:]}")
        check(rep["compiles"]["agree"] and rep["launches"]["agree"]
              and rep["launches"]["recorded"].get("placement_power", 0)
              > 0, f"telemetry: attribution {rep['compiles']} "
              f"{rep['launches']}")
        n_commits = len(run["eng"].stats)
        check(len(tel.ledger.samples) == n_commits
              == rep["counters"].get("span.apply_wave", 0) + 1,
              f"telemetry: {len(tel.ledger.samples)} ledger ticks for "
              f"{n_commits} commits")
        tels.append(tel)
        run.update(events_emitted=len(evs), jsonl_bytes=path.stat().st_size,
                   ledger_ticks=len(tel.ledger.samples), commits=n_commits,
                   compiles=rep["compiles"], launch_attribution=rep[
                       "launches"], energy=rep["energy"],
                   span_ms={k: v["sum"] for k, v in rep["hists"].items()
                            if k.startswith("span.")})
        runs.append(run)
    X = runs[0]["eng"].X.tobytes()
    check(all(r["eng"].X.tobytes() == X for r in runs),
          "telemetry: placements differ between the off and on runs")
    launches = dict(pp.LAUNCHES)
    check(launches["placement_power"] >= len(runs) * (OBS_WAVES + 1),
          f"telemetry: launches {launches}")
    # per-call cost of the primitives on a live in-memory registry
    micro, mt = {}, Telemetry()
    for name, fn in (("counter_inc", lambda: mt.inc("bench.counter")),
                     ("histogram_observe",
                      lambda: mt.observe("bench.lat_ms", 1.5))):
        t0 = time.perf_counter()
        for _ in range(MICRO_REPS):
            fn()
        micro[name] = (time.perf_counter() - t0) / MICRO_REPS * 1e9
    t0 = time.perf_counter()
    for _ in range(MICRO_REPS):
        with mt.span("bench"):
            pass
    micro["span"] = (time.perf_counter() - t0) / MICRO_REPS * 1e9
    best = {arm: min(r["total_s"] for r in runs if r["arm"] == arm)
            for arm in ("off", "on")}
    n_ev = OBS_WAVES * OBS_WAVE
    emit("telemetry_city_p468_R64",
         cut=f"{OBS_LIVE} live services and waves of {OBS_WAVE} events "
             "(the reference's recipe runs 1024 and 64): a wave's polish "
             "sweep costs ~9.5 ms a position on the card, R x (V - 1) "
             "positions",
         runs=[{k: v for k, v in r.items() if k != "eng"} for r in runs],
         best_total_s=best,
         events_per_s={arm: n_ev / t for arm, t in best.items()},
         overhead_pct=100.0 * (best["on"] - best["off"]) / best["off"],
         reference_bar_pct=2.0, identical_placements=True,
         micro_ns_per_call=micro, launches=launches,
         seconds_total=time.perf_counter() - t_all)
    return launches, tels


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
# deepseek-v2's MLA attention as its prefill expands it: 128 heads, K of
# 128 + 64 (rope) dims, V of 128
MLA_HEADS, MLA_QK_DIM, MLA_V_DIM = 128, 192, 128


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


def sdpa_call(q, k, v, q_pos, kv_pos, causal=True):
    """SDPA on the same inputs (GQA where q has more heads than k,
    boolean mask from the positions, ``_attended``'s): the library
    yardstick, timed here and used nowhere in the port."""
    import torch.nn.functional as F
    mask = _attended(q_pos, kv_pos, causal).contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


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
# D = 32): B, H, KH, Sq, Skv, D, Dv, causal, window, cap -- bf16.  Head
# dims that are not a multiple of 64 ride in zero-padded TMA boxes
WGMMA_CASES = [
    (1, 8, 8, 128, 256, 64, 64, True, None, 50.0),    # G 1, softcap
    (2, 8, 4, 200, 200, 64, 64, True, 64, 30.0),      # window and softcap
    (2, 10, 2, 33, 65, 64, 64, True, 16, None),       # G 5 (hymba), ragged
    (1, 8, 2, 100, 80, 128, 128, False, None, None),  # non-causal
    (1, 256, 1, 2, 70, 64, 64, True, None, None),     # G > 128
    (2, 32, 8, 130, 200, 120, 120, True, 64, 30.0),   # D 120, window, cap
    (2, 4, 1, 96, 160, 32, 32, True, 32, None),       # D 32 (the smoke)
    (2, 4, 4, 64, 100, 48, 32, True, None, None),     # (48, 32): MLA smoke
    (1, 8, 2, 100, 150, 128, 64, True, None, 50.0),   # (128, 64)
    (2, 8, 2, 70, 70, 120, 120, False, None, None),   # Skv 70: one partial
]
# fully masked rows (q before every kv position) per kernel: name, dtype,
# Sq, D, Dv
MASKED_CASES = [
    ("simt", "float32", 16, 16, 16),
    ("wgmma", "bfloat16", 16, 64, 64),
    ("wgmma", "bfloat16", 20, 120, 120),
    ("wgmma", "bfloat16", 20, 48, 32),
    ("split_kv", "float32", 2, 64, 64),
]
# h2o-danube-3-4b's prefill (phase 5e): 32 query heads on 8 kv heads of
# 120, its 4096-slot window (no pair masked at these positions)
DANUBE_HEADS, DANUBE_KV_HEADS, DANUBE_DIM = 32, 8, 120


def hymba_attention(held, rnd) -> dict:
    """hymba-1.5b's attention branch (phase 5c) at its serving shapes, on
    its local layers' ring buffer of ``window`` = 1024 slots: 25 query
    heads on 5 KV heads (G 5), D 64, 8 prompts.  Prefill fills slots
    0-1023 (the wgmma kernel); the first decode step, position 1024,
    wraps to slot 0, so split-KV reads slot 0 = 1024 and slots 1-1023 =
    1-1023.  Each kernel held against both plain versions (prefill 2e-2,
    decode 2e-3 as the qwen shape's) and timed beside SDPA (CUDA-graph
    replays); a value planted in the wrapped slot 0 must reach the decode
    output.  ``held`` and ``rnd`` are phase 4's."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    cfg = configs.get("hymba-1.5b")
    B, S, W = SERVE_B, SERVE_S, cfg.sliding_window
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    check(W == S, f"flash hymba: window {W}, prompt {S}")
    bf, i32, dev = torch.bfloat16, torch.int32, torch.device("cuda")
    k, v = rnd((B, W, KH, D), bf), rnd((B, W, KH, D), bf)
    out = {}
    for name, Sq, kernel in (("hymba_prefill", S, "wgmma"),
                             ("hymba_decode_wrapped", 1, "split_kv")):
        q = rnd((B, Sq, H, D), bf)
        if Sq == S:
            qp = torch.arange(S, dtype=i32, device=dev)
            kp = qp.clone()
        else:
            qp = torch.tensor([W], dtype=i32, device=dev)
            kp = torch.arange(W, dtype=i32, device=dev)
            kp[0] = W
        check(fa.choose_kernel(bf, D, D, Sq * H // KH) == kernel,
              f"flash {name}: the dispatch does not choose {kernel}")
        tol = 2e-2 if Sq == S else 2e-3
        rec = {"shape": [B, H, KH, Sq, W, D], "window": W, "kernel": kernel,
               kernel: held(q, k, v, qp, kp, tol, window=W)}
        reps = 20 if Sq == S else 200
        rec[kernel]["graph_ms"] = graph_ms(
            lambda: fa.flash_attention_cuda(q, k, v, qp, kp, window=W), reps)
        # at these positions the window masks no pair (q - kv <= 1023), so
        # SDPA's causal mask computes the same function
        rec["library_graph_ms"] = graph_ms(sdpa_call(q, k, v, qp, kp), reps)
        rec["bound_ms"], rec["bound_by"] = flash_attention_bound(
            q, k, v, qp, kp)
        out[name] = rec
    vp = v.clone()
    vp[:, 0] = 4.0
    got = fa.flash_attention_cuda(q, k, vp, qp, kp, window=W).float()
    want = fa.attention_plain(q, k, vp, q_positions=qp, kv_positions=kp,
                              window=W)
    kp_drop = kp.clone()
    kp_drop[0] = -1
    drop = fa.attention_plain(q, k, vp, q_positions=qp,
                              kv_positions=kp_drop, window=W)
    err = float((got - want.to(bf).float()).abs().max())
    gap = float((got - drop.to(bf).float()).abs().max())
    check(err <= 2e-3 and gap > 5e-3,
          f"flash hymba decode, planted wrapped slot 0: err {err}, gap "
          f"without it {gap}")
    out["hymba_decode_wrapped"]["planted_slot"] = {
        "max_abs_err": err, "max_abs_gap_without_slot": gap}
    return out


# phase 5d's attention shapes: whisper-base's 30-second window after its
# conv stem (n_audio_ctx = 1500 frames) and its decoder prompt of
# launch/specs.py::dec_len(1500) = max(64, int(1500 x 0.125)) = 187
# tokens; internvl2-2b's 256 patches before 768 text tokens, the 1024-slot
# prompt of the reference's token_specs at seq_len 1024
WHISPER_ENC_LEN, WHISPER_DEC_LEN = 1500, 187
VLM_TEXT_LEN = 768


def encdec_attention(held, rnd) -> dict:
    """The attention calls of phase 5d at their serving shapes, bf16, 8
    prompts: whisper-base's encoder (non-causal, 1500 x 1500 frames, H =
    KH = 8, D 64) and its cross-attention's prefill (187 queries at
    position 0 over the 1500 encoder slots) on the wgmma kernel, the
    cross-attention's decode step on split-KV (non-causal, its only mask
    the slots' positions), and internvl2-2b's causal prefill (H 16, KH 8,
    D 128; 1024 = 256 + 768 prompt slots written of a 1064-slot cache) on
    the wgmma kernel.  Each held against both plain versions (prefill
    2e-2, decode 2e-3), timed as CUDA-graph replays beside SDPA on the
    same function (the non-causal ones under the mask kv_pos >= 0), with
    the bound from this call's attended pairs.  ``held`` and ``rnd`` are
    phase 4's."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    bf, i32, dev = torch.bfloat16, torch.int32, torch.device("cuda")
    ar = lambda n: torch.arange(n, dtype=i32, device=dev)
    whisper, vlm = configs.get("whisper-base"), configs.get("internvl2-2b")
    B, E = SERVE_B, WHISPER_ENC_LEN
    S_vlm = vlm.vision_prefix_tokens + VLM_TEXT_LEN
    smax_vlm = S_vlm + SERVE_GEN + 8
    kp_vlm = torch.full((smax_vlm,), -1, dtype=i32, device=dev)
    kp_vlm[:S_vlm] = ar(S_vlm)
    zeros = lambda n: torch.zeros(n, dtype=i32, device=dev)
    # name: config, Sq, Skv, q positions, kv positions, causal, kernel
    cases = (
        ("whisper_encoder", whisper, E, E, ar(E), ar(E), False, "wgmma"),
        ("whisper_cross_prefill", whisper, WHISPER_DEC_LEN, E,
         zeros(WHISPER_DEC_LEN), ar(E), False, "wgmma"),
        ("whisper_cross_decode", whisper, 1, E, zeros(1), ar(E), False,
         "split_kv"),
        ("internvl2_prefill", vlm, S_vlm, smax_vlm, ar(S_vlm), kp_vlm, True,
         "wgmma"))
    out = {}
    for name, cfg, Sq, Skv, qp, kp, causal, kernel in cases:
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (rnd(s, bf) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                        (B, Skv, KH, D)))
        check(fa.choose_kernel(bf, D, D, Sq * H // KH) == kernel,
              f"flash {name}: the dispatch does not choose {kernel}")
        tol = 2e-2 if kernel == "wgmma" else 2e-3
        rec = {"shape": [B, H, KH, Sq, Skv, D], "causal": causal,
               "kernel": kernel,
               kernel: held(q, k, v, qp, kp, tol, causal=causal)}
        reps = 20 if kernel == "wgmma" else 200
        rec[kernel]["graph_ms"] = graph_ms(
            lambda: fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal),
            reps)
        rec["library_graph_ms"] = graph_ms(
            sdpa_call(q, k, v, qp, kp, causal), reps)
        rec["bound_ms"], rec["bound_by"] = flash_attention_bound(
            q, k, v, qp, kp, causal)
        rec["tflop_per_s"] = flash_attention_ops(
            q, k, v, qp, kp, causal) / (rec[kernel]["graph_ms"] * 1e-3) / 1e12
        out[name] = rec
    return out


def versus_simt(name, q, k, v, qp, kp, held, plains, faster=True,
                **kw) -> dict:
    """A bf16 prefill the dispatch sends to the wgmma kernel: held against
    both plain versions (2e-2) on the wgmma kernel and on the SIMT kernel
    forced, both timed in turns (SIMT, wgmma, wgmma, SIMT) as CUDA events
    around one call (``ms``) and CUDA-graph replays (``graph_ms``), beside
    SDPA under the causal mask (``kw``'s window must mask no pair here),
    both plain versions' times and the bound; with ``faster``, checked:
    wgmma faster than SIMT.  ``held`` and ``plains`` are phase 4's."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    check(fa.choose_kernel(q.dtype, D, Dv, S * H // KH) == "wgmma",
          f"flash {name}: the dispatch does not choose wgmma")
    rec = {"shape": [B, H, KH, S, k.shape[1], D, Dv], "kernel": "wgmma",
           **kw, "wgmma": held(q, k, v, qp, kp, 2e-2, **kw),
           "simt": held(q, k, v, qp, kp, 2e-2, kernel="simt", **kw)}
    call = {kn: (lambda kn=kn: fa.flash_attention_cuda(
                q, k, v, qp, kp, kernel=kn, **kw)) for kn in ("wgmma", "simt")}
    times = {kn: {"ms": [], "graph_ms": []} for kn in call}
    small = q.numel() < 1 << 20         # a launch-bound call: more reps
    for kn in ("simt", "wgmma", "wgmma", "simt"):
        reps = 200 if small else 3 if kn == "simt" else 20
        times[kn]["ms"].append(cuda_ms(call[kn], reps))
        times[kn]["graph_ms"].append(graph_ms(call[kn], reps))
    for kn in call:
        rec[kn].update(times[kn])
    sdpa = sdpa_call(q, k, v, qp, kp)
    rec["library_ms"] = cuda_ms(sdpa, 200 if small else 5)
    rec["library_graph_ms"] = [graph_ms(sdpa, 200 if small else 5)
                               for _ in range(2)]
    rec["plain_ms"] = cuda_ms(lambda: plains["wgmma"](
        q, k, v, q_positions=qp, kv_positions=kp, **kw), 2)
    rec["simt_plain_ms"] = cuda_ms(lambda: plains["simt"](
        q, k, v, q_positions=qp, kv_positions=kp, **kw), 2)
    rec["bound_ms"], rec["bound_by"] = flash_attention_bound(q, k, v, qp, kp)
    n_ops = flash_attention_ops(q, k, v, qp, kp)
    for kn in call:
        rec[kn]["tflop_per_s"] = n_ops / (
            min(rec[kn]["graph_ms"]) * 1e-3) / 1e12
        check(max(rec[kn]["graph_ms"]) > 0, f"flash {name}: no time")
    check(not faster or max(rec["wgmma"]["graph_ms"])
          < min(rec["simt"]["graph_ms"]),
          f"flash {name}: wgmma not faster than the SIMT kernel")
    return rec


def split_kv_lse(q, k, v, qp, kp) -> dict:
    """The split-KV kernel's lse output (``return_lse``: sharded serving's
    decode) at a decode shape: its lse against the plain version's
    (``split_kv_attention_plain``, atol 2e-3, -inf rows alike) and its
    output byte-equal to the launch without lse (checked); the two
    launches timed in turns as CUDA-graph replays (without, with, with,
    without)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    got, lse = fa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True)
    p_out, p_lse = fa.split_kv_attention_plain(
        q, k, v, q_positions=qp, kv_positions=kp, return_lse=True)
    fin = torch.isfinite(p_lse)
    err = float((lse[fin] - p_lse[fin]).abs().max())
    same = bool(torch.equal(got, fa.flash_attention_cuda(
        q, k, v, qp, kp, kernel="split_kv")))
    check(err <= 2e-3 and same and bool(torch.equal(
              torch.isneginf(lse), torch.isneginf(p_lse))),
          f"flash split_kv lse: err {err}, out equal without lse {same}")
    call = {True: lambda: fa.flash_attention_cuda(q, k, v, qp, kp,
                                                  return_lse=True),
            False: lambda: fa.flash_attention_cuda(q, k, v, qp, kp,
                                                   kernel="split_kv")}
    times = {True: [], False: []}
    for with_lse in (False, True, True, False):
        times[with_lse].append(graph_ms(call[with_lse], 200))
    return dict(max_abs_err=err, out_equal_without_lse=same,
                graph_ms_with=times[True], graph_ms_without=times[False],
                plain_ms=cuda_ms(lambda: fa.split_kv_attention_plain(
                    q, k, v, q_positions=qp, kv_positions=kp,
                    return_lse=True), 5))


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
    for B, H, KH, Sq, Skv, D, Dv, causal, window, cap in WGMMA_CASES:
        bf = torch.bfloat16
        q, k, v = (rnd(s, bf) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                        (B, Skv, KH, Dv)))
        qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=dev)
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)
        check(fa.choose_kernel(bf, D, Dv, Sq * H // KH) == "wgmma",
              f"flash wgmma case D {D} Dv {Dv}: not the dispatch's choice")
        out["wgmma_cases"].append(
            {"shape": [B, H, KH, Sq, Skv, D, Dv], "dtype": "bfloat16",
             **held(q, k, v, qp, kp, 2e-2, kernel="wgmma", causal=causal,
                    window=window, logit_cap=cap)})
    # q before every kv position: fully masked rows give 0, not NaN, in
    # every kernel
    out["fully_masked_max_abs"] = {}
    for name, dt, Sq, D, Dv in MASKED_CASES:
        dt = getattr(torch, dt)
        q, k, v = (rnd(s, dt) for s in ((1, Sq, 2, D), (1, 200, 2, D),
                                        (1, 200, 2, Dv)))
        got = fa.flash_attention_cuda(
            q, k, v, torch.arange(-64, -64 + Sq, dtype=torch.int32,
                                  device=dev),
            torch.arange(200, dtype=torch.int32, device=dev), kernel=name)
        check(bool(torch.isfinite(got).all())
              and float(got.abs().max()) == 0.0,
              f"flash {name} D {D} Dv {Dv}: fully masked rows are not 0")
        out["fully_masked_max_abs"][f"{name}_d{D}_dv{Dv}"] = float(
            got.abs().max())

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
    out["decode"]["lse"] = split_kv_lse(q, k, v, qp, kp)
    # phase 5g's decode shape, whose lse the sharded run's combine reads:
    # command-r-plus-104b's 96 query heads on the same 8 kv heads of 128
    # (12 rows a kv head, against qwen3-4b's 4)
    from repro_torch import configs
    q = rnd((B, 1, configs.get(CMDR_ARCH).n_heads, D), bf)
    out["decode"]["lse_cmdr"] = dict(
        split_kv_lse(q, k, v, qp, kp),
        shape=[B, q.shape[2], KH, 1, Smax, D])
    del q, k, v, vp
    out.update(hymba_attention(held, rnd))
    out.update(encdec_attention(held, rnd))
    # deepseek-v2's MLA prefill (phase 5b): K of 128 + 64 rope dims, V of
    # 128, 128 heads, no GQA; h2o-danube-3-4b's (phase 5e): 32 query heads
    # on 8 kv heads of 120, its 4096-slot window.  The dispatch takes the
    # wgmma kernel; each is held and timed in turns with the SIMT kernel
    # forced (SIMT, wgmma, wgmma, SIMT: the SIMT kernel's time is the
    # "before"), beside SDPA
    qp = torch.arange(S, dtype=torch.int32, device=dev)
    kp = torch.full((Smax,), -1, dtype=torch.int32, device=dev)
    kp[:S] = qp
    for name, H, KH, D, Dv, window in (
            ("mla_prefill", MLA_HEADS, MLA_HEADS, MLA_QK_DIM, MLA_V_DIM,
             None),
            ("danube_prefill", DANUBE_HEADS, DANUBE_KV_HEADS, DANUBE_DIM,
             DANUBE_DIM, 4096)):
        q, k, v = (rnd(s, bf) for s in ((B, S, H, D), (B, Smax, KH, D),
                                        (B, Smax, KH, Dv)))
        out[name] = versus_simt(name, q, k, v, qp, kp, held, plains,
                                window=window)
        del q, k, v
    # the smoke configuration's training calls (phases 6c and 7c: the
    # train CLI's 4 x 32 tokens, 4 query heads on 1 kv head of 32), which
    # took the SIMT kernel before the wgmma kernel took D 32: launch-bound,
    # so timed and not held faster
    B_s, S_s = 4, 32
    q, k, v = (rnd(s, bf) for s in ((B_s, S_s, 4, 32), (B_s, S_s, 1, 32),
                                    (B_s, S_s, 1, 32)))
    pos = torch.arange(S_s, dtype=torch.int32, device=dev)
    out["smoke_train"] = versus_simt("smoke_train", q, k, v, pos, pos, held,
                                     plains, faster=False)
    del q, k, v
    # the SIMT kernel's own role: float32 prefill (the float32 checks of
    # phases 5b-5e and 6a), timed at qwen3-4b's prefill shape beside SDPA
    # in float32 and the float32 bound
    H, KH, D = 32, 8, 128
    f32 = torch.float32
    q, k, v = (rnd(s, f32) for s in ((B, S, H, D), (B, Smax, KH, D),
                                     (B, Smax, KH, D)))
    check(fa.choose_kernel(f32, D, D, S * H // KH) == "simt",
          "flash prefill_float32: the dispatch does not choose simt")
    rec = {"shape": [B, H, KH, S, Smax, D], "kernel": "simt",
           "simt": held(q, k, v, qp, kp, 2e-3)}
    call = lambda: fa.flash_attention_cuda(q, k, v, qp, kp)
    rec["simt"].update(ms=[cuda_ms(call, 3)], graph_ms=[graph_ms(call, 3)])
    sdpa = sdpa_call(q, k, v, qp, kp)
    rec["library_ms"] = cuda_ms(sdpa, 3)
    rec["library_graph_ms"] = graph_ms(sdpa, 3)
    rec["plain_ms"] = cuda_ms(lambda: fa.attention_plain(
        q, k, v, q_positions=qp, kv_positions=kp), 2)
    rec["bound_ms"], rec["bound_by"] = flash_attention_bound(q, k, v, qp, kp)
    rec["simt"]["tflop_per_s"] = flash_attention_ops(q, k, v, qp, kp) / (
        min(rec["simt"]["graph_ms"]) * 1e-3) / 1e12
    out["prefill_float32"] = rec
    del q, k, v
    out["sass_flash_attention_wgmma"] = sass_counts("flash_attention_wgmma")
    check(all(out["sass_flash_attention_wgmma"].values()),
          f"flash wgmma: SASS {out['sass_flash_attention_wgmma']}")
    # each kernel's numbers at a shape its main-path launches take: the
    # wgmma kernel's at qwen3-4b's prefill (its MLA and danube prefill
    # numbers beside them), split-KV's at the decode, the SIMT kernel's at
    # qwen3-4b's prefill in float32, the dtype of every launch it still
    # makes on a main path (its bf16 times forced at the qwen, MLA and
    # danube shapes beside them)
    for name, kn in (("prefill", "wgmma"), ("decode", "split_kv"),
                     ("prefill_float32", "simt")):
        rec = out[name]
        kernels[f"flash_attention_{kn}"].update(
            max_abs_err=max(errs[kn]), ms=min(rec[kn]["graph_ms"]),
            event_ms=min(rec[kn]["ms"]), plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=min(np.atleast_1d(rec["library_graph_ms"])),
            shape=f"{name} [B, H, KH, Sq, Skv, D] = {rec['shape']}, "
                  + ("float32" if kn == "simt" else "bf16"))
    for name in ("mla_prefill", "danube_prefill", "smoke_train"):
        rec = out[name]
        kernels["flash_attention_wgmma"].update({
            f"ms_{name}": min(rec["wgmma"]["graph_ms"]),
            f"event_ms_{name}": min(rec["wgmma"]["ms"]),
            f"plain_ms_{name}": rec["plain_ms"],
            f"bound_ms_{name}": rec["bound_ms"],
            f"bound_by_{name}": rec["bound_by"],
            f"library_ms_{name}": min(rec["library_graph_ms"]),
            f"tflop_per_s_{name}": rec["wgmma"]["tflop_per_s"]})
    for tag in ("lse", "lse_cmdr"):
        lse, sfx = out["decode"][tag], tag[3:]
        kernels["flash_attention_split_kv"].update({
            f"lse_max_abs_err{sfx}": lse["max_abs_err"],
            f"ms_lse{sfx}": min(lse["graph_ms_with"]),
            f"ms_without_lse{sfx}": min(lse["graph_ms_without"]),
            f"plain_ms_lse{sfx}": lse["plain_ms"]})
    kernels["flash_attention_split_kv"]["shape_lse_cmdr"] = (
        f"5g decode [B, H, KH, Sq, Skv, D] = "
        f"{out['decode']['lse_cmdr']['shape']}, bf16")
    for name, kn in (("hymba_prefill", "wgmma"),
                     ("hymba_decode_wrapped", "split_kv")):
        kernels[f"flash_attention_{kn}"][f"ms_{name}"] = out[name][kn][
            "graph_ms"]
    for name in ("whisper_encoder", "whisper_cross_prefill",
                 "whisper_cross_decode", "internvl2_prefill"):
        rec = out[name]
        kernels[f"flash_attention_{rec['kernel']}"].update({
            f"ms_{name}": rec[rec["kernel"]]["graph_ms"],
            f"library_ms_{name}": rec["library_graph_ms"],
            f"bound_ms_{name}": rec["bound_ms"],
            f"bound_by_{name}": rec["bound_by"]})
    kernels["flash_attention_simt"].update(
        ms_mla_prefill_before=min(out["mla_prefill"]["simt"]["graph_ms"]),
        ms_danube_prefill_before=min(
            out["danube_prefill"]["simt"]["graph_ms"]),
        ms_smoke_train_before=min(out["smoke_train"]["simt"]["graph_ms"]),
        ms_qwen_prefill_bf16=min(out["prefill"]["simt"]["graph_ms"]))
    emit("flash_attention_vs_plain", **out)


def device_events(prof, tree: bool) -> dict:
    """Durations in ms of the CUDA activities the profiler recorded, by
    name: from its raw kineto event list (``prof.profiler.kineto_results``,
    a private attribute, read on torch 2.11), or, with ``tree``, from its
    public FunctionEvent tree (``prof.events()``).  Building that tree
    takes ~65 us an event on the host: tens of seconds for xlstm's prefill
    (~150 k operations in its sLSTM loop)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    if tree:
        for e in prof.events():
            if e.device_type == cuda:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() * 1e-3)
        return by_name
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            by_name.setdefault(e.name(), []).append(e.duration_ns() * 1e-6)
    return by_name


def serve_profile(model, cfg, batch, cache, cross_check=False) -> dict:
    """Device activity of one prefill and one decode step of the serving
    path (under the profiler, whose own host cost is in the wall time):
    wall ms, CUDA kernels, the share of the wall time the device was busy
    (summed kernel time; one stream), the flash kernels' share of the
    device time (every kernel named flash_attention*: wgmma, split and
    combine, SIMT), and the five kernels that took most device time, read
    from the raw event list.  ``cross_check``: also read the FunctionEvent
    tree and check that both readers see the same kernels and busy time
    (to 1% and a microsecond a kernel, should the tree round)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine
    tokens = batch["tokens"]
    prompt_len = tokens.shape[1] + (cfg.vision_prefix_tokens or 0)
    steps = {"prefill": lambda: engine.prefill(model, cfg, batch, cache),
             "decode_step": lambda: engine.decode_step(
                 model, cfg, tokens[:, -1:], prompt_len + SERVE_GEN - 1,
                 cache)}
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        by_name = device_events(prof, tree=False)
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
        if cross_check:
            readers = {"raw": by_name, "tree": device_events(prof, True)}
            readers = {tag: {"kernels": sum(len(v) for v in ev.values()),
                             "busy_ms": sum(sum(v) for v in ev.values())}
                       for tag, ev in readers.items()}
            raw, tree = readers["raw"], readers["tree"]
            check(raw["kernels"] == tree["kernels"] and abs(
                      raw["busy_ms"] - tree["busy_ms"])
                  <= 1e-2 * raw["busy_ms"] + 1e-3 * raw["kernels"],
                  f"serve {cfg.name} {name}: the profile's readers "
                  f"disagree: {readers}")
            out[name]["readers"] = readers
    return out


def cross_leaves(cache) -> list:
    """The cross-attention cache's K/V buffers of an encoder-decoder's
    cache (none for other models)."""
    from repro_torch.serve import cache as C
    return [t for g in cache for blk in g.values()
            if isinstance(blk, dict) and "cross" in blk
            for t in C.leaves(blk["cross"])]


def serve_protocol(model, cfg, batch, spec, want: dict, cross_check=False,
                   max_len: int = SERVE_SMAX, mesh=None,
                   keep_logits=False) -> dict:
    """Phase 5's protocol on a built model and its prompt ``batch``
    (tokens, and frames or patches): a cold, then a warm
    ``greedy_generate`` call (the main path as a user runs it, synchronized
    only around the whole call), the warm call's flash launches by kernel
    equal to ``want``; then a step-by-step pass, synchronized per step,
    decoding after the prompt and any patch prefix, its logits finite and
    its ids those of the calls (an encoder-decoder's cross cache checked
    byte-equal after the last decode step to its state after prefill);
    then the serving profile (``cross_check``: its two readers held
    together).  ``mesh``: sharded serving -- the model sharded on it
    (``engine.shard_model``), ``batch`` the rank's rows, every cache the
    rank's blocks, every call under its ``mesh_context``.  Returns the
    fields to print ("launches", "tokens_per_s", ..., "lse_launches":
    the warm call's split-KV launches with lse); with ``keep_logits``
    also "ids" and "logits" (every step's, on the host)."""
    import contextlib
    from repro_torch.parallel import sharding as sh
    with sh.mesh_context(mesh) if mesh is not None \
            else contextlib.nullcontext():
        return _serve_protocol(model, cfg, batch, spec, want, cross_check,
                               max_len, mesh, keep_logits)


def _serve_protocol(model, cfg, batch, spec, want, cross_check, max_len,
                    mesh, keep_logits) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import cache as C, engine
    tokens = batch["tokens"]
    (B, S), GEN, dev = tokens.shape, SERVE_GEN, tokens.device
    prompt_len = S + (cfg.vision_prefix_tokens or 0)
    # the first call is cold (cuBLAS picks its kernels, the allocator
    # grows); the second, on a fresh cache, is the one timed for tokens/s
    # and whose launches are counted
    for cold in (True, False):
        cache = None    # free the last call's cache before the fresh one
        cache = C.zeros(spec, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        seq, cache = engine.greedy_generate(model, cfg, batch, cache, GEN)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        if cold:
            cold_s, cold_seq = total_s, seq
    launches = {kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                for kn in fa.KERNELS}
    calls = fa.LAUNCHES["flash_attention"]
    lse_launches = fa.LAUNCHES["flash_attention_split_kv_lse"]
    check(bool(torch.equal(cold_seq, seq)),
          f"serve {cfg.name}: two greedy_generate calls chose different ids")
    check(launches == want and calls == sum(want.values()),
          f"serve {cfg.name}: flash-attention launches {launches} of "
          f"{calls} calls, want {want}")
    check(tuple(seq.shape) == (B, GEN),
          f"serve {cfg.name}: ids {tuple(seq.shape)}")
    peak = torch.cuda.max_memory_allocated()

    times = {"prefill": [], "decode_step": []}
    cache = C.zeros(spec, device=dev, mesh=mesh)
    finite, ids, extra, kept = True, [], {}, []
    for i in range(GEN):
        torch.cuda.synchronize()
        if i == 0:
            # the prefill's own peak, beside what is live before it
            torch.cuda.reset_peak_memory_stats()
            prefill_resident = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if i == 0:
            logits, cache = engine.prefill(model, cfg, batch, cache)
        else:
            logits, cache = engine.decode_step(model, cfg, ids[-1][:, None],
                                               prompt_len + i - 1, cache)
        torch.cuda.synchronize()
        times["prefill" if i == 0 else "decode_step"].append(
            time.perf_counter() - t)
        if i == 0:
            prefill_peak = torch.cuda.max_memory_allocated()
            cross = [buf.clone() for buf in cross_leaves(cache)]
        finite = finite and bool(torch.isfinite(logits).all())
        ids.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if keep_logits:
            kept.append(logits.cpu())
    check(finite, f"serve {cfg.name}: a logit is not finite")
    check(bool(torch.equal(torch.stack(ids, 1), seq)),
          f"serve {cfg.name}: the step-by-step pass chose other ids than "
          "greedy_generate")
    if cfg.is_encoder_decoder:
        after = cross_leaves(cache)
        # leaves [repeats, B, enc_len, KH, Dh]: K and V of every layer
        check(sum(buf.shape[0] for buf in after) == 2 * cfg.n_layers
              and all(bool(buf.abs().amax() > 0) for buf in cross)
              and all(torch.equal(a, b) for a, b in zip(after, cross)),
              f"serve {cfg.name}: the cross cache changed in decode")
        extra = dict(cross_cache_bytes=sum(
                         buf.numel() * buf.element_size() for buf in after),
                     cross_cache_unchanged_by_decode=True)
        del cross, after
    profile = serve_profile(model, cfg, batch, cache, cross_check)
    return dict(
        batch=B, prompt_len=prompt_len, gen=GEN, max_len=max_len, **extra,
        cache_bytes=C.cache_bytes(spec), prefill_s=times["prefill"][0],
        decode_ms_per_step=1e3 * statistics.mean(times["decode_step"]),
        decode_ms_median=1e3 * statistics.median(times["decode_step"]),
        cold_total_s=cold_s, total_s=total_s, tokens_per_s=B * GEN / total_s,
        max_memory_allocated=peak, prefill_peak_bytes=prefill_peak,
        prefill_resident_bytes=prefill_resident,
        first_row_ids=seq[0].tolist(),
        flash_launches=calls, flash_launches_by_kernel=launches,
        lse_launches=lse_launches, profile=profile,
        **(dict(ids=seq.cpu(), logits=kept) if keep_logits else {}))


def decode_vs_forward(model, cfg, batch, max_len: int = SERVE_SMAX,
                      prefill_len: int = None) -> float:
    """Relative gap of the cached decode of the last prompt token (after
    any patch prefix; an encoder-decoder's cross cache of its frames) to
    the uncached forward pass's logits (largest absolute difference over
    the largest logit); both finite.  ``prefill_len``: prefill that many
    tokens and decode the rest one at a time, teacher-forced (default:
    all but the last)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C, engine
    tokens = batch["tokens"]
    S = tokens.shape[1]
    prefill_len = S - 1 if prefill_len is None else prefill_len
    prefix = cfg.vision_prefix_tokens or 0
    h = M.forward_hidden(model, cfg, batch)
    ref = M.logits_fn(model, cfg, h[:, -1:])[:, 0]
    del h
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    cache = C.zeros(C.cache_spec(cfg, tokens.shape[0], max_len,
                                 enc_len=enc_len,
                                 dtype=getattr(torch, cfg.dtype)),
                    device=tokens.device)
    _, cache = engine.prefill(
        model, cfg, {**batch, "tokens": tokens[:, :prefill_len]}, cache)
    for i in range(prefill_len, S):
        got, cache = engine.decode_step(model, cfg, tokens[:, i:i + 1],
                                        i + prefix, cache)
    check(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
          f"serve {cfg.name}: cached decode or forward not finite")
    return float((got - ref).abs().max() / ref.abs().max())


def place_served(cfg, tok_s: float) -> dict:
    """The served model, at its measured tokens/s, as a VSR of 4 stages
    placed with cfn-milp on the datacenter CFN; it must save vs CDC.
    ``placement_launches``: the placement kernels' launches in the solve
    (the re-score that checks it not counted)."""
    from repro_torch.api import CFNSession, PlacementSpec
    from repro_torch.core import topology, vsr
    from repro_torch.kernels import placement_power as pp
    vsrs = vsr.from_architecture(cfg, tokens_per_s=tok_s, n_stages=4)
    spec_p = PlacementSpec(method="cfn-milp", bucket_rows=False,
                           bucket_cols=False)
    session = CFNSession(topology.datacenter_topology(), spec_p,
                         device="cuda")
    pp.reset_launches()
    result = session.solve(vsrs)
    launches = dict(pp.LAUNCHES)
    rescore(session, result)
    sav = session.savings_vs_baseline("cdc")
    check(sav["saving_frac"] > 0.0,
          f"serve {cfg.name}: no saving vs CDC ({sav['saving_frac']})")
    return dict(vsr_F=vsrs.F[0].tolist(), placement_power_w=result.power,
                placement_feasible=result.feasible,
                placement_method=result.method, cdc_w=sav["baseline_w"],
                saving_vs_cdc=sav["saving_frac"],
                placement_launches=launches)


def build_served(cfg, prompt_len: int = SERVE_S, enc_len: int = 0):
    """(model, init seconds, prompt batch): random bf16 weights from a
    seeded CUDA generator, 8 prompts of ``prompt_len`` tokens (numpy seed
    0), then from the same generator, as ``launch/serve.py`` draws them,
    the stub front ends' float32 inputs, 0.1 x normal: an
    encoder-decoder's frames [8, enc_len, d_model], a VLM's patches [8,
    P, d_model]."""
    import torch
    from repro_torch.models import model as M
    dev = "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_B, prompt_len)), dtype=torch.int32, device=dev)}
    stub = lambda n: torch.as_tensor(
        0.1 * rng.standard_normal((SERVE_B, n, cfg.d_model)),
        dtype=torch.float32, device=dev)
    if cfg.is_encoder_decoder:
        batch["frames"] = stub(enc_len)
    if cfg.vision_prefix_tokens:
        batch["patches"] = stub(cfg.vision_prefix_tokens)
    return model, init_s, batch


# phase 5's ring-write check: the smoke gemma2-27b (its local layer a
# 64-slot ring) prefilled with a prompt longer than the ring, on the card
RING_ARCH, RING_B, RING_S, RING_REPEATS = "gemma2-27b", 4, 88, 20


def ring_write_check() -> dict:
    """A prefill past a ring, ``RING_REPEATS`` times on the card: every
    run's cache leaves byte-equal to the first run's, and every ring
    slot's K and V equal to those of the position its ``pos_ids`` names
    (that layer's K/V of every position, written by the same attention
    call into a cache of ``RING_S`` slots).  Before the mend a slot
    written twice in one ``index_put_`` kept either write."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import cache as C, engine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_smoke(RING_ARCH), n_layers=2)
    model = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (RING_B, RING_S)), dtype=torch.int32, device="cuda")
    spec = C.cache_spec(cfg, RING_B, RING_S + 8)
    first, differing = None, 0
    for _ in range(RING_REPEATS):
        cache = C.zeros(spec, "cuda")
        engine.prefill(model, cfg, {"tokens": tokens}, cache)
        got = [t.clone() for t in C.leaves(cache)]
        if first is None:
            first = got
        differing += not all(torch.equal(a, b) for a, b in zip(got, first))
    ring = cache[0]["b0"]
    smax = ring["pos_ids"].shape[-1]
    # the local layer's K/V of every position, into a cache of RING_S slots
    blk = model.groups[0][0]["b0"]
    h = L.rms_norm(M.embed_tokens(model, cfg, tokens), blk["ln1"],
                   cfg.norm_eps)
    whole = dict(k=torch.zeros((RING_B, RING_S) + ring["k"].shape[-2:],
                               dtype=ring["k"].dtype, device="cuda"),
                 pos_ids=torch.full((RING_S,), -1, dtype=torch.int32,
                                    device="cuda"))
    whole["v"] = torch.zeros_like(whole["k"])
    L.attention(blk, h, cfg, positions=torch.arange(
        RING_S, dtype=torch.int32, device="cuda"), cache=whole,
        window=M.block_window(cfg, "attn_local"))
    pos = ring["pos_ids"][0].long()
    consistent = bool(torch.equal(ring["k"][0], whole["k"][:, pos])
                      and torch.equal(ring["v"][0], whole["v"][:, pos])
                      and torch.equal(pos.sort().values, torch.arange(
                          RING_S - smax, RING_S, device="cuda")))
    check(differing == 0 and consistent,
          f"ring write: {differing} of {RING_REPEATS} prefills differ from "
          f"the first; slots consistent with pos_ids: {consistent}")
    return dict(config=cfg.name, batch=RING_B, prompt=RING_S, ring=smax,
                repeats=RING_REPEATS, runs_differing=differing,
                slots_consistent=consistent,
                seconds=time.perf_counter() - t0)


def phase_serve() -> dict:
    """Phase 5: serve qwen3-4b at full width and depth, then place it;
    then the ring-write check (``ring_write_check``)."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C
    cfg = configs.get("qwen3-4b")
    model, init_s, batch = build_served(cfg)
    spec = C.cache_spec(cfg, SERVE_B, SERVE_SMAX)
    # every layer's prefill through the wgmma kernel, every decode step's
    # through the split-KV kernel, none through the SIMT kernel
    rec = serve_protocol(model, cfg, batch, spec, {
        "wgmma": cfg.n_layers, "split_kv": cfg.n_layers * (SERVE_GEN - 1),
        "simt": 0}, cross_check=True)
    rel = decode_vs_forward(model, cfg, batch)
    check(rel < 3e-2,
          f"serve: cached decode vs forward rel {rel} (bf16 bound 3e-2)")
    del model
    emit("serve_qwen3_4b", config=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=M.param_count(M.init_model(
             cfg, device="meta")), init_s=init_s, **rec,
         decode_vs_forward_rel=rel,
         **place_served(cfg, rec["tokens_per_s"]),
         scheduler=schedule_served(cfg, rec["tokens_per_s"]),
         ring_write=ring_write_check())
    return rec["flash_launches_by_kernel"]


# phase 5b: the MoE family at full width, the phase 5 protocol.  deepseek-
# v2-236b is cut to 4 layers (1 mla_dense + 3 mla_moe): the whole model,
# 236 B parameters (472 GB in bf16), does not fit one 80 GB card
MOE_CELLS = (("olmoe-1b-7b", None), ("deepseek-v2-236b", 4))
# the decode-vs-forward check of 5b, as the reference's own test makes it
# (tests/test_models.py): float32 weights (bf16 router logits tie and round
# differently in the forward's and the decode's products, and one flipped
# expert moves a logit by 10-30%), the lossless capacity factor 8.0 (at
# 1.25 the forward's 8192 tokens and the decode step's 8 fill the experts'
# queues differently, so their drops differ), on the first 2 prompts so
# that deepseek's float32 weights (53 GB) fit beside the activations
MOE_CHECK_B = 2
MOE_LOSSLESS = 8.0


def first_moe_input(model, cfg, tokens):
    """(block, input) of the first MoE layer's experts in a forward pass of
    ``tokens``: the stack up to that layer, then its attention half."""
    from repro_torch.models import layers as L, model as M
    x = M.embed_tokens(model, cfg, tokens)
    pos = M._positions(tokens.shape[1], x.device)
    for gi, grp in enumerate(M.layer_plan(cfg)):
        for unit in model.groups[gi]:
            for j, kind in enumerate(grp.kinds):
                blk = unit[f"b{j}"]
                if kind in ("attn_moe", "mla_moe"):
                    h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
                    if kind == "mla_moe":
                        a, _ = L.mla_attention(blk, h, cfg, positions=pos)
                    else:
                        a, _ = L.attention(blk, h, cfg, positions=pos)
                    return blk, L.rms_norm(x + a, blk["ln2"], cfg.norm_eps)
                x, _ = M.apply_block(blk, x, cfg, kind, positions=pos)
    raise ValueError(f"{cfg.name} has no MoE layer")


def first_mla_attend(model, cfg, tokens) -> dict:
    """The first MLA layer's bf16 prefill attention, as the serving path
    calls it (``tokens`` prefilled into a fresh cache of SERVE_SMAX slots):
    the expanded q, k, v that ``mla_attention`` hands ``attend`` are
    caught, then run through the dispatch's kernel (wgmma) and through the
    SIMT kernel forced; their largest difference must be <= 2e-2 of the
    output's largest value."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import cache as C
    check(M.layer_plan(cfg)[0].kinds[0].startswith("mla"),
          f"serve {cfg.name}: its first layer is not MLA")
    seen = []

    def catch(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                           device=q.device)

    blk = model.groups[0][0]["b0"]
    cache = C.zeros(C.cache_spec(cfg, tokens.shape[0], SERVE_SMAX),
                    device=tokens.device)[0]["b0"]
    real = L.attend
    with torch.no_grad():
        x = M.embed_tokens(model, cfg, tokens)
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        L.attend = catch
        try:
            L.mla_attention(blk, h, cfg, positions=M._positions(
                tokens.shape[1], x.device),
                cache={k: v[0] for k, v in cache.items()})
        finally:
            L.attend = real
        (q, k, v, kw), = seen
        qp, kp = kw.pop("q_positions"), kw.pop("kv_positions")
        rows = q.shape[1] * q.shape[2] // k.shape[2]
        kernel = fa.choose_kernel(q.dtype, q.shape[-1], v.shape[-1], rows)
        check(kernel == "wgmma", f"serve {cfg.name}: MLA prefill "
                                 f"dispatched to {kernel}")
        got = fa.flash_attention_cuda(q, k, v, qp, kp, **kw).float()
        simt = fa.flash_attention_cuda(q, k, v, qp, kp, kernel="simt",
                                       **kw).float()
    err = float((got - simt).abs().max())
    scale = float(simt.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= 2e-2 * scale,
          f"serve {cfg.name}: first MLA layer, wgmma vs SIMT {err} "
          f"(max |out| {scale})")
    return dict(shape=[list(q.shape), list(k.shape), list(v.shape)],
                kernel=kernel, max_abs_wgmma_vs_simt=err, max_abs_out=scale,
                rel=err / scale)


def moe_drops(model, cfg, tokens) -> dict:
    """The dropped (token, k) share of the first MoE layer of a forward
    pass of ``tokens``, on the path ``moe`` takes there."""
    import torch
    from repro_torch.models import layers as L
    with torch.no_grad():
        blk, h = first_moe_input(model, cfg, tokens)
        path, cap, _ = L.moe_plan(cfg, *tokens.shape)
        share = float(L.moe_dropped(blk, h, cfg).float().mean())
    return dict(path=path, capacity=cap, dropped_share=share)


def phase_serve_moe() -> tuple:
    """Phase 5b: serve olmoe-1b-7b at full width and depth and
    deepseek-v2-236b at full width (4 layers), each through phase 5's
    protocol; hold deepseek's first MLA layer's prefill attention on the
    wgmma kernel against the SIMT kernel; place the served olmoe on the
    datacenter CFN.  Returns the phase's launches by kernel-line name (the
    flash kernels' in both warm calls, the placement kernels' in olmoe's
    placement) and the flash kernels' in both float32 decode-vs-forward
    checks."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C
    t_all = time.perf_counter()
    cells, total, total_f32 = {}, {}, {}
    for arch, n_layers in MOE_CELLS:
        t0 = time.perf_counter()
        cfg = configs.get(arch)
        reduced = {}
        if n_layers is not None:
            reduced = {"n_layers": f"{cfg.n_layers} -> {n_layers}: the "
                       "whole model (472 GB in bf16) does not fit one card"}
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        model, init_s, batch = build_served(cfg)
        tokens = batch["tokens"]
        spec = C.cache_spec(cfg, SERVE_B, SERVE_SMAX)
        n_attn = sum(len(g.kinds) * g.repeats for g in M.layer_plan(cfg))
        # MLA prefill (D 192, Dv 128) takes the wgmma kernel, MLA decode
        # the absorbed path (no flash call); olmoe's attention as qwen3-4b's
        want = ({"wgmma": n_attn, "split_kv": 0, "simt": 0} if cfg.use_mla
                else {"wgmma": n_attn, "split_kv": n_attn * (SERVE_GEN - 1),
                      "simt": 0})
        rec = serve_protocol(model, cfg, batch, spec, want)
        for kn, n in rec["flash_launches_by_kernel"].items():
            name = f"flash_attention_{kn}"
            total[name] = total.get(name, 0) + n
        rec["moe_first_layer_prefill"] = moe_drops(model, cfg, tokens)
        if cfg.use_mla:
            rec["mla_first_layer_attend"] = first_mla_attend(model, cfg,
                                                             tokens)
        # the bf16 model's gap at the default capacity: recorded, not held
        # one token past the prompt: prefill 1024, decode at position
        # 1024 (hymba's local rings wrap to slot 0) against a forward pass
        # over 1025 tokens
        past = torch.cat([tokens, torch.as_tensor(
            np.random.default_rng(1).integers(0, cfg.vocab, (SERVE_B, 1)),
            dtype=tokens.dtype, device=tokens.device)], 1)
        rec["decode_vs_forward_rel_bf16"] = decode_vs_forward(
            model, cfg, {"tokens": past})
        # the checked comparison: float32, lossless, 2 prompts
        torch.cuda.empty_cache()
        for p in model.parameters():
            p.data = p.data.float()
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    capacity_factor=MOE_LOSSLESS)
        small = tokens[:MOE_CHECK_B]
        rec["lossless_first_layer"] = moe_drops(model, cfg32, small)
        # float32 runs its attention on the SIMT kernel (and on split-KV
        # for olmoe's decode step): counted apart from the bf16 serving
        fa.reset_launches()
        rel = decode_vs_forward(model, cfg32, {"tokens": small})
        for kn in fa.KERNELS:
            name = f"flash_attention_{kn}"
            total_f32[name] = (total_f32.get(name, 0)
                               + fa.LAUNCHES[name])
        check(rel < 3e-2, f"serve {arch}: cached decode vs forward rel "
                          f"{rel} (float32, lossless; bound 3e-2)")
        del model
        torch.cuda.empty_cache()
        # cache values a token and layer: leaves [repeats, B, Smax, ...]
        per_token = sum(s.shape[0] * math.prod(s.shape[3:])
                        for s in C.leaves(spec) if len(s.shape) > 3) // n_attn
        cells[arch] = dict(
            config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
            reduced=reduced, params=M.param_count(M.init_model(
                cfg, device="meta")), init_s=init_s, **rec,
            cache_values_per_token_layer=per_token,
            mha_kv_values_per_token_layer=2 * cfg.n_heads * cfg.head_dim,
            decode_vs_forward_rel=rel, seconds=time.perf_counter() - t0)
        if arch == "olmoe-1b-7b":
            cells[arch].update(place_served(cfg, rec["tokens_per_s"]))
            total.update(cells[arch]["placement_launches"])
            check(total["placement_power"] >= 1,
                  f"serve {arch}: its placement launched no "
                  f"placement_power ({total})")
    emit("serve_moe", cells=cells, launches=total,
         launches_float32=total_f32,
         seconds_total=time.perf_counter() - t_all)
    return total, total_f32


# phase 5c: the recurrent families at full width and depth, the phase 5
# protocol.  xlstm-1.3b: 42 mLSTM and 6 sLSTM blocks, no attention, a
# state that does not grow with the context; hymba-1.5b: attention and
# mamba side by side in every layer, 30 of 32 layers windowed at 1024 over
# a ring buffer that the first decode step after the 1024-token prompt
# wraps.  Their decode-vs-forward check decodes that step (position 1024)
# and runs in float32 on the first 2 prompts, as 5b's does (bf16 rounding
# compounds along the recurrences; the bf16 gap is recorded)
SSM_CELLS = ("xlstm-1.3b", "hymba-1.5b")
SSM_CHECK_B = 2
# xlstm's checked decode position: position 1024 is there for hymba's
# window rings, which xlstm lacks; its forward over a length that is not a
# multiple of the mLSTM chunk runs the step-by-step recurrence, a host loop
# of ~9 launches a step and layer (~23 s at 1025 tokens on the card's
# host), so its float32 check decodes at 512 (a prefill of 4 chunks of
# 128) and its bf16 gap, recorded only, is not taken
XLSTM_CHECK_POS = 512
SSM_CUT = ("xlstm: the float32 decode-vs-forward check at position "
           f"{XLSTM_CHECK_POS} (a 513-token sequential forward), not 1024; "
           "its bf16 gap (recorded only) not taken; both to pay for phase 7")


def phase_serve_ssm() -> tuple:
    """Phase 5c: serve xlstm-1.3b and hymba-1.5b at full width and depth
    through phase 5's protocol, check cached decode against the forward
    pass in float32 and xlstm's state independent of max_len, and place
    each served model on the datacenter CFN.  Returns the phase's launches
    by kernel-line name (the flash kernels' in both warm calls, the
    placement kernels' in both placements) and the flash kernels' in both
    float32 decode-vs-forward checks."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C
    t_all = time.perf_counter()
    cells, total, total_f32 = {}, {}, {}
    for arch in SSM_CELLS:
        t0 = time.perf_counter()
        cfg = configs.get(arch)
        model, init_s, batch = build_served(cfg)
        tokens = batch["tokens"]
        spec = C.cache_spec(cfg, SERVE_B, SERVE_SMAX)
        # hymba's attention branch as qwen3-4b's attention (D 64, G 5):
        # prefill on the wgmma kernel, decode on split-KV; xlstm attends
        # nowhere
        n_attn = sum(grp.repeats * sum(k in M.HYBRID_KINDS
                                       for k in grp.kinds)
                     for grp in M.layer_plan(cfg))
        rec = serve_protocol(model, cfg, batch, spec, {
            "wgmma": n_attn, "split_kv": n_attn * (SERVE_GEN - 1),
            "simt": 0})
        for kn, n in rec["flash_launches_by_kernel"].items():
            name = f"flash_attention_{kn}"
            total[name] = total.get(name, 0) + n
        # one token past the prompt: prefill 1024, decode at position
        # 1024 (hymba's local rings wrap to slot 0) against a forward pass
        # over 1025 tokens
        past = torch.cat([tokens, torch.as_tensor(
            np.random.default_rng(1).integers(0, cfg.vocab, (SERVE_B, 1)),
            dtype=tokens.dtype, device=tokens.device)], 1)
        checked = past[:SSM_CHECK_B]
        if arch == "xlstm-1.3b":
            checked = torch.cat([checked[:, :XLSTM_CHECK_POS],
                                 checked[:, -1:]], 1)
            rec["decode_vs_forward_rel_bf16"] = None
        else:
            rec["decode_vs_forward_rel_bf16"] = decode_vs_forward(
                model, cfg, {"tokens": past})
        rec["decode_vs_forward_position"] = checked.shape[1] - 1
        # the checked comparison: float32 weights, 2 prompts (its attention
        # on the SIMT kernel and split-KV, counted apart)
        torch.cuda.empty_cache()
        for p in model.parameters():
            p.data = p.data.float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        fa.reset_launches()
        rel = decode_vs_forward(model, cfg32, {"tokens": checked})
        for kn in fa.KERNELS:
            name = f"flash_attention_{kn}"
            total_f32[name] = total_f32.get(name, 0) + fa.LAUNCHES[name]
        check(rel < 3e-2, f"serve {arch}: cached decode vs forward rel "
                          f"{rel} (float32; bound 3e-2)")
        del model
        torch.cuda.empty_cache()
        bytes_2x = C.cache_bytes(C.cache_spec(cfg, SERVE_B, 2 * SERVE_SMAX))
        if arch == "xlstm-1.3b":
            check(bytes_2x == rec["cache_bytes"],
                  f"serve {arch}: cache {rec['cache_bytes']} B at max_len "
                  f"{SERVE_SMAX}, {bytes_2x} B at {2 * SERVE_SMAX}")
        cells[arch] = dict(
            config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
            params=M.param_count(M.init_model(cfg, device="meta")),
            init_s=init_s, **rec, cache_bytes_at_2x_max_len=bytes_2x,
            decode_vs_forward_rel=rel,
            **place_served(cfg, rec["tokens_per_s"]),
            seconds=time.perf_counter() - t0)
        for name, n in cells[arch]["placement_launches"].items():
            total[name] = total.get(name, 0) + n
        check(cells[arch]["placement_launches"]["placement_power"] >= 1,
              f"serve {arch}: its placement launched no placement_power")
    emit("serve_ssm", cut=SSM_CUT, cells=cells, launches=total,
         launches_float32=total_f32,
         seconds_total=time.perf_counter() - t_all)
    return total, total_f32


# phase 5d: whisper-base's encoder-decoder and internvl2-2b's patch prefix
# at full width and depth, the phase 5 protocol (shapes by phase 4's
# WHISPER_* / VLM_TEXT_LEN).  Cached decode vs forward is held in bf16 as
# qwen3-4b's, and in float32 on F32_CHECK_B prompts as 5b's and 5c's too
# (5d's and 5e's)
ENCDEC_CELLS = ("whisper-base", "internvl2-2b")
F32_CHECK_B = 2


def phase_serve_encdec() -> tuple:
    """Phase 5d: serve whisper-base (6 encoder and 6 decoder layers over
    1500 frames, a 187-token decoder prompt) and internvl2-2b (256 patches
    before 768 text tokens) at full width and depth through
    ``serve_cells``: whisper's encoder, self- and cross-attention prefill
    on the wgmma kernel, its self- and cross-attention decode on split-KV
    (12 calls a step), none on SIMT, its cross cache written once at
    prefill; internvl2's as qwen3-4b's."""
    return serve_cells("serve_encdec", ENCDEC_CELLS)


# phase 5e: h2o-danube-3-4b whole (24 layers, d 3840, 32 / 8 heads of 120,
# d_ff 10240, vocab 32000, a 4096-slot window: the cache holds 1064 slots,
# so the window masks nothing), through ``serve_cells`` as 5d's models
DANUBE_CELLS = ("h2o-danube-3-4b",)


def phase_serve_danube() -> tuple:
    """Phase 5e: serve h2o-danube-3-4b at full width and depth through
    ``serve_cells``: its 24 prefill attention calls (head dim 120, in the
    wgmma kernel's zero-padded boxes) on the wgmma kernel, its 24 x 31
    decode calls on split-KV, none on SIMT."""
    from repro_torch import configs
    for arch in DANUBE_CELLS:
        cfg = configs.get(arch)
        check(cfg.head_dim == DANUBE_DIM and cfg.sliding_window
              >= SERVE_SMAX, f"serve {arch}: head dim {cfg.head_dim}, "
              f"window {cfg.sliding_window}")
    return serve_cells("serve_danube", DANUBE_CELLS)


# phase 5f: gemma2-27b whole (46 layers alternating local and global
# attention, d 4608, 32 / 16 heads of 128, d_ff 36864, vocab 256000, a
# 4096-slot window, attention softcap 50, final softcap 30): 28.41 B
# parameters, 56.8 GB in bf16, the largest configuration that fits one
# card whole.  Its float32 decode-vs-forward check does not fit at full
# depth (113.6 GB of float32 weights): held at a cut depth of 2 layers (one
# local, one global) on 1 prompt of GEMMA_F32_TOKENS tokens in a cache of
# GEMMA_F32_SMAX slots -- GEMMA_F32_PREFILL prefilled (the local layer's
# 4096-slot ring exactly full: a longer prefill would overwrite its own
# slots, the reference's semantics too), the rest decoded one at a time,
# so that the ring wraps and the forward pass's window masks
GEMMA_ARCH = "gemma2-27b"
GEMMA_F32_LAYERS = 2
GEMMA_F32_PREFILL = 4096
GEMMA_F32_TOKENS = 4160
GEMMA_F32_SMAX = 4168
GEMMA_PEAK_FRAC = 0.9


def phase_serve_gemma() -> tuple:
    """Phase 5f: serve gemma2-27b at full width and depth through phase
    5's protocol: its 46 prefill attention calls on the wgmma kernel, its
    46 x 31 decode calls on split-KV, none on SIMT (checked); cached
    decode against the forward pass in bf16 (3e-2 of the largest logit,
    checked), and in float32 at the cut depth past the window (module
    comment; its launches counted apart); the peak under
    ``GEMMA_PEAK_FRAC`` of the card; the model placed on the datacenter
    CFN at its measured tokens/s, both placement kernels launched.
    Returns (launches by kernel-line name, the float32 check's, the
    record), every earlier model freed before it."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C
    t0 = time.perf_counter()
    cfg = configs.get(GEMMA_ARCH)
    check(cfg.n_layers == 46 and cfg.local_global_period == 2
          and cfg.sliding_window == 4096 and cfg.head_dim == 128,
          f"serve {cfg.name}: {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model, init_s, batch = build_served(cfg)
    spec = C.cache_spec(cfg, SERVE_B, SERVE_SMAX)
    rec = serve_protocol(model, cfg, batch, spec, {
        "wgmma": cfg.n_layers, "split_kv": cfg.n_layers * (SERVE_GEN - 1),
        "simt": 0}, max_len=SERVE_SMAX)
    rel_bf16 = decode_vs_forward(model, cfg, batch, SERVE_SMAX)
    check(rel_bf16 < 3e-2, f"serve {cfg.name}: cached decode vs forward "
                           f"rel {rel_bf16} (bf16 bound 3e-2)")
    card = torch.cuda.get_device_properties(0).total_memory
    peak = max(rec["max_memory_allocated"], torch.cuda.max_memory_allocated())
    check(peak < GEMMA_PEAK_FRAC * card,
          f"serve {cfg.name}: peak {peak} B above {GEMMA_PEAK_FRAC} of {card}")
    params = M.param_count(model)
    params_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # float32 at the cut depth, past the window
    cfg32 = dataclasses.replace(cfg, n_layers=GEMMA_F32_LAYERS,
                                dtype="float32")
    ring = C.cache_spec(cfg32, 1, GEMMA_F32_SMAX)[0]["b0"]["pos_ids"]
    check(M.layer_plan(cfg32)[0].kinds == ("attn_local", "attn_global")
          and ring.shape[-1] == GEMMA_F32_PREFILL < GEMMA_F32_TOKENS,
          f"serve {cfg.name}: the float32 check's local ring {ring}")
    model32 = M.init_model(cfg32, torch.Generator(device="cuda")
                           .manual_seed(0), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, GEMMA_F32_TOKENS)), dtype=torch.int32,
        device="cuda")
    fa.reset_launches()
    rel = decode_vs_forward(model32, cfg32, {"tokens": tokens},
                            GEMMA_F32_SMAX, prefill_len=GEMMA_F32_PREFILL)
    launches_f32 = {f"flash_attention_{kn}": fa.LAUNCHES[
        f"flash_attention_{kn}"] for kn in fa.KERNELS}
    check(rel < 3e-2, f"serve {cfg.name}: cached decode vs forward rel "
                      f"{rel} (float32 at {GEMMA_F32_LAYERS} layers; bound "
                      "3e-2)")
    del model32, tokens
    torch.cuda.empty_cache()

    launches = {f"flash_attention_{kn}": n
                for kn, n in rec["flash_launches_by_kernel"].items()}
    placed = place_served(cfg, rec["tokens_per_s"])
    check(placed["placement_launches"]["placement_power"] >= 1
          and placed["placement_launches"]["fused_anneal"] >= 1,
          f"serve {cfg.name}: its placement launched "
          f"{placed['placement_launches']}")
    launches.update(placed["placement_launches"])
    out = dict(
        config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
        window=cfg.sliding_window, params=params,
        params_bytes=params_bytes, init_s=init_s,
        resident_before_bytes=resident, **rec, peak_bytes=peak,
        card_bytes=card, peak_frac=peak / card,
        decode_vs_forward_rel_bf16=rel_bf16,
        decode_vs_forward_rel=rel,
        reduced=f"the float32 decode-vs-forward check at {GEMMA_F32_LAYERS} "
                f"layers (one local, one global) of {cfg.n_layers}, 1 "
                f"prompt of {GEMMA_F32_TOKENS} tokens ({GEMMA_F32_PREFILL} "
                f"prefilled, the rest decoded) in {GEMMA_F32_SMAX} slots: "
                f"float32 weights at full depth take "
                f"{4 * params / 1e9:.1f} GB",
        launches_float32=launches_f32, **placed,
        seconds=time.perf_counter() - t0)
    emit("serve_gemma2_27b", **out)
    return launches, launches_f32, out


# phase 5g: command-r-plus-104b at full width (d_model 12288, 96 / 8 heads
# of 128, d_ff 33792, vocab 256000) and a cut depth: all 64 layers are 208
# GB in bf16.  The depth is the deepest whose dry-run peak
# (``launch.dryrun.run_cell`` on a (1, 1) mesh of sizes, phase 5's
# prefill) stays under CMDR_PEAK_FRAC of the card (5f's rule): 19 layers,
# checked on every run against 20.  Served by the plain engine, then by the
# sharded entry on a (1, 1) NCCL mesh over the same weights (sharded in
# place: at (1, 1) no leaf is copied), so the phase's peak is one model and
# one cache
CMDR_ARCH = "command-r-plus-104b"
CMDR_LAYERS = 19
CMDR_PEAK_FRAC = 0.9
CMDR_F32_LAYERS = 2
# the sharded run's logits against the plain run's: bit-equal is expected
# at world size 1 (the same kernels on the same live tiles); this bound is
# the fallback, relative to the largest logit
CMDR_LOGITS_REL = 2e-2


def cmdr_depth(cfg) -> dict:
    """The dry run's predicted prefill peak at ``CMDR_LAYERS`` and one
    layer more, against ``CMDR_PEAK_FRAC`` of the card (checked: the first
    under, the second not); the ``CMDR_LAYERS`` record is phase 8's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh as mesh_mod
    shape = configs.Shape("prefill_5g", SERVE_S, SERVE_B, "prefill")
    recs = {n: dryrun.run_cell(CMDR_ARCH, shape, mesh=DRYRUN_MESH,
                               cfg=dataclasses.replace(cfg, n_layers=n),
                               cache_len=SERVE_SMAX, verbose=False)
            for n in (CMDR_LAYERS, CMDR_LAYERS + 1)}
    frac = {n: r["memory"]["peak_per_device_bytes"]
            / mesh_mod.CARD_MEMORY_BYTES for n, r in recs.items()}
    check(frac[CMDR_LAYERS] < CMDR_PEAK_FRAC <= frac[CMDR_LAYERS + 1],
          f"serve {CMDR_ARCH}: predicted peaks {frac} of the card do not "
          f"put the deepest depth under {CMDR_PEAK_FRAC} at {CMDR_LAYERS}")
    return dict(predicted_peak_frac=frac, record=recs[CMDR_LAYERS],
                shape=shape)


def phase_serve_cmdr() -> tuple:
    """Phase 5g: command-r-plus-104b at ``CMDR_LAYERS`` layers through
    phase 5's protocol, first on the plain engine (its ids and logits
    kept, its cache freed), then through the sharded entry on a ("data",
    "model") (1, 1) NCCL mesh (``launch.mesh.make_mesh``): the weights
    sharded in place (``engine.shard_model``), the cache the rank's blocks,
    every decode attention through split-KV's lse output and the
    log-sum-exp combine.  Checks: the sharded run's ids equal to the
    plain run's and its logits bit-equal (else within
    ``CMDR_LOGITS_REL`` of the largest logit; recorded either way); each
    run's launches 19 wgmma, 19 x 31 split-KV (the sharded run's all with
    lse, the plain run's none), 0 SIMT; sharding the model allocates
    nothing; cached decode against the forward pass in bf16 (3e-2 of the
    largest logit) and in float32 at ``CMDR_F32_LAYERS`` layers on 2
    prompts; the peak under ``CMDR_PEAK_FRAC`` of the card.  Returns
    (launches by kernel-line name of the plain and the sharded run, the
    float32 check's, the sharded run's record and the depth's for phase
    8), every earlier model freed before it."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C, engine
    t0 = time.perf_counter()
    full = configs.get(CMDR_ARCH)
    check(full.n_layers == 64 and full.d_model == 12288
          and full.n_heads == 96 and full.n_kv_heads == 8
          and full.head_dim == 128 and full.d_ff == 33792
          and full.vocab == 256000 and full.sliding_window is None,
          f"serve {CMDR_ARCH}: {full}")
    cfg = dataclasses.replace(full, n_layers=CMDR_LAYERS)
    depth = cmdr_depth(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model, init_s, batch = build_served(cfg)
    spec = C.cache_spec(cfg, SERVE_B, SERVE_SMAX)
    L = cfg.n_layers
    want = {"wgmma": L, "split_kv": L * (SERVE_GEN - 1), "simt": 0}
    plain = serve_protocol(model, cfg, batch, spec, want, keep_logits=True)
    rel_bf16 = decode_vs_forward(model, cfg, batch, SERVE_SMAX)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    try:
        before = torch.cuda.memory_allocated()
        engine.shard_model(model, mesh)
        shard_bytes = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        sharded = serve_protocol(model, cfg, engine.batch_block(batch, mesh),
                                 spec, want, mesh=mesh, keep_logits=True)
    finally:
        dist.destroy_process_group()
    check(rel_bf16 < 3e-2, f"serve {cfg.name}: cached decode vs forward "
                           f"rel {rel_bf16} (bf16 bound 3e-2)")
    check(plain["lse_launches"] == 0
          and sharded["lse_launches"] == want["split_kv"],
          f"serve {cfg.name}: lse launches plain {plain['lse_launches']}, "
          f"sharded {sharded['lse_launches']}, want 0 and "
          f"{want['split_kv']}")
    check(shard_bytes == 0, f"serve {cfg.name}: sharding the model on a "
                            f"(1, 1) mesh allocated {shard_bytes} B")
    ids_equal = bool(torch.equal(plain.pop("ids"), sharded.pop("ids")))
    pl, sl = plain.pop("logits"), sharded.pop("logits")
    bit_equal = all(torch.equal(a, b) for a, b in zip(pl, sl))
    logits_rel = max(float((a - b).abs().max() / a.abs().max())
                     for a, b in zip(pl, sl))
    check(ids_equal and (bit_equal or logits_rel <= CMDR_LOGITS_REL),
          f"serve {cfg.name}: sharded vs plain ids equal {ids_equal}, "
          f"logits rel {logits_rel}")
    card = torch.cuda.get_device_properties(0).total_memory
    peak = max(plain["max_memory_allocated"],
               sharded["max_memory_allocated"],
               torch.cuda.max_memory_allocated())
    check(peak < CMDR_PEAK_FRAC * card,
          f"serve {cfg.name}: peak {peak} B above {CMDR_PEAK_FRAC} of {card}")
    params = M.param_count(model)
    params_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    del model, batch, pl, sl
    gc.collect()
    torch.cuda.empty_cache()

    # float32 at the cut depth, 2 prompts (its prefill attention on the
    # SIMT kernel, its decode on split-KV, counted apart)
    cfg32 = dataclasses.replace(cfg, n_layers=CMDR_F32_LAYERS,
                                dtype="float32")
    model32 = M.init_model(cfg32, torch.Generator(device="cuda")
                           .manual_seed(0), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (F32_CHECK_B, SERVE_S)), dtype=torch.int32,
        device="cuda")
    fa.reset_launches()
    rel = decode_vs_forward(model32, cfg32, {"tokens": tokens}, SERVE_SMAX)
    launches_f32 = {f"flash_attention_{kn}": fa.LAUNCHES[
        f"flash_attention_{kn}"] for kn in fa.KERNELS}
    check(rel < 3e-2, f"serve {cfg.name}: cached decode vs forward rel "
                      f"{rel} (float32 at {CMDR_F32_LAYERS} layers; bound "
                      "3e-2)")
    del model32, tokens
    torch.cuda.empty_cache()

    names = lambda rec: {f"flash_attention_{kn}": n for kn, n in
                         rec["flash_launches_by_kernel"].items()}
    shared = ("batch", "prompt_len", "gen", "max_len", "cache_bytes")
    out = dict(
        config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=params, params_bytes=params_bytes, init_s=init_s,
        resident_before_bytes=resident,
        **{k: plain[k] for k in shared},
        predicted_peak_frac=depth["predicted_peak_frac"],
        plain={k: v for k, v in plain.items() if k not in shared},
        sharded={k: v for k, v in sharded.items() if k not in shared},
        mesh={"axes": ["data", "model"], "shape": [1, 1],
              "backend": "nccl"},
        shard_model_bytes=shard_bytes, ids_equal=ids_equal,
        logits_bit_equal=bit_equal, logits_rel=logits_rel,
        peak_bytes=peak, card_bytes=card, peak_frac=peak / card,
        decode_vs_forward_rel_bf16=rel_bf16, decode_vs_forward_rel=rel,
        launches_float32=launches_f32,
        reduced=f"{CMDR_LAYERS} of {full.n_layers} layers (the deepest "
                f"whose dry-run prefill peak is under {CMDR_PEAK_FRAC} of "
                f"the card; all {full.n_layers} take "
                f"{2 * M.param_count(M.init_model(full, device='meta')) / 1e9:.0f}"
                f" GB in bf16); the float32 decode-vs-forward check at "
                f"{CMDR_F32_LAYERS} layers on {F32_CHECK_B} prompts",
        seconds=time.perf_counter() - t0)
    emit("serve_command_r_plus_104b", **out)
    return names(plain), names(sharded), launches_f32, dict(
        sharded, resident_before_bytes=resident), depth


# phase 5h: tensor-parallel serving on two ranks of the one card.  NCCL
# puts no two ranks of a group on one device, so the two spawned processes
# join gloo groups (scripts/gloo_cuda_probe.py: gloo carries every
# collective of the path on CUDA tensors of one card)
TP_WORLD = 2
# (arch, layers: None for the config's own depth)
TP_CELLS = (("qwen3-4b", None), ("hymba-1.5b", 2))
# the ranks' logits against the plain engine's, relative to the largest
# logit.  bf16: the reference's bound for the same arithmetic summed in
# another order (cached decode against the forward pass,
# tests/test_models.py:93): each rank rounds its partial products to bf16
# before the all-reduce, and on the smoke config at 4 layers that alone
# moves the logits 1.9e-2 of the largest, as far as bf16 against float32
# (2.0e-2); float32 at TP_F32_LAYERS layers, tight
TP_LOGITS_REL = 3e-2
TP_F32_LAYERS = 2
TP_F32_STEPS = 4
TP_F32_REL = 1e-4
TP_DIR = ROOT / "build" / "chip_smoke_tp"
TP_COLLECTIVE_TIMEOUT_S = 300


def _tp_cfg(arch: str, n_layers, dtype=None):
    """``arch``'s full-width config at ``n_layers`` (None: its own) in
    ``dtype`` (None: its own)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(arch)
    kw = {k: v for k, v in (("n_layers", n_layers), ("dtype", dtype))
          if v is not None}
    return dataclasses.replace(cfg, **kw)


def _tp_tokens(cfg, batch: int):
    import torch
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, SERVE_S)), dtype=torch.int32, device="cuda")


def _tp_plain(cfg, batch: int, steps: int, path) -> dict:
    """The plain engine's run of ``cfg`` in this process on ``batch``
    prompts of ``SERVE_S`` tokens (build_served's weights and tokens): a
    step-by-step greedy pass, synchronized per step, with no warm-up (the
    ranks take none either; gloo's collectives, not cuBLAS's first
    calls, set their times) -- every step's logits (float32, on the
    host) and ids saved to ``path`` for the ranks; its prefill seconds
    and decode ms per step returned, the model freed."""
    import gc
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C, engine
    model = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = _tp_tokens(cfg, batch)
    spec = C.cache_spec(cfg, batch, SERVE_SMAX,
                        dtype=getattr(torch, cfg.dtype))
    cache = C.zeros(spec, device="cuda")
    logits, ids, secs = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:
            got, cache = engine.prefill(model, cfg, {"tokens": tokens}, cache)
        else:
            got, cache = engine.decode_step(model, cfg, ids[-1][:, None],
                                            SERVE_S + i - 1, cache)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        ids.append(torch.argmax(got, -1).to(torch.int32))
        logits.append(got.cpu())
    check(all(bool(torch.isfinite(t).all()) for t in logits),
          f"serve_tensor_parallel {cfg.name}: a plain logit is not finite")
    torch.save({"tokens": tokens.cpu(), "logits": logits,
                "ids": torch.stack(ids, 1).cpu()}, path)
    del model, cache, got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_s=secs[0],
                decode_ms_per_step=1e3 * statistics.mean(secs[1:]),
                decode_ms_median=1e3 * statistics.median(secs[1:]))


def _tp_rank(rank: int, jobs: list, store: str) -> None:
    """One rank of phase 5h (a spawned process): a gloo group on a
    ``file://`` store, a ("data", "model") (1, ``TP_WORLD``) mesh on
    ``cuda:0``, each job of ``jobs`` through ``_tp_cell``; its record
    written to ``rank<r>.json`` in ``store``."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + str(Path(store) / "store"),
        rank=rank, world_size=TP_WORLD,
        timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = mesh_mod.make_mesh((1, TP_WORLD), ("data", "model"))
        out = {"rank": rank,
               "backend": dist.get_backend(mesh.get_group("model")),
               "cells": {job["name"]: _tp_cell(job, mesh) for job in jobs}}
        (Path(store) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _tp_cell(job: dict, mesh) -> dict:
    """A rank's run of one 5h job: the weights ``_tp_plain`` drew, sharded
    (``engine.shard_model``), the rank's batch rows and cache blocks;
    under ``mesh_context`` the engine's ``prefill`` and ``decode_step``
    (the entry points a user calls), teacher-forced on the plain run's
    ids and synchronized per step: its flash launches by kernel counted,
    every step's logits against the plain run's (largest absolute
    difference over the largest logit), the first step whose greedy id
    differs and the plain and the rank's top-2 margins there, the
    prefill's peak and seconds, decode ms per step; the shapes each
    flash-attention launch took (the rank's heads)."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve import cache as C, engine
    ref = torch.load(job["path"])
    cfg = _tp_cfg(job["arch"], job["n_layers"], job["dtype"])
    steps = len(ref["logits"])
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    engine.shard_model(model, mesh)
    gc.collect()
    batch = engine.batch_block({"tokens": ref["tokens"].cuda()}, mesh)
    B = batch["tokens"].shape[0]
    spec = C.cache_spec(cfg, B, SERVE_SMAX, dtype=getattr(torch, cfg.dtype))
    shapes, real = set(), fa.flash_attention_cuda

    def recorded(q, k, v, *args, **kw):
        shapes.add(("split_kv_lse" if kw.get("return_lse") else
                    fa.choose_kernel(q.dtype, q.shape[3], v.shape[3],
                                     q.shape[1] * q.shape[2] // k.shape[2]),
                    *q.shape[:3], k.shape[2], k.shape[1]))
        return real(q, k, v, *args, **kw)

    out = {}
    fa.flash_attention_cuda = recorded
    try:
        with sh.mesh_context(mesh):
            cache = C.zeros(spec, device="cuda", mesh=mesh)
            fa.reset_launches()
            secs, rels, digests, first = [], [], [], None
            for i in range(steps):
                torch.cuda.synchronize()
                if i == 0:
                    torch.cuda.reset_peak_memory_stats()
                    out["prefill_resident_bytes"] = \
                        torch.cuda.memory_allocated()
                t = time.perf_counter()
                if i == 0:
                    got, cache = engine.prefill(model, cfg, batch, cache)
                else:
                    fed = ref["ids"][:, i - 1:i].cuda()
                    got, cache = engine.decode_step(model, cfg, fed,
                                                    SERVE_S + i - 1, cache)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                if i == 0:
                    out["prefill_peak_bytes"] = \
                        torch.cuda.max_memory_allocated()
                want = ref["logits"][i].cuda()
                check(bool(torch.isfinite(got).all()),
                      f"serve_tensor_parallel {cfg.name}: a logit is not "
                      "finite")
                rels.append(float((got - want).abs().max()
                                  / want.abs().max()))
                digests.append(float(got.abs().sum()))
                mine = torch.argmax(got, -1).cpu()
                if first is None and not torch.equal(mine, ref["ids"][:, i]
                                                     .long()):
                    row = int((mine != ref["ids"][:, i]).nonzero()[0])
                    margin = lambda t: float(torch.topk(t[row].float(), 2)
                                             .values.diff().abs())
                    first = dict(step=i, row=row, plain_margin=margin(want),
                                 rank_margin=margin(got))
            launches = dict(fa.LAUNCHES)
    finally:
        fa.flash_attention_cuda = real
    out.update(
        resident_before_bytes=resident,
        launches={kn: launches[f"flash_attention_{kn}"] for kn in fa.KERNELS},
        lse_launches=launches["flash_attention_split_kv_lse"],
        attention_shapes=sorted(shapes), prefill_s=secs[0],
        decode_ms_per_step=1e3 * statistics.mean(secs[1:]),
        decode_ms_median=1e3 * statistics.median(secs[1:]),
        logits_rel=max(rels), logits_rel_by_step=rels,
        logits_digest=digests, ids_first_difference=first,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        local_param_bytes=sum(p.to_local().numel()
                              * p.to_local().element_size()
                              for p in model.parameters()))
    del model, cache, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_tp() -> tuple:
    """Phase 5h: tensor-parallel serving on two ranks of the one card
    (two spawned processes on ``cuda:0``, gloo groups, a ("data",
    "model") (1, 2) mesh): qwen3-4b at full width and depth (32 / 8 heads
    of 128, d_ff 9728, vocab 151936: every split -- heads, kv heads, ffn
    columns, vocab) and hymba-1.5b at full width and ``TP_CELLS``' depth
    (25 heads: the query-row fallback at prefill, the whole heads at
    decode; its 32001-token vocabulary whole) by phase 5's protocol (8
    prompts of 1024 tokens, greedy), the weights those of a plain run in
    this process (``_tp_plain``; its model freed before the spawn);
    float32 at ``TP_F32_LAYERS`` layers on 2 prompts.  Checks: each rank's
    logits at every step (prefill, then decode teacher-forced on the
    plain run's ids) within ``TP_LOGITS_REL`` of the largest plain logit
    (``TP_F32_REL`` in float32), the two ranks' logits equal; each
    rank's launches -- wgmma one a layer at prefill, split-KV with its
    lse output one a layer a decode step, no SIMT in bf16 -- and its
    attention shapes (qwen3-4b's prefill at 16 / 4 heads a rank,
    hymba's at 512 query rows; the decode at every head over the rank's
    half of the cache's slots).  Recorded: where greedy ids part from the
    plain run's and the top-2 margins there; prefill s and decode ms a
    step of both; each rank's prefill peak against the dry run's
    prediction at {"data": 1, "model": 2} (phase 8's method).  Returns
    the kernels line's launches (rank 0's bf16 greedy calls, and its
    float32 passes)."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun, mesh as mesh_mod
    t0 = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    mesh_sizes = {"data": 1, "model": TP_WORLD}
    jobs, plain, cells = [], {}, {}
    for arch, n_layers in TP_CELLS:
        for dtype, layers, batch, steps in (
                (None, n_layers, SERVE_B, SERVE_GEN),
                ("float32", TP_F32_LAYERS, F32_CHECK_B, TP_F32_STEPS)):
            cfg = _tp_cfg(arch, layers, dtype)
            name = arch if dtype is None else f"{arch}_float32"
            path = TP_DIR / f"{name}.pt"
            plain[name] = _tp_plain(cfg, batch, steps, path)
            jobs.append(dict(name=name, arch=arch, n_layers=layers,
                             dtype=dtype, path=str(path)))
            cells[name] = cfg
    full = {arch: configs.get(arch) for arch, _ in TP_CELLS}
    qwen = full["qwen3-4b"]
    check(qwen.d_model == 2560 and qwen.n_heads == 32
          and qwen.n_kv_heads == 8 and qwen.head_dim == 128
          and qwen.d_ff == 9728 and qwen.vocab == 151936,
          f"serve_tensor_parallel: {qwen}")
    check(full["hymba-1.5b"].n_heads % TP_WORLD != 0,
          "serve_tensor_parallel: hymba's heads divide the model axis")
    spawn_t = time.perf_counter()
    mp.start_processes(_tp_rank, args=(jobs, str(TP_DIR)), nprocs=TP_WORLD,
                       start_method="spawn")
    ranks_s = time.perf_counter() - spawn_t
    ranks = [json.loads((TP_DIR / f"rank{r}.json").read_text())
             for r in range(TP_WORLD)]
    out = {}
    for name, cfg in cells.items():
        got = [r["cells"][name] for r in ranks]
        L, H, KH = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
        f32 = cfg.dtype == "float32"
        steps = TP_F32_STEPS if f32 else SERVE_GEN
        B = F32_CHECK_B if f32 else SERVE_B
        want = ({"wgmma": 0, "split_kv": L * (steps - 1), "simt": L}
                if f32 else
                {"wgmma": L, "split_kv": L * (steps - 1), "simt": 0})
        bound = TP_F32_REL if f32 else TP_LOGITS_REL
        heads = H // TP_WORLD if H % TP_WORLD == 0 else H
        rows = SERVE_S if H % TP_WORLD == 0 else SERVE_S // TP_WORLD
        kv_heads = KH // TP_WORLD if H % TP_WORLD == 0 \
            and KH % TP_WORLD == 0 else KH
        for r, g in enumerate(got):
            check(g["launches"] == want
                  and g["lse_launches"] == want["split_kv"],
                  f"serve_tensor_parallel {name} rank {r}: launches "
                  f"{g['launches']} ({g['lse_launches']} with lse), want "
                  f"{want}")
            check(g["logits_rel"] <= bound,
                  f"serve_tensor_parallel {name} rank {r}: logits rel "
                  f"{g['logits_rel']} above {bound}")
            prefill = [s for s in g["attention_shapes"]
                       if s[0] != "split_kv_lse"]
            decode = [s for s in g["attention_shapes"]
                      if s[0] == "split_kv_lse"]
            check(bool(prefill) and all(tuple(s[1:5]) == (B, rows, heads,
                                                          kv_heads)
                                        for s in prefill)
                  and bool(decode) and all(
                      tuple(s[1:5]) == (B, 1, H, KH)
                      and s[5] < SERVE_SMAX for s in decode),
                  f"serve_tensor_parallel {name} rank {r}: attention "
                  f"shapes {g['attention_shapes']}")
        check(got[0]["logits_digest"] == got[1]["logits_digest"],
              f"serve_tensor_parallel {name}: the ranks' logits differ")
        rec = None
        if not f32:
            rec = dryrun.run_cell(
                name, configs.Shape("prefill_5h", SERVE_S, SERVE_B,
                                    "prefill"),
                mesh=mesh_sizes, cfg=cfg, cache_len=SERVE_SMAX,
                verbose=False)
            pred = rec["memory"]["peak_per_device_bytes"]
            for g in got:
                g["peak_ratio"] = pred / (g["prefill_peak_bytes"]
                                          - g["resident_before_bytes"])
                g["temp_ratio"] = rec["memory"]["temp_bytes"] / (
                    g["prefill_peak_bytes"] - g["prefill_resident_bytes"])
        out[name] = dict(
            config=cfg.name, n_layers=L, d_model=cfg.d_model, n_heads=H,
            n_kv_heads=KH, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
            vocab=cfg.vocab, dtype=cfg.dtype, batch=B, prompt_len=SERVE_S,
            steps=steps, plain=plain[name], ranks=got,
            logits_bound=bound,
            dryrun=None if rec is None else dict(
                predicted_peak_bytes=rec["memory"]["peak_per_device_bytes"],
                temp_bytes=rec["memory"]["temp_bytes"],
                argument_bytes=rec["memory"]["argument_bytes"],
                dot_flops=rec["counted"]["dot_flops"],
                per_collective=rec["counted"]["per_collective"],
                serving_pattern=rec["serving_pattern"]))
    launches = {f"flash_attention_{kn}": sum(
        ranks[0]["cells"][n]["launches"][kn] for n, c in cells.items()
        if c.dtype != "float32") for kn in fa.KERNELS}
    launches_f32 = {f"flash_attention_{kn}": sum(
        ranks[0]["cells"][n]["launches"][kn] for n, c in cells.items()
        if c.dtype == "float32") for kn in fa.KERNELS}
    emit("serve_tensor_parallel", world=TP_WORLD,
         mesh={"axes": ["data", "model"], "shape": [1, TP_WORLD],
               "backend": ranks[0]["backend"], "device": "cuda:0"},
         cells=out, ranks_s=ranks_s, card_bytes=mesh_mod.CARD_MEMORY_BYTES,
         cut=f"hymba-1.5b at {dict(TP_CELLS)['hymba-1.5b']} of "
             f"{full['hymba-1.5b'].n_layers} layers; the float32 checks at "
             f"{TP_F32_LAYERS} layers on {F32_CHECK_B} prompts and "
             f"{TP_F32_STEPS} steps; qwen3-4b whole",
         seconds=time.perf_counter() - t0)
    return launches, launches_f32


def serve_cells(phase: str, archs) -> tuple:
    """Phase 5's protocol on each of ``archs`` at full width and depth, 8
    prompts (whisper's 187-token decoder prompt over 1500 frames; 768
    tokens after a VLM's patch prefix; else ``SERVE_S`` tokens), their
    prefill attention calls on the wgmma kernel and decode calls on
    split-KV, none on SIMT (checked).  Cached decode against the forward
    pass in bf16 and in float32 on 2 prompts (3e-2 of the largest logit,
    both checked; the float32 check's attention on the SIMT kernel and
    split-KV, counted apart); each model placed on the datacenter CFN at
    its measured tokens/s, both placement kernels launched.  Emits
    ``phase``; returns its launches by kernel-line name (the flash
    kernels' in the warm calls, the placement kernels' in the
    placements) and the flash kernels' in the float32 checks."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve import cache as C
    t_all = time.perf_counter()
    cells, total, total_f32 = {}, {}, {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = configs.get(arch)
        enc_len = 0
        if cfg.is_encoder_decoder:
            prompt, enc_len = WHISPER_DEC_LEN, WHISPER_ENC_LEN
            # prefill: the encoder's layers, then each decoder layer's
            # self- and cross-attention; decode: both of each layer
            n_prefill, n_step = cfg.encoder_layers + 2 * cfg.n_layers, \
                2 * cfg.n_layers
        else:
            prompt = VLM_TEXT_LEN if cfg.vision_prefix_tokens else SERVE_S
            n_prefill = n_step = cfg.n_layers
        prefix = cfg.vision_prefix_tokens or 0
        max_len = prompt + prefix + SERVE_GEN + 8
        model, init_s, batch = build_served(cfg, prompt, enc_len)
        spec = C.cache_spec(cfg, SERVE_B, max_len, enc_len=enc_len)
        rec = serve_protocol(model, cfg, batch, spec, {
            "wgmma": n_prefill, "split_kv": n_step * (SERVE_GEN - 1),
            "simt": 0}, max_len=max_len)
        for kn, n in rec["flash_launches_by_kernel"].items():
            name = f"flash_attention_{kn}"
            total[name] = total.get(name, 0) + n
        rel_bf16 = decode_vs_forward(model, cfg, batch, max_len)
        check(rel_bf16 < 3e-2, f"serve {arch}: cached decode vs forward rel "
                               f"{rel_bf16} (bf16 bound 3e-2)")
        # float32 weights, 2 prompts (the attention on the SIMT kernel and
        # split-KV, counted apart)
        torch.cuda.empty_cache()
        for p in model.parameters():
            p.data = p.data.float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        fa.reset_launches()
        rel = decode_vs_forward(
            model, cfg32, {k: v[:F32_CHECK_B] for k, v in batch.items()},
            max_len)
        for kn in fa.KERNELS:
            name = f"flash_attention_{kn}"
            total_f32[name] = total_f32.get(name, 0) + fa.LAUNCHES[name]
        check(rel < 3e-2, f"serve {arch}: cached decode vs forward rel "
                          f"{rel} (float32; bound 3e-2)")
        del model
        torch.cuda.empty_cache()
        cells[arch] = dict(
            config=cfg.name, n_layers=cfg.n_layers,
            encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, window=cfg.sliding_window,
            enc_len=enc_len, vision_prefix_tokens=prefix, text_len=prompt,
            params=M.param_count(M.init_model(cfg, device="meta")),
            init_s=init_s, **rec, decode_vs_forward_rel_bf16=rel_bf16,
            decode_vs_forward_rel=rel,
            **place_served(cfg, rec["tokens_per_s"]),
            seconds=time.perf_counter() - t0)
        placed = cells[arch]["placement_launches"]
        for name, n in placed.items():
            total[name] = total.get(name, 0) + n
        check(placed["placement_power"] >= 1 and placed["fused_anneal"] >= 1,
              f"serve {arch}: its placement launched {placed}")
    emit(phase, cells=cells, launches=total, launches_float32=total_f32,
         seconds_total=time.perf_counter() - t_all)
    return total, total_f32


def schedule_served(cfg, tok_s: float) -> dict:
    """The served model through ``EnergyAwareScheduler`` on the datacenter
    CFN, beside an olmoe-1b-7b service at 500 tokens/s (the reference
    test's rate), then the olmoe service removed.  Each placement has
    n_stages + 1 nodes, the per-service watts sum to the fleet's (1e-5
    relative + 1e-3 W), and the fleet saves vs the cloud."""
    import torch
    from repro_torch import configs
    from repro_torch.core import topology
    from repro_torch.fault import PlacementMonitor
    from repro_torch.serve.scheduler import EnergyAwareScheduler, Service
    from repro_torch.telemetry import Telemetry
    t0 = time.perf_counter()
    mon, tel = PlacementMonitor(), Telemetry()
    sched = EnergyAwareScheduler(topology.datacenter_topology(),
                                 monitor=mon, telemetry=tel, device="cuda")
    services = [Service(cfg.name, cfg, tok_s),
                Service("olmoe-1b-7b", configs.get("olmoe-1b-7b"), 500.0)]
    out = {}
    for step, call in (("placed", lambda: [sched.add_service(sv)
                                           for sv in services][-1]),
                       ("after_remove", lambda: sched.remove_service(
                           "olmoe-1b-7b"))):
        if step == "after_remove":      # an hour of both services served
            sched.session.engine.tick(1.0)
        placements = call()
        torch.cuda.synchronize()
        total = sched.total_power_w()
        watts = sum(p.power_w for p in placements)
        by_name = {sv.name: sv for sv in services}
        check([len(p.stage_nodes) for p in placements]
              == [by_name[p.service].n_stages + 1 for p in placements],
              f"scheduler: {step} stage nodes {placements}")
        check(abs(watts - total) <= 1e-5 * max(total, 1.0) + 1e-3,
              f"scheduler: {step} watts {watts} vs fleet {total}")
        out[step] = dict(total_w=total, placements=[
            dict(service=p.service, stage_nodes=p.stage_nodes,
                 power_w=p.power_w) for p in placements])
        if step == "placed":
            sav = sched.savings_vs_cloud()
            check(sav["saving_frac"] > 0.0, f"scheduler: saving {sav}")
            out["savings_vs_cloud"] = sav
    check([p["service"] for p in out["after_remove"]["placements"]]
          == [cfg.name] and not sched.rejected and not sched.queued,
          f"scheduler: after the removal {out['after_remove']}")
    # the ledger over two hours: both services, then qwen alone
    energy = tel.ledger.integrate(t_end=2.0)
    check(len(tel.ledger.samples) == len(sched.session.stats)
          and abs(sum(energy["joules_by_tier"].values())
                  - energy["joules_proc"]) <= 1e-6 * energy["joules_proc"],
          f"scheduler: ledger {tel.ledger.samples}")
    out.update(monitor=mon.snapshot(), ledger_joules=energy,
               seconds=time.perf_counter() - t0)
    return out


# phase 6: training on one device.  6a the differentiable attention on the
# card: B, H, KH, S, D, dtype, window, cap, dead kv slots (-1 positions);
# then one attention block at full width (B 2, S 1024) of qwen3-4b (D 128)
# and of h2o-danube-3-4b (D 120, its 4096-slot window)
TRAIN_ATTN_CASES = (
    (2, 32, 8, 1024, 128, "bfloat16", None, None, 0),   # wgmma, qwen3-4b
    (2, 32, 8, 1024, 120, "bfloat16", 4096, None, 0),   # wgmma, danube
    (2, 8, 2, 1024, 64, "bfloat16", 256, 30.0, 16),     # wgmma, D 64
    (4, 4, 1, 512, 32, "bfloat16", 64, 30.0, 5),        # wgmma, D 32 smoke
    (2, 8, 4, 512, 128, "float32", 128, 50.0, 16),      # SIMT, float32
)
TRAIN_BLOCK_CONFIGS = ("qwen3-4b", "h2o-danube-3-4b")
TRAIN_BLOCK_S = 1024
# 6b: qwen3-4b at full width (d 2560, 32 / 8 heads of 128, d_ff 9728,
# vocab 151936), bf16 compute over float32 masters, remat "full", the
# reference's train_4k length, 8 steps on one batch (as
# tests/test_models.py:54 trains).  Depth cut from 36: masters, gradients,
# both moments and the bf16 copy take 18 B a parameter, 79.4 GB at 36
# layers, the whole card before any activation; TRAIN_LAYERS is the
# deepest depth whose measured peak stays under TRAIN_PEAK_FRAC of the
# card (NVIDIA H100 80GB HBM3, 85017493504 B: 24 layers peaked at
# 66662262272 B, 29 at 76825079296 B, 0.904 of it; ~2.03 GB a layer).  The
# batch is cut from train_4k's 256 to 4 sequences, 2 microbatches of 2,
# by memory and the script's time
TRAIN_LAYERS = 28
TRAIN_S = 4096
TRAIN_B = 4
TRAIN_ACCUM = 2
TRAIN_STEPS = 8
TRAIN_LR = 5e-3
TRAIN_PEAK_FRAC = 0.9
# 6c: the train CLI on the smoke configuration, as
# tests/test_system.py::test_train_cli_improves_loss runs the reference's
TRAIN_CLI_ARGS = ["--arch", "qwen3-4b", "--steps", "12", "--batch", "4",
                  "--seq", "32", "--lr", "5e-3", "--report-energy"]


def _attention_grads(q, k, v, do, qp, kp, kw, forward=None, exact=False):
    """[dq, dk, dv] in float32 of ``kernels.flash_attention.attend`` (the
    CUDA forward, or ``forward`` swapped in for it for this call), or with
    ``exact`` of autograd through ``attention_plain`` on float32 copies."""
    from repro_torch.kernels import flash_attention as fa
    leaves = [(t.detach().float() if exact else t.detach().clone())
              .requires_grad_() for t in (q, k, v)]
    real = fa.flash_attention_cuda
    if forward is not None:
        fa.flash_attention_cuda = forward
    try:
        if exact:
            out = fa.attention_plain(*leaves, q_positions=qp,
                                     kv_positions=kp, **kw)
        else:
            out = fa.attend(*leaves, qp, kp, **kw)
        out.backward(do.to(out.dtype))
    finally:
        fa.flash_attention_cuda = real
    return [t.grad.float() for t in leaves]


def _plain_forward(q, k, v, q_positions, kv_positions, **kw):
    """The kernel's plain version in the kernel's output dtype: what 6a
    swaps in for ``flash_attention_cuda``."""
    from repro_torch.kernels import flash_attention as fa
    return fa.attention_plain(q, k, v, q_positions=q_positions,
                              kv_positions=kv_positions, **kw).to(q.dtype)


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_train_attention() -> dict:
    """Phase 6a: the differentiable attention (``attend``: the kernel's
    forward, the reference's chunked backward in plain torch) on the card.
    Per case, the forward against the plain forward (2e-2 bf16 / 2e-3
    float32, absolute), and dq / dk / dv with the CUDA forward against the
    same ``Function`` with the plain forward and against autograd through
    ``attention_plain`` in float32: within 2e-2 (bf16) / 2e-3 (float32)
    of each gradient's largest magnitude, every gradient non-zero.  Then
    one attention block at full width of qwen3-4b and of h2o-danube-3-4b
    (bf16 copy of float32 masters): its wq / wk / wv gradients non-zero
    and within 2e-2 of those with the plain forward.  In the first case
    the public ``kernels.ops.flash_attention`` too: its output has a
    ``grad_fn`` and its gradients are attend's.  Returns the flash
    launches of the blocks' CUDA passes."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ops
    t_all = time.perf_counter()
    dev = "cuda"
    cases = []
    for B, H, KH, S, D, dt, window, cap, dead in TRAIN_ATTN_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(S + D)
        q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dtype)
                       for sh in ((B, S, H, D), (B, S, KH, D),
                                  (B, S, KH, D), (B, S, H, D)))
        qp = torch.arange(S, dtype=torch.int32, device=dev)
        kp = qp.clone()
        kp[:dead] = -1
        kw = dict(causal=True, window=window, logit_cap=cap)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
        fwd_err = float((fa.flash_attention_cuda(q, k, v, qp, kp, **kw)
                         .float() - _plain_forward(q, k, v, qp, kp, **kw)
                         .float()).abs().max())
        check(fwd_err <= tol, f"train attention {dt} D {D}: forward vs "
                              f"the plain forward {fwd_err} > {tol}")
        fa.reset_launches()
        kernel = _attention_grads(q, k, v, do, qp, kp, kw)
        launched = {kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                    for kn in fa.KERNELS}
        plain = _attention_grads(q, k, v, do, qp, kp, kw,
                                 forward=_plain_forward)
        exact = _attention_grads(q, k, v, do, qp, kp, kw, exact=True)
        want = fa.choose_kernel(dtype, D, D, S * (H // KH))
        check(launched[want] == 1 and sum(launched.values()) == 1,
              f"train attention {dt} D {D}: launches {launched}, "
              f"expected one {want}")
        errs = {}
        for name, a, b, c in zip(("dq", "dk", "dv"), kernel, plain, exact):
            check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
                  f"train attention {dt} D {D}: {name} zero or not finite")
            errs[name] = dict(vs_plain=_rel_err(a, b),
                              vs_attention_plain=_rel_err(a, c))
            check(max(errs[name].values()) <= tol,
                  f"train attention {dt} D {D}: {name} {errs[name]} > {tol}")
        cases.append(dict(B=B, H=H, KH=KH, S=S, D=D, dtype=dt,
                          window=window, cap=cap, dead_slots=dead,
                          kernel=want, tol=tol, forward_max_abs_err=fwd_err,
                          rel_err=errs))
        if not dead and window is None and cap is None:
            # the public wrapper in the TPU kernel's layout differentiates
            # as attend does
            leaves = [t.detach().transpose(1, 2).clone().requires_grad_()
                      for t in (q, k, v)]
            out = ops.flash_attention(*leaves, causal=True)
            check(out.grad_fn is not None,
                  f"train attention {dt} D {D}: ops.flash_attention "
                  "output has no grad_fn")
            out.backward(do.transpose(1, 2))
            for name, t, want_g in zip(("dq", "dk", "dv"), leaves, kernel):
                err = _rel_err(t.grad.transpose(1, 2).float(), want_g)
                check(err <= tol, f"train attention {dt} D {D}: "
                      f"ops.flash_attention {name} {err} > {tol}")
            cases[-1]["ops_flash_attention_has_grad_fn"] = True

    # one attention block at full width of each of TRAIN_BLOCK_CONFIGS
    blocks, launches = {}, {}
    for arch in TRAIN_BLOCK_CONFIGS:
        cfg = configs.get(arch)
        blocks[arch] = train_block(cfg)
        for name, n in blocks[arch]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    emit("train_attention", cases=cases, block=blocks["qwen3-4b"],
         blocks=blocks, seconds=time.perf_counter() - t_all)
    return launches


def train_block(cfg) -> dict:
    """6a's block check: one attention block of ``cfg`` at full width (B
    2, S ``TRAIN_BLOCK_S``, bf16 copy of float32 masters from seed 1), its
    wq / wk / wv gradients with the CUDA forward non-zero and within 2e-2
    of those with the plain forward, its one flash launch on
    ``choose_kernel``'s kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L, model as M
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    ini = L.Init(g, torch.device(dev), torch.float32)
    M.init_block(ini, cfg, "attn")
    masters = {n: t.requires_grad_() for n, t in ini.params.items()}
    x = torch.randn((2, TRAIN_BLOCK_S, cfg.d_model), generator=g,
                    device=dev).bfloat16()
    w = torch.randn((2, TRAIN_BLOCK_S, cfg.d_model), generator=g,
                    device=dev)
    pos = torch.arange(TRAIN_BLOCK_S, dtype=torch.int32, device=dev)

    def block_grads(forward=None):
        for t in masters.values():
            t.grad = None
        real = fa.flash_attention_cuda
        if forward is not None:
            fa.flash_attention_cuda = forward
        try:
            p16 = {n: t.to(torch.bfloat16) for n, t in masters.items()}
            y, _ = M.apply_block(p16, x, cfg, "attn", positions=pos)
            (y.float() * w).sum().backward()
        finally:
            fa.flash_attention_cuda = real
        return {n: masters[n].grad.clone() for n in ("wq", "wk", "wv")}

    fa.reset_launches()
    kernel = block_grads()
    block_launches = dict(fa.LAUNCHES)
    plain = block_grads(_plain_forward)
    block = {}
    for n in kernel:
        block[n] = dict(max_abs=float(kernel[n].abs().max()),
                        rel_err=_rel_err(kernel[n], plain[n]))
        check(block[n]["max_abs"] > 0 and block[n]["rel_err"] <= 2e-2,
              f"train block {cfg.name}: {n} grad {block[n]} (non-zero, "
              "2e-2)")
    want = "flash_attention_" + fa.choose_kernel(
        torch.bfloat16, cfg.head_dim, cfg.head_dim,
        TRAIN_BLOCK_S * cfg.n_heads // cfg.n_kv_heads)
    check(block_launches[want] == 1 and block_launches["flash_attention"]
          == 1, f"train block {cfg.name}: launches {block_launches}, "
          f"expected one {want}")
    return dict(config=cfg.name, B=2, S=TRAIN_BLOCK_S, head_dim=cfg.head_dim,
                grads=block, launches=block_launches)


def train_matmul_params(cfg) -> tuple:
    """(N, formula): the parameters a token meets in a matrix product of a
    dense attention model (the projections, the gated MLP, lm_head; not
    the embedding gather)."""
    D, H, KH, Dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.n_layers)
    n = L * (D * H * Dh + 2 * D * KH * Dh + H * Dh * D + 3 * D * F) + D * V
    return n, (f"N_mm = L (D H Dh + 2 D KH Dh + H Dh D + 3 D F) + D V = "
               f"{L} ({D} {H} {Dh} + 2 {D} {KH} {Dh} + {H} {Dh} {D} + 3 {D} "
               f"{F}) + {D} {V} = {n}; model FLOP a step = 6 N_mm tokens")


def phase_train(n_layers: int = TRAIN_LAYERS,
                steps: int = TRAIN_STEPS) -> dict:
    """Phase 6b: qwen3-4b training at full width through the port's entry
    points: ``train.step.init_state`` on the card from a seeded generator,
    ``make_train_step`` (bf16 compute copy, ``accum`` 2, AdamW lr 5e-3),
    ``data.pipeline.make_batch`` at 4 x 4096, ``steps`` steps on that
    batch.  Each step is split with CUDA events recorded around
    ``models.model.forward_train`` (a microbatch's forward; the span to the
    next forward, or to the optimizer, is its backward),
    ``kernels.flash_attention.flash_attention_backward`` (the attention's
    backward, inside the backward) and ``optim.adamw.apply_updates``.
    Checks: the last loss below the first, loss and grad_norm finite at
    every step, every master's gradient finite and every attention
    projection's non-zero at every step, the flash launches all on the
    kernel ``choose_kernel`` names, the peak under ``TRAIN_PEAK_FRAC`` of
    the card.  Returns the flash launches of the steps and the phase's
    record."""
    import dataclasses
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as T
    t_all = time.perf_counter()
    dev = "cuda"
    cfg = dataclasses.replace(configs.get("qwen3-4b"), n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = T.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated()
    step = T.make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR),
                             accum=TRAIN_ACCUM)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
        cfg, DataConfig(seed=0, batch=TRAIN_B, seq_len=TRAIN_S), 0).items()}
    names = [n for n, _ in state.model.named_parameters()]
    proj = [i for i, n in enumerate(names)
            if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")]
    check(len(proj) == 3 * n_layers, f"train: {len(proj)} projections")

    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    real = (M.forward_train, adamw.apply_updates,
            fa.flash_attention_backward)

    def forward(*a, **kw):
        mark("fwd0")
        out = real[0](*a, **kw)
        mark("fwd1")
        return out

    def attn_backward(*a, **kw):
        mark("attn0")
        out = real[2](*a, **kw)
        mark("attn1")
        return out

    def update(params, grads, *a, **kw):
        mark("bwd_end")
        finite = torch.stack([torch.isfinite(gr).all() for gr in grads])
        nonzero = torch.stack([grads[i].abs().max() > 0 for i in proj])
        check(bool(finite.all()), "train: a master's gradient is not "
              f"finite: {[names[i] for i in np.flatnonzero(finite.cpu())]}")
        check(bool(nonzero.all()), "train: an attention projection got a "
              "zero gradient")
        mark("opt0")
        out = real[1](params, grads, *a, **kw)
        mark("opt1")
        return out

    def spans(a, b):
        ta = [e for lab, e in marks if lab == a]
        tb = [e for lab, e in marks if lab == b]
        check(len(ta) == len(tb), f"train: marks {a} / {b}")
        return [x.elapsed_time(y) for x, y in zip(ta, tb)]

    flash_kernel = fa.choose_kernel(torch.bfloat16, cfg.head_dim,
                                    cfg.head_dim,
                                    TRAIN_S * cfg.n_heads // cfg.n_kv_heads)
    per_step, losses, gnorms = [], [], []
    M.forward_train, adamw.apply_updates, fa.flash_attention_backward = (
        forward, update, attn_backward)
    try:
        fa.reset_launches()
        for i in range(steps):
            marks.clear()
            launch0 = dict(fa.LAUNCHES)
            mark("step0")
            state, metrics = step(state, batch)
            mark("step1")
            torch.cuda.synchronize()
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            check(math.isfinite(losses[-1]) and math.isfinite(gnorms[-1]),
                  f"train: step {i} loss {losses[-1]} gnorm {gnorms[-1]}")
            fwd = spans("fwd0", "fwd1")
            starts = [e for lab, e in marks if lab == "fwd1"]
            ends = [e for lab, e in marks if lab == "fwd0"][1:] + \
                [e for lab, e in marks if lab == "bwd_end"]
            step0 = marks[0][1]
            first_fwd = next(e for lab, e in marks if lab == "fwd0")
            per_step.append(dict(
                step_ms=spans("step0", "step1")[0],
                cast_ms=step0.elapsed_time(first_fwd),
                forward_ms=sum(fwd),
                backward_ms=sum(a.elapsed_time(b)
                                for a, b in zip(starts, ends)),
                attention_backward_ms=sum(spans("attn0", "attn1")),
                attention_backward_calls=len(spans("attn0", "attn1")),
                optimizer_ms=spans("opt0", "opt1")[0],
                loss=losses[-1], grad_norm=gnorms[-1],
                lr=float(metrics["lr"]),
                flash_launches={kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                                - launch0[f"flash_attention_{kn}"]
                                for kn in fa.KERNELS}))
        launches = {kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                    for kn in fa.KERNELS}
    finally:
        M.forward_train, adamw.apply_updates, fa.flash_attention_backward = \
            real
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    check(losses[-1] < losses[0], f"train: loss {losses[0]} -> "
          f"{losses[-1]} did not fall")
    check(launches[flash_kernel] > 0
          and sum(launches.values()) == launches[flash_kernel],
          f"train: flash launches {launches}, expected all {flash_kernel}")
    check(peak < TRAIN_PEAK_FRAC * card,
          f"train: peak {peak} B above {TRAIN_PEAK_FRAC} of {card}")
    steady = per_step[1:] or per_step
    med = lambda key: statistics.median(r[key] for r in steady)
    step_s = med("step_ms") / 1e3
    tokens = TRAIN_B * TRAIN_S
    n_mm, formula = train_matmul_params(cfg)
    params = M.param_count(state.model)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(
        config=cfg.name, n_layers=n_layers,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=params, compute_dtype="bfloat16", masters="float32",
        remat=cfg.remat_policy, batch=TRAIN_B, seq_len=TRAIN_S,
        accum=TRAIN_ACCUM, steps=steps, lr=TRAIN_LR,
        cut=f"depth {n_layers} of 36: float32 masters, gradients, both "
            f"moments and the bf16 copy take 18 B a parameter (79.4 GB at "
            f"36 layers); {n_layers} is the deepest depth measured under "
            f"{TRAIN_PEAK_FRAC} of the card (29 layers peaked at "
            f"76825079296 B of 85017493504); batch {TRAIN_B} x {TRAIN_S} "
            f"(2 microbatches of 2) of train_4k's 256 x 4096, by memory "
            f"and the script's time",
        init_s=init_s, resident_before_bytes=resident,
        state_bytes=state_bytes - resident, peak_bytes=peak,
        card_bytes=card, peak_frac=peak / card, losses=losses,
        grad_norms=gnorms, per_step=per_step,
        steady_step_s=step_s, steady_forward_s=med("forward_ms") / 1e3,
        steady_backward_s=med("backward_ms") / 1e3,
        steady_optimizer_s=med("optimizer_ms") / 1e3,
        steady_cast_s=med("cast_ms") / 1e3,
        attention_backward_s=med("attention_backward_ms") / 1e3,
        attention_backward_share=med("attention_backward_ms")
        / med("step_ms"),
        tokens_per_s=tokens / step_s, matmul_params=n_mm,
        model_tflop_per_s=6 * n_mm * tokens / step_s / 1e12,
        model_flops_formula=formula, flash_kernel=flash_kernel,
        launches=launches, seconds=time.perf_counter() - t_all)
    emit("train_qwen3_4b", **rec)
    return launches, rec


def phase_train_cli() -> dict:
    """Phase 6c: ``repro_torch.launch.train.main`` on the smoke
    configuration with ``--report-energy``: ``improved`` true, the
    placement line printed with a saving, both placement kernels and the
    flash kernel ``choose_kernel`` names launched.  Returns the launches,
    placement and flash kernels by kernel-line name."""
    import contextlib
    import io
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import placement_power as pp
    from repro_torch.launch import train as train_cli
    cfg = configs.get_smoke("qwen3-4b")
    out = io.StringIO()
    pp.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(TRAIN_CLI_ARGS)
    seconds = time.perf_counter() - t0
    launches = {**{name: pp.LAUNCHES[name] for name in MAIN_PATH_KERNELS},
                **{f"flash_attention_{kn}": fa.LAUNCHES[f"flash_attention_{kn}"]
                   for kn in fa.KERNELS}}
    lines = out.getvalue().strip().splitlines()
    summary, placed = json.loads(lines[-2]), json.loads(lines[-1])
    flash = "flash_attention_" + fa.choose_kernel(
        torch.bfloat16, cfg.head_dim, cfg.head_dim,
        32 * cfg.n_heads // cfg.n_kv_heads)
    check(rc == 0 and summary["improved"] is True,
          f"train CLI: rc {rc}, {summary}")
    check(placed["saving_frac"] > 0, f"train CLI: placement {placed}")
    for name in MAIN_PATH_KERNELS + (flash,):
        check(launches[name] > 0, f"train CLI: kernel {name} was not "
              f"launched ({launches})")
    check(sum(launches[f"flash_attention_{kn}"] for kn in fa.KERNELS)
          == launches[flash], f"train CLI: flash launches {launches}")
    emit("train_cli", argv=TRAIN_CLI_ARGS, config=cfg.name, lines=lines,
         summary=summary, placement=placed, launches=launches,
         seconds=seconds)
    return launches


# phase 7: distributed and resilient training on one card.  7a: qwen3-4b at
# full width (d 2560, 32 / 8 heads of 128, d_ff 9728, vocab 151936), depth
# cut to PAR_LAYERS (the plain state's masters kept beside a sharded state,
# and in 7b a restored copy beside the continuing one, each 12 B a
# parameter with its moments), float32 masters from generator seed 0, bf16
# compute, PAR_STEPS steps of a PAR_B x PAR_S ``make_batch`` batch on a
# ("pod", "data", "model") (1, 1, 1) mesh over NCCL, with and without the
# pod compression, against the plain single-device step
PAR_LAYERS = 2
PAR_B = 2
PAR_S = 4096
PAR_STEPS = 2
PAR_LR = 5e-3
PAR_AXES = ("pod", "data", "model")
PAR_CKPT = ROOT / "build" / "chip_smoke_ckpt"
# 7c: ResilientTrainer on the smoke qwen3-4b as the reference's replay test
# runs it (tests/test_substrate.py:78-99: 2 layers, batch 2 x 16, lr 1e-3,
# 8 steps, a failure at step 6, a checkpoint every 4); then the train CLI
# with --ckpt-dir for RES_CLI_STEPS steps, again for twice as many (it
# resumes), and once uninterrupted
RES_STEPS = 8
RES_FAIL_AT = 6
RES_CKPT_EVERY = 4
RES_CLI_STEPS = 6
RES_CLI_ARGS = ["--arch", "qwen3-4b", "--batch", "4", "--seq", "32",
                "--lr", "5e-3"]


def _leaf_rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (0 when both are 0)."""
    got, want = got.detach().float(), want.detach().float()
    diff = float((got - want).abs().max())
    return diff / max(float(want.abs().max()), 1e-30)


def _state_bytes(state) -> int:
    from repro_torch.checkpoint import store
    return sum(t.numel() * t.element_size() for _, t in store._flatten(state))


def phase_train_sharded(mesh) -> dict:
    """Phase 7a and 7b: the sharded train step
    (``train.step.make_train_step`` on a state from
    ``init_state(..., mesh=...)``) at qwen3-4b's full width against the
    plain step from the same seed and batches: loss rel <= 1e-5 at every
    step, every leaf within 1e-4 of its largest magnitude, with and
    without ``compress_pod`` (the identity at one pod: ``err`` stays 0);
    each step's seconds.  Then one checkpoint of the sharded state
    (``checkpoint.CheckpointStore``): its bytes, the target's free space,
    the caller's stall in ``save()``, the write's seconds (``wait()``),
    the restore's (into the ``meta`` skeleton, re-split on the mesh); the
    restored state's next step equal to the continuing state's (loss rel
    <= 1e-5); the directory removed.  Returns the flash launches."""
    import dataclasses
    import gc
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.train import step as T
    t_all = time.perf_counter()
    dev = "cuda"
    cfg = dataclasses.replace(configs.get("qwen3-4b"), n_layers=PAR_LAYERS)
    opt = adamw.AdamWConfig(lr=PAR_LR)
    dcfg = DataConfig(seed=0, batch=PAR_B, seq_len=PAR_S)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in make_batch(cfg, dcfg, i).items()}
               for i in range(PAR_STEPS + 1)]
    gen = lambda: torch.Generator(device=dev).manual_seed(0)

    def run(state, step, first, n):
        losses, norms, secs = [], [], []
        for i in range(first, first + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
            check(math.isfinite(losses[-1]) and math.isfinite(norms[-1]),
                  f"train sharded: step {i} loss {losses[-1]} "
                  f"gnorm {norms[-1]}")
        return state, dict(losses=losses, grad_norms=norms, step_s=secs)

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    plain, rec = run(T.init_state(cfg, gen(), device=dev),
                     T.make_train_step(cfg, opt), 0, PAR_STEPS)
    cells = {"plain": rec}
    launches_plain = {kn: fa.LAUNCHES[f"flash_attention_{kn}"]
                      for kn in fa.KERNELS}
    # from here on the counts are the sharded path's own
    fa.reset_launches()
    params = sum(p.numel() for p in plain.model.parameters())
    want = [p.detach().clone() for p in plain.model.parameters()]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    kept = None
    for name, compress in (("sharded_compress_pod", True),
                           ("sharded", False)):
        state, rec = run(T.init_state(cfg, gen(), compress_pod=compress,
                                      mesh=mesh),
                         T.make_train_step(cfg, opt, compress_pod=compress,
                                           mesh=mesh), 0, PAR_STEPS)
        rec["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
            rec["losses"], cells["plain"]["losses"]))
        rec["leaf_rel_err"] = max(_leaf_rel_err(p.to_local(), w) for p, w in
                                  zip(state.model.parameters(), want))
        rec["placements"] = sorted({str(p.placements)
                                    for p in state.model.parameters()})
        check(rec["loss_rel_err"] <= 1e-5 and rec["leaf_rel_err"] <= 1e-4,
              f"train sharded {name}: loss rel {rec['loss_rel_err']} "
              f"(1e-5), leaf rel {rec['leaf_rel_err']} (1e-4)")
        if compress:
            rec["err_max_abs"] = max(float(e.to_local().abs().max())
                                     for e in state.err)
            check(rec["err_max_abs"] == 0, "train sharded: compress_pod at "
                  f"one pod left a residual {rec['err_max_abs']}")
        else:
            kept = state
        rec["overhead_s"] = [a - b for a, b in zip(
            rec["step_s"], cells["plain"]["step_s"])]
        cells[name] = rec
        del state
        gc.collect()
        torch.cuda.empty_cache()
    del want
    peak_7a = torch.cuda.max_memory_allocated()

    # 7b: one checkpoint of the sharded state
    shutil.rmtree(PAR_CKPT, ignore_errors=True)
    store = CheckpointStore(str(PAR_CKPT))
    free = shutil.disk_usage(PAR_CKPT).free
    n_bytes = _state_bytes(kept)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.save(PAR_STEPS, kept, extra=dict(data_step=PAR_STEPS))
    stall = time.perf_counter() - t0
    t0 = time.perf_counter()
    store.wait()
    write_s = time.perf_counter() - t0
    on_disk = sum(f.stat().st_size for f in PAR_CKPT.rglob("*.npy"))
    like, axes = specs.train_state_specs(cfg)
    t0 = time.perf_counter()
    restored, extra = store.restore(None, like, mesh=mesh, axes=axes)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(extra == {"data_step": PAR_STEPS}, f"checkpoint: extra {extra}")
    step = T.make_train_step(cfg, opt, mesh=mesh)
    _, cont = run(kept, step, PAR_STEPS, 1)
    del kept, _
    gc.collect()
    torch.cuda.empty_cache()
    _, again = run(restored, step, PAR_STEPS, 1)
    del restored, _
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(again["losses"][0] - cont["losses"][0]) / abs(
        cont["losses"][0])
    check(rel <= 1e-5, f"checkpoint: restored next loss "
          f"{again['losses'][0]} vs {cont['losses'][0]} (rel {rel} > 1e-5)")
    shutil.rmtree(PAR_CKPT)
    launches = {kn: fa.LAUNCHES[f"flash_attention_{kn}"] for kn in fa.KERNELS}
    flash = fa.choose_kernel(torch.bfloat16, cfg.head_dim, cfg.head_dim,
                             PAR_S * cfg.n_heads // cfg.n_kv_heads)
    # each layer launches the forward once a step and once more in the
    # backward's recompute; the sharded steps are 7a's two cells and 7b's
    # continuing and restored steps
    want_launches = PAR_LAYERS * 2 * (2 * PAR_STEPS + 2)
    check(launches[flash] == want_launches
          and sum(launches.values()) == launches[flash],
          f"train sharded: flash launches {launches}, expected "
          f"{want_launches} on {flash}")
    emit("train_sharded", config=cfg.name, n_layers=PAR_LAYERS,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
         params=params, mesh=dict(zip(PAR_AXES, mesh.shape)),
         batch=PAR_B, seq_len=PAR_S, steps=PAR_STEPS,
         lr=PAR_LR, compute_dtype="bfloat16", masters="float32",
         cut=f"depth {PAR_LAYERS} of 36: the plain state's masters beside "
             f"a sharded state, then a restored copy beside the continuing "
             f"one, each 12 B a parameter; batch {PAR_B} x {PAR_S} of "
             f"train_4k's 256 x 4096; world size 1 (one card)",
         cells=cells, peak_bytes_7a=peak_7a,
         checkpoint=dict(dir=str(PAR_CKPT.relative_to(ROOT)),
                         state_bytes=n_bytes, bytes_on_disk=on_disk,
                         free_bytes_before=free, save_stall_s=stall,
                         write_s=write_s, restore_s=restore_s,
                         write_gb_per_s=on_disk / write_s / 1e9,
                         continuing_loss=cont["losses"][0],
                         restored_loss=again["losses"][0],
                         loss_rel_err=rel, step_s=[cont["step_s"][0],
                                                   again["step_s"][0]]),
         flash_kernel=flash, launches=launches,
         launches_plain=launches_plain,
         seconds=time.perf_counter() - t_all)
    return launches


def phase_resilience() -> dict:
    """Phase 7c: ``fault.runner.ResilientTrainer`` on the card, a clean run
    and one with a ``SimulatedFailure`` at step RES_FAIL_AT and a
    checkpoint every RES_CKPT_EVERY steps: one restart, the losses after
    it within rtol 1e-5 of the clean run's (the reference's bound,
    tests/test_substrate.py:98).  Then ``launch.train.main`` with
    ``--ckpt-dir``: RES_CLI_STEPS steps, then twice as many on the same
    directory (it resumes at RES_CLI_STEPS: its first loss is not the
    first run's, its last within rtol 1e-5 of an uninterrupted run's).
    Returns the flash launches."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.fault import ResilientTrainer, SimulatedFailure
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw
    from repro_torch.train import step as T
    t_all = time.perf_counter()
    dev = "cuda"
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), n_layers=2)
    dcfg = DataConfig(seed=0, batch=2, seq_len=16)
    step = T.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    init_fn = lambda: T.init_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    root = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(root, ignore_errors=True)
    fa.reset_launches()
    runs = {}
    for name, fail in (("clean", {}),
                       ("failed", {RES_FAIL_AT: SimulatedFailure("7c")})):
        t0 = time.perf_counter()
        trainer = ResilientTrainer(cfg, dcfg, step, init_fn,
                                   str(root / name), RES_CKPT_EVERY,
                                   device=dev)
        rep = trainer.run(RES_STEPS, fail_at=fail)
        runs[name] = dict(losses=rep.losses, restarts=rep.restarts,
                          final_step=rep.final_step,
                          straggler_steps=rep.straggler_steps,
                          seconds=time.perf_counter() - t0)
    clean, failed = runs["clean"], runs["failed"]
    restart_at = RES_FAIL_AT // RES_CKPT_EVERY * RES_CKPT_EVERY
    after = failed["losses"][RES_FAIL_AT:]
    want = clean["losses"][restart_at:]
    replay_rel = max(abs(a - b) / abs(b) for a, b in zip(after, want))
    check(failed["restarts"] == 1 and clean["restarts"] == 0
          and len(after) == len(want) == RES_STEPS - restart_at,
          f"resilience: restarts {failed['restarts']}, losses "
          f"{failed['losses']}")
    check(replay_rel <= 1e-5, f"resilience: replayed losses {after} vs "
          f"{want} (rel {replay_rel} > 1e-5)")

    cli = {}
    ck = root / "cli"
    for name, steps, ckpt in (("first", RES_CLI_STEPS, True),
                              ("resumed", 2 * RES_CLI_STEPS, True),
                              ("whole", 2 * RES_CLI_STEPS, False)):
        out = io.StringIO()
        argv = RES_CLI_ARGS + ["--steps", str(steps)] + (
            ["--ckpt-dir", str(ck)] if ckpt else [])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(argv)
        cli[name] = dict(argv=argv, rc=rc, seconds=time.perf_counter() - t0,
                         **json.loads(out.getvalue().strip()
                                      .splitlines()[-1]))
    store = CheckpointStore(str(ck))
    resume_rel = abs(cli["resumed"]["last_loss"] - cli["whole"]["last_loss"]
                     ) / abs(cli["whole"]["last_loss"])
    check(all(r["rc"] == 0 for r in cli.values())
          and store.latest_step() == 2 * RES_CLI_STEPS
          and (ck / f"step_{RES_CLI_STEPS}").is_dir()
          and cli["resumed"]["first_loss"] != cli["first"]["first_loss"]
          and cli["first"]["first_loss"] == cli["whole"]["first_loss"],
          f"resilience: the CLI did not resume: {cli}")
    check(resume_rel <= 1e-5, f"resilience: the resumed CLI run ends at "
          f"{cli['resumed']['last_loss']}, an uninterrupted one at "
          f"{cli['whole']['last_loss']} (rel {resume_rel} > 1e-5)")
    shutil.rmtree(root)
    launches = {kn: fa.LAUNCHES[f"flash_attention_{kn}"] for kn in fa.KERNELS}
    flash = fa.choose_kernel(torch.bfloat16, cfg.head_dim, cfg.head_dim,
                             dcfg.seq_len * cfg.n_heads // cfg.n_kv_heads)
    check(launches[flash] > 0 and sum(launches.values()) == launches[flash],
          f"resilience: flash launches {launches}, all on {flash} wanted")
    emit("resilience", config=cfg.name, n_layers=2, batch=dcfg.batch,
         seq_len=dcfg.seq_len, steps=RES_STEPS, fail_at=RES_FAIL_AT,
         ckpt_every=RES_CKPT_EVERY, runs=runs, replay_rel_err=replay_rel,
         cli=cli, cli_resume_rel_err=resume_rel, launches=launches,
         seconds=time.perf_counter() - t_all)
    return launches


def phase_parallel() -> dict:
    """Phase 7: a ("pod", "data", "model") (1, 1, 1) mesh over NCCL
    (``launch.mesh.make_mesh``: a one-process group on an in-process
    store), 7a / 7b on it, 7c; the process group destroyed.  Returns the
    flash launches of the phase by kernel-line name."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh((1, 1, 1), PAR_AXES)
    emit("mesh", axes=list(mesh.mesh_dim_names), shape=list(mesh.shape),
         backend=dist.get_backend(), world_size=dist.get_world_size(),
         seconds=time.perf_counter() - t0)
    try:
        total = phase_train_sharded(mesh)
        for kn, n in phase_resilience().items():
            total[kn] += n
    finally:
        dist.destroy_process_group()
    return {f"flash_attention_{kn}": n for kn, n in total.items()}


# phase 8: the dry run (``launch/dryrun.py``) on a (1, 1) mesh of sizes at
# the shapes the card ran, held against 5f's and 6b's measurements: the
# predicted peak within DRYRUN_PEAK_TOL of the measured one for gemma2-27b's
# prefill and 6b's step, every cell fitting the card.  The weights take
# most of either peak (56.8 GB of gemma2-27b's 62.8), so the traced
# temporaries are held apart, within DRYRUN_TEMP_TOL of what the card
# allocated above what was live before the step: the prefill's peak less
# its resident bytes, 6b's peak less its state (masters and moments).
# Their ratios on the card were 1.0 and 0.9971 (NVIDIA H100 80GB HBM3,
# 700.00 W), so 0.05 still catches a wrong count of the activations
DRYRUN_MESH = {"data": 1, "model": 1}
DRYRUN_PEAK_TOL = 0.15
DRYRUN_TEMP_TOL = 0.05


def phase_dryrun(served: dict, trained: dict, card: str, cmdr: dict,
                 cmdr_depth_: dict) -> None:
    """Phase 8: ``dryrun.run_cell`` on ``DRYRUN_MESH`` for (i) gemma2-27b's
    prefill at 5f's shape (8 x 1024 tokens, ``SERVE_SMAX`` slots), (ii) its
    decode step against that cache, (iii) qwen3-4b's train step at 6b's
    shape (``TRAIN_LAYERS`` layers, ``TRAIN_B`` x ``TRAIN_S``,
    ``TRAIN_ACCUM`` microbatches, remat "full").  On meta: nothing runs on
    the card, and 5f's and 6b's measurements (``served``, ``trained``) are
    reused.  Per cell: the predicted peak against the measured one (the
    peak counter's reading less what was live before the phase: 5f's
    reset before its step-by-step prefill, 6b's over its steps),
    ``roofline.bound_s`` against the measured seconds as their share, and
    model FLOPs / measured s / the card's bf16 peak (MFU).  Checks the
    peaks of (i) and (iii) within ``DRYRUN_PEAK_TOL``, their temporaries
    within ``DRYRUN_TEMP_TOL`` and ``fits_card`` for all three.  (iv)
    command-r-plus-104b's prefill at 5g's depth and shape: its record is
    the one 5g's depth came from (``cmdr_depth_``), held against 5g's
    sharded run (``cmdr``) as (i) is against 5f: the traced step is the
    rank's sharded step on a (1, 1) mesh, the one that run took."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh as mesh_mod
    t0 = time.perf_counter()
    gemma = configs.get(GEMMA_ARCH)
    qwen = dataclasses.replace(configs.get("qwen3-4b"),
                               n_layers=trained["n_layers"])
    cells = {
        "gemma2_27b_prefill": dict(
            arch=GEMMA_ARCH, cfg=gemma, cache_len=SERVE_SMAX,
            shape=configs.Shape("prefill_5f", SERVE_S, SERVE_B, "prefill"),
            peak=served["prefill_peak_bytes"]
            - served["resident_before_bytes"],
            temp=served["prefill_peak_bytes"]
            - served["prefill_resident_bytes"],
            seconds=served["prefill_s"]),
        "gemma2_27b_decode": dict(
            arch=GEMMA_ARCH, cfg=gemma, cache_len=SERVE_SMAX,
            shape=configs.Shape("decode_5f", SERVE_SMAX, SERVE_B, "decode"),
            peak=None, temp=None,
            seconds=served["decode_ms_per_step"] / 1e3),
        "qwen3_4b_train": dict(
            arch="qwen3-4b", cfg=qwen, cache_len=None,
            shape=configs.Shape("train_6b", TRAIN_S, TRAIN_B, "train"),
            peak=trained["peak_bytes"] - trained["resident_before_bytes"],
            temp=trained["peak_bytes"] - trained["resident_before_bytes"]
            - trained["state_bytes"],
            seconds=trained["steady_step_s"]),
        "command_r_plus_104b_prefill": dict(
            arch=CMDR_ARCH, cache_len=SERVE_SMAX, rec=cmdr_depth_["record"],
            shape=cmdr_depth_["shape"],
            peak=cmdr["prefill_peak_bytes"] - cmdr["resident_before_bytes"],
            temp=cmdr["prefill_peak_bytes"] - cmdr["prefill_resident_bytes"],
            seconds=cmdr["prefill_s"]),
    }
    out = {}
    for name, c in cells.items():
        rec = c.get("rec") or dryrun.run_cell(
            c["arch"], c["shape"], mesh=DRYRUN_MESH,
            accum=TRAIN_ACCUM if c["shape"].kind == "train" else None,
            cfg=c["cfg"], cache_len=c["cache_len"], verbose=False)
        mem, roof = rec["memory"], rec["roofline"]
        pred = mem["peak_per_device_bytes"]
        model_fl = rec["model_flops"]["total_flops"]
        row = dict(
            shape=dict(seq_len=c["shape"].seq_len,
                       batch=c["shape"].global_batch, kind=c["shape"].kind,
                       cache_len=c["cache_len"]),
            trace_s=rec["trace_s"], accum=rec["accum"],
            predicted_peak_bytes=pred, measured_peak_bytes=c["peak"],
            peak_ratio=pred / c["peak"] if c["peak"] else None,
            argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], measured_temp_bytes=c["temp"],
            temp_ratio=mem["temp_bytes"] / c["temp"] if c["temp"] else None,
            fits_card=mem["fits_card"],
            dot_flops=rec["counted"]["dot_flops"],
            bytes_accessed=rec["counted"]["bytes_accessed"],
            kernel_calls=rec["counted"]["kernel_calls"],
            model_flops=model_fl,
            useful_flops_ratio=rec["useful_flops_ratio"],
            serving_pattern=rec["serving_pattern"],
            cache_sharded=rec["cache_sharded"],
            roofline=roof, measured_s=c["seconds"],
            bound_share=roof["bound_s"] / c["seconds"],
            mfu=model_fl / c["seconds"] / mesh_mod.PEAK_FLOPS_BF16)
        check(mem["fits_card"], f"dryrun {name}: predicted {pred} B does "
                                f"not fit {mem['card_bytes']}")
        if c["peak"] is not None:
            check(abs(pred / c["peak"] - 1) <= DRYRUN_PEAK_TOL,
                  f"dryrun {name}: predicted peak {pred} B against the "
                  f"measured {c['peak']} B (tolerance {DRYRUN_PEAK_TOL})")
        if c["temp"] is not None:
            check(abs(mem["temp_bytes"] / c["temp"] - 1) <= DRYRUN_TEMP_TOL,
                  f"dryrun {name}: predicted temporaries {mem['temp_bytes']}"
                  f" B against the measured {c['temp']} B (tolerance "
                  f"{DRYRUN_TEMP_TOL})")
        out[name] = row
    emit("dryrun", card=card, mesh=DRYRUN_MESH,
         peak_flops_bf16=mesh_mod.PEAK_FLOPS_BF16, hbm_bw=mesh_mod.HBM_BW,
         card_memory_bytes=mesh_mod.CARD_MEMORY_BYTES, cells=out,
         seconds=time.perf_counter() - t0)


# phase 9c's churn wave: the CPU contract test's scenario
# (tests/test_torch_cache_contract.py), on the card
ANALYSIS_WAVES = [[0], [1, 2, 3]]
# the kernels line's names -> the kinds of ``LAUNCH_SHAPES``
KERNEL_KIND = {"placement_power": "placement_power",
               "fused_anneal": "fused_anneal",
               "fused_anneal_global": "fused_anneal",
               "flash_attention_wgmma": "wgmma",
               "flash_attention_split_kv": "split_kv",
               "flash_attention_simt": "simt"}


def smem_rows() -> list:
    """Phase 9b: one row per CUDA template and shared-memory shape this
    run launched (``LAUNCH_SHAPES``): the Python mirror, the ``.cu``
    query's dynamic and static bytes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import placement_power as pp
    rows = []
    for shape in sorted(pp.LAUNCH_SHAPES | fa.LAUNCH_SHAPES,
                        key=lambda t: tuple(map(str, t))):
        kind, args = shape[0], shape[1:]
        if kind == "placement_power":
            mirror = pp.placement_power_launch_smem(*args)
            template = "placement_power_kernel"
            dyn, stat = _build.query("placement_power",
                                     "placement_power_smem", *args)
        elif kind == "fused_anneal":
            C, J, P, N, D, K = args
            variant, cpb = pp.fused_anneal_variant(C, J, P, N, D, K)
            gx = int(variant == "global")
            M = 2 * D * K
            spl = 2 if M <= 64 else 8 if M <= 256 else 32
            dt = D if M <= 64 and D in (1, 2) else 0
            template = f"fused_anneal_kernel<{spl}, {dt}, {bool(gx)}>"
            mirror = pp.fused_anneal_launch_smem(*args)
            dyn, stat = _build.query("fused_anneal", "fused_anneal_smem",
                                     J, P, N, D, K, cpb, gx)
        elif kind == "wgmma":
            D, Dv, Skv, cap = args
            nch, ncv = -(-D // fa.WGMMA_BOX), -(-Dv // fa.WGMMA_BOX)
            template = f"flash_attention_wgmma_kernel<{nch}, {ncv}, {cap}>"
            mirror = fa.wgmma_launch_smem(D, Dv, Skv)
            dyn, stat = _build.query("flash_attention_wgmma",
                                     "flash_attention_wgmma_smem", D, Dv,
                                     Skv, int(cap))
        elif kind == "split_kv":
            D, Dv, dt, n_rows, cps = args
            template = ("flash_attention_split_kernel<"
                        f"{'float' if dt == 0 else 'bf16'}>")
            mirror = fa.split_kv_launch_smem(D, Dv, 4 if dt == 0 else 2,
                                             n_rows, cps)
            dyn, stat = _build.query("flash_attention_decode",
                                     "flash_attention_decode_smem", *args)
        else:
            D, Dv, dt = args
            dv_ch = next(c for c, lim in ((1, 32), (2, 64), (4, 128),
                                          (8, 1 << 30))
                         if (Dv + 3) // 4 * 4 <= lim)
            template = (f"flash_attention_kernel<"
                        f"{'float' if dt == 0 else 'bf16'}, {dv_ch}>")
            mirror = fa.simt_launch_smem(D, Dv)
            dyn, stat = _build.query("flash_attention",
                                     "flash_attention_smem", *args)
        rows.append(dict(kernel=kind, template=template, shape=list(args),
                         mirror_bytes=mirror, requested_bytes=dyn,
                         static_bytes=stat))
    return rows


def phase_analysis(obs_tels: list, kernels: dict, card: str) -> None:
    """Phase 9: the static-analysis plane on the card's host and the card.

    (9a) the port's linter over ``src/repro_torch`` and this script, as
    the CLI runs it: exit 0, no finding, its seconds.  (9b) ``smem_rows``:
    every mirror equal to the launcher's request, static plus dynamic
    bytes within ``cudaDevAttrMaxSharedMemoryPerBlockOptin``, which equals
    ``SMEM_PER_BLOCK``, and every kernel with launches in the kernels
    line with a recorded shape.  (9c) ``Telemetry.report(bounds=)`` of
    phase 3h's two telemetry runs: every recorded entry within its
    static bound; then the CPU contract test's two-bucket churn wave on
    the card, the fingerprint cache cleared, a ``Telemetry`` attached:
    ``sweep`` and ``anneal_delta`` within their ``resolve_incremental``
    scenario bounds and within 2x of them, every recorded entry within
    its static bound."""
    import torch
    from repro_torch.analysis import compute_cache_bounds, load_project
    from repro_torch.core import power, solvers, topology, vsr
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import placement_power as pp
    from repro_torch.telemetry import Telemetry
    t0 = time.perf_counter()
    # (9a) the linter, as the CLI runs it
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--baseline",
           "analysis/baseline-torch.json", "--format", "json",
           "src/repro_torch", "chip_smoke.py"]
    t_lint = time.perf_counter()
    lint = subprocess.run(cmd, cwd=str(ROOT), capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                          "PATH": "/usr/bin:/bin"})
    lint_s = time.perf_counter() - t_lint
    check(lint.returncode == 0, f"analysis: the linter exited "
          f"{lint.returncode}: {lint.stdout[-800:]} {lint.stderr[-800:]}")
    report = json.loads(lint.stdout)
    check(report["findings"] == [] and report["total"] == 0,
          f"analysis: findings {report['findings'][:3]}")
    # (9b) shared memory: mirrors, requests, the opt-in limit
    optin = _build.query("placement_power", "device_smem_optin")[0]
    check(optin == pp.SMEM_PER_BLOCK == fa.SMEM_PER_BLOCK,
          f"analysis: the card's opt-in shared memory a block is {optin}, "
          f"SMEM_PER_BLOCK {pp.SMEM_PER_BLOCK}")
    rows = smem_rows()
    for r in rows:
        check(r["mirror_bytes"] == r["requested_bytes"],
              f"analysis: {r['template']} at {r['shape']}: the mirror "
              f"says {r['mirror_bytes']} B, the launcher requests "
              f"{r['requested_bytes']}")
        check(0 <= r["static_bytes"]
              and r["static_bytes"] + r["requested_bytes"] <= optin,
              f"analysis: {r['template']} at {r['shape']}: "
              f"{r['static_bytes']} static + {r['requested_bytes']} "
              f"dynamic bytes over the card's {optin}")
    launched = {r["kernel"] for r in rows}
    ran = {KERNEL_KIND[k["name"]] for k in kernels.values()
           if any(isinstance(v, int) and v > 0 for f, v in k.items()
                  if f.startswith("launches"))}
    check(ran <= launched, f"analysis: kernels {sorted(ran - launched)} "
          "launched with no recorded shape")
    # (9c) the static bounds against 3h's recorded shapes, then a fresh
    # churn wave on the card
    project, errors = load_project([str(ROOT / "src" / "repro_torch")])
    check(not errors, f"analysis: syntax errors {errors}")
    bounds = compute_cache_bounds(project)
    obs = []
    for tel in obs_tels:
        got = tel.report(bounds=bounds)["compiles"]
        check(all(c["within"] for c in got["bounds"].values()),
              f"analysis: 3h compiles over their bounds {got['bounds']}")
        obs.append({"recorded": got["recorded"], "bounds": got["bounds"]})
    topo = topology.paper_topology()
    vs = vsr.random_vsrs(6, rng=0, n_vms=5,
                         source_nodes=topo.layer_indices("iot")[:3])
    problem = power.build_problem(topo, vs, device="cuda")
    state = power.init_state(problem,
                             solvers.fixed_layer(problem, topo, "iot").X)
    fixed = problem.host.fixed_mask
    realized = {solvers._pow2(int((~fixed[rows_]).sum()))
                for rows_ in ANALYSIS_WAVES}
    check(len(realized) == 2, f"analysis: wave buckets {realized}")
    tel = Telemetry()
    tel.attach_traces()
    solvers.clear_trace_cache()
    before = dict(solvers.TRACE_COUNTS)
    for rows_ in ANALYSIS_WAVES:
        solvers.resolve_wave(problem, state, rows_,
                             gen=solvers.default_generator(0),
                             anneal_steps=50, anneal_chains=4)
    torch.cuda.synchronize()
    measured = {k: v - before.get(k, 0) for k, v in
                solvers.TRACE_COUNTS.items() if v != before.get(k, 0)}
    rep = tel.report(bounds=bounds)["compiles"]
    tel.close()
    check(rep["agree"] and rep["recorded"] == measured
          and all(c["within"] for c in rep["bounds"].values()),
          f"analysis: churn attribution {rep}")
    cards = {"resolve_incremental.pad_changed_to": len(realized),
             "resolve_incremental.pad_positions_to": 1}
    scenario = {}
    for entry in ("sweep", "anneal_delta"):
        b = bounds[entry].evaluate(sites=["resolve_incremental"],
                                   axis_cards=cards)
        n = measured.get(entry, 0)
        check(b is not None and n <= b <= 2 * n,
              f"analysis: {entry} measured {n} against the scenario bound "
              f"{b}")
        scenario[entry] = {"measured": n, "scenario_bound": b,
                           "static_bound": bounds[entry].static_bound()}
    emit("analysis", card=card,
         lint={"findings": len(report["findings"]),
               "baselined": report["suppressed"], "seconds": lint_s,
               "command": " ".join(cmd[1:])},
         smem={"optin_bytes": optin,
               "smem_per_block": pp.SMEM_PER_BLOCK,
               "templates": sorted({r["template"] for r in rows}),
               "shapes": len(rows), "rows": rows},
         bounds={"static": {e: eb.static_bound()
                            for e, eb in sorted(bounds.items())},
                 "telemetry_3h": obs, "churn_wave": scenario},
         seconds=time.perf_counter() - t0)


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
        "fused_anneal_global": {
            "name": "fused_anneal_global", "route": "cuda",
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
    launches, det_loads = phase_city()
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches"] = launches[name]
    phase_paper_figures()
    phase_relax_city()
    launches = phase_anneal_past_cap()
    kernels["fused_anneal_global"]["launches"] = launches[
        "fused_anneal_global"]
    launches, churn_event_s, det_boot, boot_X = phase_churn()
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_churn"] = launches[name]
    emit("determinism", loads=det_loads, bootstrap=det_boot)
    launches, boot_X = phase_waves(churn_event_s, boot_X)
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_waves"] = launches[name]
    launches = phase_faults(boot_X)
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_faults"] = launches[name]
    launches = phase_federation()
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_federation"] = launches[name]
    launches, obs_tels = phase_telemetry()
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_telemetry"] = launches[name]
    for name in ("placement_power", "fused_anneal", "fused_anneal_global"):
        # no single PyTorch call computes either placement function
        kernels[name]["library_ms"] = None
    phase_flash(kernels)
    for kn, n in phase_serve().items():
        kernels[f"flash_attention_{kn}"]["launches"] = n
    launches, launches_f32 = phase_serve_moe()
    for name, n in launches.items():
        kernels[name]["launches_moe"] = n
    for name, n in launches_f32.items():
        kernels[name]["launches_moe_float32"] = n
    launches, launches_f32 = phase_serve_ssm()
    for name, n in launches.items():
        kernels[name]["launches_ssm"] = n
    for name, n in launches_f32.items():
        kernels[name]["launches_ssm_float32"] = n
    launches, launches_f32 = phase_serve_encdec()
    for name, n in launches.items():
        kernels[name]["launches_encdec"] = n
    for name, n in launches_f32.items():
        kernels[name]["launches_encdec_float32"] = n
    launches, launches_f32 = phase_serve_danube()
    for name, n in launches.items():
        kernels[name]["launches_danube"] = n
    for name, n in launches_f32.items():
        kernels[name]["launches_danube_float32"] = n
    launches, launches_f32, served = phase_serve_gemma()
    for name, n in launches.items():
        kernels[name]["launches_gemma2"] = n
    for name, n in launches_f32.items():
        kernels[name]["launches_gemma2_float32"] = n
    launches, launches_sh, launches_f32, cmdr, cmdr_depth_ = \
        phase_serve_cmdr()
    for tag, counts in (("cmdr", launches), ("cmdr_sharded", launches_sh),
                        ("cmdr_float32", launches_f32)):
        for name, n in counts.items():
            kernels[name][f"launches_{tag}"] = n
    launches, launches_f32 = phase_serve_tp()
    for tag, counts in (("tensor_parallel", launches),
                        ("tensor_parallel_float32", launches_f32)):
        for name, n in counts.items():
            kernels[name][f"launches_{tag}"] = n
    phase_train_attention()
    launches, trained = phase_train()
    launches_cli = phase_train_cli()
    for kn, n in launches.items():
        kernels[f"flash_attention_{kn}"]["launches_train"] = (
            n + launches_cli[f"flash_attention_{kn}"])
    for name in MAIN_PATH_KERNELS:
        kernels[name]["launches_train"] = launches_cli[name]
    for name, n in phase_parallel().items():
        kernels[name]["launches_parallel"] = n
    phase_dryrun(served, trained, card, cmdr, cmdr_depth_)
    phase_analysis(obs_tels, kernels, card)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
