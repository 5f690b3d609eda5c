"""Whether gloo carries the tensor-parallel serving path's collectives on
CUDA tensors of one card, two processes sharing it.

NCCL puts no two ranks of a group on one device, so a two-rank run on a
one-card machine needs gloo.  This script spawns two processes on
``cuda:0`` (or on the CPU with ``--device cpu``), joins them in a gloo
group on a ``file://`` store under ``build/gloo_probe/``, builds a
("data", "model") (1, 2) ``DeviceMesh`` on the device and calls, over its
"model" group, each collective the sharded serving path uses
(``parallel/sharding.py``'s tensor-parallel helpers and
``models/layers.py::combine_ranks``), in float32 and bf16, at a decode
size and a prefill size: ``all_gather_into_tensor``, ``all_reduce``
(sum), and, for comparison, ``all_to_all_single``, ``all_gather`` (list),
``broadcast`` and ``barrier``.  Each call's outcome (its error if
refused, its values against the expected ones, whether the output stays
on the device) and its milliseconds (CUDA events, the median of 5 calls
after one warm call) go into one JSON line, also written to
``chiprun_out/gloo_probe.json``.

Usage: python3 scripts/gloo_cuda_probe.py [--device cpu]
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
# (name, shape): a decode step's rows and a prefill's, at qwen3-4b's width
SIZES = (("decode", (8, 1, 2560)), ("prefill", (8, 1024, 2560)))


def _time(fn, device, reps: int = 5) -> float:
    import torch
    fn()
    out = []
    for _ in range(reps):
        if device == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def _probe(rank: int, device: str, group, name: str, dtype, shape):
    """One collective: (record, ok)."""
    import torch
    import torch.distributed as dist
    n = WORLD
    x = torch.full(shape, float(rank + 1), dtype=dtype, device=device)
    rec = {}
    try:
        if name == "all_gather_into_tensor":
            out = x.new_empty((n * shape[0],) + shape[1:])
            # all_gather_single is all_gather_into_tensor's newer name
            gather = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
            call = lambda: gather(out, x, group=group)
            call()
            want = torch.cat([torch.full(shape, float(r + 1), dtype=dtype,
                                         device=device) for r in range(n)])
        elif name == "all_reduce":
            out = x.clone()

            def call():
                out.copy_(x)
                dist.all_reduce(out, group=group)
            call()
            want = torch.full(shape, float(sum(range(1, n + 1))),
                              dtype=dtype, device=device)
        elif name == "all_to_all_single":
            out = torch.empty_like(x)
            call = lambda: dist.all_to_all_single(out, x, group=group)
            call()
            half = shape[0] // n
            want = torch.cat([torch.full((half,) + shape[1:], float(r + 1),
                                         dtype=dtype, device=device)
                              for r in range(n)])
        elif name == "all_gather":
            outs = [torch.empty_like(x) for _ in range(n)]
            call = lambda: dist.all_gather(outs, x, group=group)
            call()
            out = torch.cat(outs)
            want = torch.cat([torch.full(shape, float(r + 1), dtype=dtype,
                                         device=device) for r in range(n)])
        elif name == "broadcast":
            out = x.clone()
            src = dist.get_global_rank(group, 0)

            def call():
                out.copy_(x)
                dist.broadcast(out, src=src, group=group)
            call()
            want = torch.full(shape, 1.0, dtype=dtype, device=device)
        else:
            out = want = None
            call = lambda: dist.barrier(group=group)
            call()
        if out is not None:
            rec["on_device"] = out.device.type == device
            rec["equal"] = bool(torch.equal(out, want))
        rec["ms"] = _time(call, device)
        rec["ok"] = out is None or (rec["equal"] and rec["on_device"])
    except Exception as e:  # noqa: BLE001 -- the refusal is the result
        rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:400]}
    return rec


def _rank(rank: int, device: str, store_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=60))
    out = {"rank": rank}
    try:
        mesh = init_device_mesh(device, (1, WORLD),
                                mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
        out["mesh"] = {"ok": True,
                       "backend": dist.get_backend(group)}
    except Exception as e:  # noqa: BLE001
        out["mesh"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        group = None
    calls = {}
    names = ("all_gather_into_tensor", "all_reduce", "all_to_all_single",
             "all_gather", "broadcast", "barrier")
    for name in names:
        for dtype in (torch.float32, torch.bfloat16):
            for size, shape in SIZES:
                if name == "barrier" and (dtype != torch.float32
                                          or size != "decode"):
                    continue
                key = f"{name}/{str(dtype)[6:]}/{size}"
                calls[key] = _probe(rank, device, group, name, dtype, shape)
    out["calls"] = calls
    with open(os.path.join(store_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    store = ROOT / "build" / "gloo_probe"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.start_processes(_rank, args=(args.device, str(store)), nprocs=WORLD,
                       start_method="spawn")
    ranks = [json.loads((store / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    keys = ranks[0]["calls"]
    carried = {k: all(r["calls"][k]["ok"] for r in ranks) for k in keys}
    rec = dict(device=args.device, card=card, torch=torch.__version__,
               world=WORLD, mesh=[r["mesh"] for r in ranks],
               carried=carried, ranks=ranks,
               seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gloo_probe.json").write_text(line)
    print(line)
    if card:
        print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
