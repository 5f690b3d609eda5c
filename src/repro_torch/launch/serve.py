"""Serving driver: batched prefill + decode with energy-aware placement
(the reference's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Serves the architecture's smoke configuration with random weights from
``--seed`` on ``--device`` (default: the CUDA card), prints the first
request's generated ids and the token rate, then places the full
architecture at that rate on the datacenter CFN through the energy-aware
scheduler, one JSON line per placement.  Every architecture of the
registry serves.  The stub front ends' inputs are drawn after the tokens
from the same generator, as the reference draws them: whisper-base's
frames [B, S, d_model] (the encoder's length is the prompt's),
internvl2-2b's patches [B, P, d_model], both 0.1 x normal.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import configs
from ..core import topology as cfn_topology
from ..core.power import resolve_device
from ..models import model as M
from ..serve import cache as C
from ..serve import engine
from ..serve.scheduler import EnergyAwareScheduler, Service


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       dtype=torch.int32, device=dev)}
    stub = lambda n: torch.as_tensor(
        0.1 * rng.standard_normal((B, n, cfg.d_model)), dtype=torch.float32,
        device=dev)
    if cfg.is_encoder_decoder:
        batch["frames"] = stub(S)
    if cfg.vision_prefix_tokens:
        batch["patches"] = stub(cfg.vision_prefix_tokens)
    max_len = S + args.gen + (cfg.vision_prefix_tokens or 0) + 8
    cache = C.zeros(C.cache_spec(
        cfg, B, max_len, enc_len=S if cfg.is_encoder_decoder else 0,
        dtype=getattr(torch, cfg.dtype)), device=dev)
    t0 = time.perf_counter()
    seq, _ = engine.greedy_generate(model, cfg, batch, cache, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print("generated token ids (first row):", seq[0].tolist())
    print(f"{B} requests x {args.gen} tokens in {dt:.2f}s "
          f"({B * args.gen / dt:.1f} tok/s on {where})")

    # energy-aware placement of this service on the CFN (paper technique)
    sched = EnergyAwareScheduler(cfn_topology.datacenter_topology(),
                                 device=dev)
    sched.add_service(Service(name=args.arch, arch=configs.get(args.arch),
                              tokens_per_s=B * args.gen / dt))
    for p in sched.solve():
        print(json.dumps(dict(service=p.service, stages=p.layers,
                              nodes=p.stage_nodes,
                              power_w=round(p.power_w, 2))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
