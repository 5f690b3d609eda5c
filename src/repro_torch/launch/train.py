"""Training entry point on one device (the reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --steps 12 --batch 4 --seq 32 --lr 5e-3 [--device cpu] [--report-energy]
      [--ckpt-dir DIR [--ckpt-every 25]]

Trains the architecture's smoke configuration (``--full``: the published
one) from random float32 masters drawn from ``--seed`` on ``--device``
(default: the CUDA card) over the synthetic-token stream
(``data.pipeline``, step-indexed, byte-equal to the reference's), with a
bf16 compute copy and AdamW (``train.step``).  Prints a line every 10 steps
and the last, then one JSON line: ``first_loss``, ``last_loss`` and
``improved``.  With ``--ckpt-dir`` the run goes through
``fault.runner.ResilientTrainer``: it resumes from the directory's latest
checkpoint (the state and the data stream's step), checkpoints every
``--ckpt-every`` steps and at the end, and prints only the JSON line (over
the steps this run took).  ``--report-energy`` then places the published
architecture (as a VSR, ``core.vsr.from_architecture``) on the datacenter
CFN and prints the optimized placement's watts beside the CDC baseline's,
one more JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import configs
from ..core import embed as cfn_embed
from ..core import topology as cfn_topology
from ..core import vsr as cfn_vsr
from ..core.power import resolve_device
from ..data.pipeline import DataConfig, make_batch
from ..fault.runner import ResilientTrainer
from ..optim import adamw
from ..train.step import init_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--report-energy", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=args.lr),
                           accum=args.accum)
    dcfg = DataConfig(seed=args.seed, batch=args.batch, seq_len=args.seq)
    init_fn = lambda: init_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(args.seed), device=dev)
    if args.ckpt_dir:
        trainer = ResilientTrainer(cfg, dcfg, step, init_fn, args.ckpt_dir,
                                   args.ckpt_every, device=dev)
        losses = trainer.run(args.steps).losses
    else:
        state = init_fn()
        losses = []
        t0 = time.time()
        for i in range(args.steps):
            state, metrics = step(state, make_batch(cfg, dcfg, i))
            losses.append(float(metrics["loss"]))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
    print(json.dumps(dict(arch=cfg.name, steps=args.steps,
                          first_loss=losses[0], last_loss=losses[-1],
                          improved=bool(losses[-1] < losses[0]))))

    if args.report_energy:
        topo = cfn_topology.datacenter_topology()
        vs = cfn_vsr.from_architecture(configs.get(args.arch),
                                       tokens_per_s=1000.0)
        saving = cfn_embed.savings_vs_baseline(topo, vs, baseline="cdc",
                                               device=dev)
        print(json.dumps(dict(
            placement_baseline_w=round(saving["baseline_w"], 1),
            placement_optimized_w=round(saving["optimized_w"], 1),
            saving_frac=round(saving["saving_frac"], 4))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
