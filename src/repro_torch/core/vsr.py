"""Virtual Service Requests (VSRs): the paper's workload abstraction.

A VSR is a small directed graph of VMs; each VM carries a processing demand
F^{r,s} (GFLOPS) and each virtual link a bitrate H^{r,s,d} (Mbps).  VM 0 is the
*input* VM, pinned to the source IoT node (paper Eq. 4).

``random_vsrs`` is the paper's §3 workload: F ~ U(3, 10) GFLOPS, input VM
~ U(0.1, 1) GFLOPS, chain virtual topology (a DNN is a layer chain), bitrates
~ U(5, 50) Mbps.  Numpy only, so the arrays are byte-equal to the JAX
package's for the same seed.  ``from_architecture`` builds one VSR from a
model's per-layer costs (``models.costs.layer_costs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class VSRBatch:
    """R VSRs, each with V VMs (rectangular; pad with zero-demand VMs)."""

    F: np.ndarray           # [R, V] GFLOPS demand per VM
    H: np.ndarray           # [R, V, V] Mbps on virtual link (s -> d)
    src: np.ndarray         # [R] source IoT processing-node index
    input_vm: np.ndarray    # [R] index of the input VM (always 0 here)

    @property
    def R(self) -> int:
        return self.F.shape[0]

    @property
    def V(self) -> int:
        return self.F.shape[1]

    def links(self):
        """Flattened virtual links: (link_src, link_dst, link_h).

        Indices are into the flattened [R*V] VM space.
        """
        r, s, d = np.nonzero(self.H)
        link_src = (r * self.V + s).astype(np.int32)
        link_dst = (r * self.V + d).astype(np.int32)
        link_h = self.H[r, s, d].astype(np.float32)
        return link_src, link_dst, link_h

    def widen(self, V: int) -> "VSRBatch":
        """The batch padded to ``V`` VMs with zero-demand, link-free VMs."""
        d = V - self.V
        if d <= 0:
            return self
        return VSRBatch(F=np.pad(self.F, ((0, 0), (0, d))),
                        H=np.pad(self.H, ((0, 0), (0, d), (0, d))),
                        src=self.src, input_vm=self.input_vm)

    def concat(self, other: "VSRBatch") -> "VSRBatch":
        """Concatenate batches, padding to the wider VM count with
        zero-demand VMs (zero-F, zero-H VMs never affect the objective)."""
        return concat_all([self, other])


def concat_all(batches: Sequence[VSRBatch]) -> VSRBatch:
    """One batch of all ``batches`` in order, padded to the widest VM count:
    the same arrays as chaining ``concat`` pairwise, in one copy."""
    V = max(b.V for b in batches)
    wide = [b.widen(V) for b in batches]
    return VSRBatch(F=np.concatenate([b.F for b in wide]),
                    H=np.concatenate([b.H for b in wide]),
                    src=np.concatenate([b.src for b in wide]),
                    input_vm=np.concatenate([b.input_vm for b in wide]))


def random_vsrs(n_vsrs: int,
                rng: np.random.Generator | int = 0,
                n_vms: int = 3,
                source_nodes: Sequence[int] = (0,),
                vm_gflops=(3.0, 10.0),
                input_gflops=(0.1, 1.0),
                link_mbps=(5.0, 50.0),
                topology: str = "chain") -> VSRBatch:
    """Paper §3 workload generator.

    The paper uses a *single* IoT device as the source of all VSRs; pass more
    ``source_nodes`` to distribute sources (sensitivity studies).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    R, V = n_vsrs, n_vms
    F = rng.uniform(*vm_gflops, size=(R, V)).astype(np.float32)
    F[:, 0] = rng.uniform(*input_gflops, size=R)
    H = np.zeros((R, V, V), dtype=np.float32)
    if topology == "chain":
        for v in range(V - 1):
            H[:, v, v + 1] = rng.uniform(*link_mbps, size=R)
    elif topology == "star":
        for v in range(1, V):
            H[:, 0, v] = rng.uniform(*link_mbps, size=R)
    elif topology == "dag":
        for s in range(V):
            for d in range(s + 1, V):
                mask = rng.random(R) < 0.5
                H[mask, s, d] = rng.uniform(*link_mbps, size=mask.sum())
        # guarantee connectivity through the chain
        for v in range(V - 1):
            zero = H[:, v, v + 1] == 0
            H[zero, v, v + 1] = rng.uniform(*link_mbps, size=zero.sum())
    else:
        raise ValueError(f"unknown virtual topology {topology!r}")
    src = np.asarray(rng.choice(source_nodes, size=R), dtype=np.int32)
    input_vm = np.zeros(R, dtype=np.int32)
    return VSRBatch(F=F, H=H, src=src, input_vm=input_vm)


def from_layer_costs(layer_gflop_per_token: Sequence[float],
                     layer_act_bytes: Sequence[float],
                     tokens_per_s: float,
                     n_stages: int,
                     source_node: int = 0,
                     input_gflop_per_token: float = 1e-4,
                     input_act_bytes: float | None = None) -> VSRBatch:
    """Convert a real DNN (per-layer costs) into a single VSR.

    Stage VM demand  = sum of member-layer GFLOP/token * tokens/s.
    Inter-stage link = boundary activation bytes * tokens/s * 8 bits -> Mbps,
    where the boundary crossing stage s-1 -> s carries the OUTPUT of the last
    layer of stage s-1.  The input-VM -> stage-1 link carries the embedding
    output, ``input_act_bytes`` (when None, approximated by
    ``layer_act_bytes[0]`` -- exact for transformers, whose embedding output
    has a block's hidden size).  VM 0 is the input/embedding VM pinned at
    the source (a camera / sensor gateway in the paper's story).

    ``n_stages`` > L is clamped to L (one layer per stage is the finest
    cut -- avoids silently-zero-demand stages); ``n_stages`` < 1 raises.
    """
    L = len(layer_gflop_per_token)
    if L < 1 or len(layer_act_bytes) != L:
        raise ValueError(f"need matching non-empty layer costs, got L={L} "
                         f"and {len(layer_act_bytes)} activation sizes")
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    n_stages = min(n_stages, L)
    if input_act_bytes is None:
        input_act_bytes = float(layer_act_bytes[0])
    # spacing L/n_stages >= 1, so rounded bounds are strictly increasing:
    # every stage owns at least one layer
    bounds = np.linspace(0, L, n_stages + 1).round().astype(int)
    V = n_stages + 1  # + input VM
    F = np.zeros((1, V), dtype=np.float32)
    H = np.zeros((1, V, V), dtype=np.float32)
    F[0, 0] = input_gflop_per_token * tokens_per_s
    for s in range(n_stages):
        lo, hi = bounds[s], bounds[s + 1]
        F[0, s + 1] = float(np.sum(layer_gflop_per_token[lo:hi])) * tokens_per_s
        boundary_bytes = layer_act_bytes[lo - 1] if s > 0 else input_act_bytes
        H[0, s, s + 1] = boundary_bytes * tokens_per_s * 8.0 / 1e6  # Mbps
    return VSRBatch(F=F, H=H,
                    src=np.array([source_node], dtype=np.int32),
                    input_vm=np.zeros(1, dtype=np.int32))


def from_architecture(arch_cfg, *, tokens_per_s: float = 50.0,
                      n_stages: int = 4, context: int = 2048,
                      source_node: int = 0) -> VSRBatch:
    """Turn one of the assigned architectures into a VSR (paper §2.2 made
    concrete: "each VM represents a layer of a DNN model").

    Per-layer inference GFLOP/token and boundary activation bytes come from
    models.costs.layer_costs (derived from the real parameter tree); layers
    are grouped into ``n_stages`` pipeline-stage VMs, the input/embedding VM
    is pinned at the source (the camera / sensor gateway -- the VLM patch
    stub is the cleanest instance).
    """
    from ..models.costs import layer_costs
    gflops, act_bytes = layer_costs(arch_cfg, context=context)
    emb_gflop = 2.0 * arch_cfg.d_model / 1e9  # embedding lookup-ish
    emb_bytes = 2.0 * arch_cfg.d_model        # bf16 hidden state per token
    return from_layer_costs(gflops, act_bytes, tokens_per_s, n_stages,
                            source_node=source_node,
                            input_gflop_per_token=emb_gflop,
                            input_act_bytes=emb_bytes)
