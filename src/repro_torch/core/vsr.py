"""Virtual Service Requests (VSRs): the paper's workload abstraction.

A VSR is a small directed graph of VMs; each VM carries a processing demand
F^{r,s} (GFLOPS) and each virtual link a bitrate H^{r,s,d} (Mbps).  VM 0 is the
*input* VM, pinned to the source IoT node (paper Eq. 4).

``random_vsrs`` is the paper's §3 workload: F ~ U(3, 10) GFLOPS, input VM
~ U(0.1, 1) GFLOPS, chain virtual topology (a DNN is a layer chain), bitrates
~ U(5, 50) Mbps.  Numpy only, so the arrays are byte-equal to the JAX
package's for the same seed.  Building a VSR from a model's per-layer costs
comes with the model stack.
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
