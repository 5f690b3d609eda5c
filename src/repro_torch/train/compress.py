"""Error-feedback int8 gradient compression for the cross-pod reduction
(the reference's ``train/compress.py``).

The pod axis is the slow axis: the per-step cross-pod gradient reduction
is the dominant inter-pod collective.  It is compressed by
  1. adding the carried error-feedback residual to the local gradient,
  2. quantizing to int8 with a float32 scale,
  3. all-gathering the int8 payload and the scales over the mesh's 'pod'
     process group (1 byte an element on the wire instead of 2-4) and
     summing the dequantized payloads in pod-rank order,
  4. keeping the quantization error as the next step's residual.

The reference quantizes a pod's whole (data- and model-sharded) leaf with
one scale; the port quantizes each rank's block with its own scale, so the
residual is exactly x - dequantize(quantize(x)) of that rank's block.  At
one pod both are the identity.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 payload and float32 scale: scale = max|x| / 127 + 1e-12,
    q = clip(round_half_even(x / scale), -127, 127)."""
    x = x.float()
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_pod_sum(g: torch.Tensor, err: torch.Tensor, n_pods: int,
                       group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean over pods of ``g``, new residual) across ``group`` (the mesh's
    'pod' process group; its ranks hold the same block of the leaf in
    different pods): the int8 payloads and scales all-gathered, the
    dequantized payloads summed in rank order, divided by ``n_pods``."""
    import torch.distributed as dist
    x = g.float() + err
    q, scale = quantize(x)
    new_err = x - dequantize(q, scale)
    qs = [torch.empty_like(q) for _ in range(n_pods)]
    ss = [torch.empty_like(scale) for _ in range(n_pods)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = dequantize(qs[0], ss[0])
    for qi, si in zip(qs[1:], ss[1:]):
        total += dequantize(qi, si)
    return (total / n_pods).to(g.dtype), new_err


def make_compressed_sync(mesh) -> Callable:
    """``sync(grads, err) -> (grads, err)`` over lists of a rank's blocks
    with the int8 pod all-gather; the identity at one pod.  The pod axis
    never splits a parameter: grads are pod-local means going in and
    pod-averaged coming out."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_pods = sizes.get("pod", 1)
    if n_pods == 1:
        return lambda grads, err: (list(grads), list(err))
    group = mesh.get_group("pod")

    def sync(grads: Sequence[torch.Tensor], err: Sequence[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        out = [compressed_pod_sum(g, e, n_pods, group)
               for g, e in zip(grads, err)]
        return [o[0] for o in out], [o[1] for o in out]

    return sync
