"""Production mesh construction (the reference's ``launch/mesh.py``) on a
torch ``DeviceMesh``.

Defined as FUNCTIONS so importing this module never touches a process
group.  Axes:

  pod    -- data parallelism between pods (the slow axis; gradients only)
  data   -- FSDP/ZeRO: params + optimizer state sharded, batch sharded
  model  -- the tensor-parallel axis (heads / ffn / experts / vocab):
            serving splits the attention, dense-MLP and vocabulary
            compute over it (``serve/engine.py``); training shards only
            memory over it (``train/step.py``)

A mesh needs ``torch.distributed`` initialized with one process a device
(the caller gives its address, world size and rank).  A mesh of one
device initializes a one-process group itself, on an in-process store:
no network.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM data sheet figures (roofline denominators, per card)
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
# NVLink 4: 900 GB/s a card both ways, 450e9 bytes/s a direction.  One
# link figure, as the reference has one: it holds within a node of 8
# cards; a 256-card mesh crosses nodes, where the link (InfiniBand,
# ~50e9 bytes/s a card) is slower, so the collective term of such a mesh
# is a lower bound.
ICI_BW = 450e9
# device memory of the H100 80GB HBM3 (SXM) card: torch.cuda.
# get_device_properties(0).total_memory on it, 85017493504 B -- the card
# the dry run's ``fits_card`` verdict holds a rank's peak against
CARD_MEMORY_BYTES = 85_017_493_504


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device_type='cpu' to build "
                           "a mesh on the CPU")
    return "cuda"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group's
    ranks, on the CUDA card(s) unless ``device_type`` says otherwise (tests
    pass "cpu": gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device_type(device_type)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a mesh of {math.prod(shape)} devices needs "
                "torch.distributed initialized (init_process_group with "
                "its address, world size and rank)")
        kw = {}
        if dev == "cuda":
            import torch
            torch.cuda.set_device(0)
            kw["device_id"] = torch.device("cuda", 0)
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


def production_mesh_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes: 16 x 16, or 2 pods of 16 x 16 (the
    dry run's mesh of sizes; no process group)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    sizes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(tuple(sizes.values()), tuple(sizes), device_type)
