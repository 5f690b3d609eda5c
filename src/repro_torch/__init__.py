"""PyTorch/CUDA port of the CFN placement system (the JAX package ``repro``
is the reference).

``repro_torch.api`` is the user surface (``PlacementSpec``, ``CFNSession``);
``core`` holds the substrate, workload, power model, solvers and the
online churn engine;
``configs`` and ``models`` the architecture configurations and the
transformer stack (dense and MoE); ``serve`` the KV cache and the
prefill / decode engine; ``launch`` the serving CLI;
``kernels`` the CUDA kernels for Hopper (``csrc/*.cu``), their launch
wrappers and plain PyTorch versions, and the oracles.  Importing the
package needs neither a GPU nor the CUDA toolkit: the kernels are compiled
at their first launch.
"""
