"""PyTorch/CUDA port of the CFN placement system (the JAX package ``repro``
is the reference).

``repro_torch.api`` is the user surface (``PlacementSpec``, ``CFNSession``);
``core`` holds the substrate, workload, power model, solvers and the
online churn engine;
``configs`` and ``models`` the architecture configurations and the
model stack (dense, MoE, recurrent, encoder-decoder, VLM; inference and
the training forward); ``serve`` the KV cache and the prefill / decode
engine; ``data``, ``optim`` and ``train`` training on one device (the
synthetic-token stream, AdamW, the train step); ``launch`` the serving
and training CLIs;
``kernels`` the CUDA kernels for Hopper (``csrc/*.cu``), their launch
wrappers and plain PyTorch versions, and the oracles.  Importing the
package needs neither a GPU nor the CUDA toolkit: the kernels are compiled
at their first launch.
"""
