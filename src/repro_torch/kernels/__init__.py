"""CUDA kernels of the port (placement objective, fused annealing, flash
attention), their wrappers, plain PyTorch versions, and the oracles."""
