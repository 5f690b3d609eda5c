"""CUDA kernels of the placement objective, their wrappers, plain PyTorch
versions, and the float64 oracle."""
