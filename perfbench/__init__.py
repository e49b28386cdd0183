"""The benchmark of repro_torch, the PyTorch/CUDA port: one cell a run."""
