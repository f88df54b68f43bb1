"""The PyTorch/CUDA port's benchmark (see ``harness``)."""
