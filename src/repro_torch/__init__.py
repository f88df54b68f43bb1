"""PyTorch/CUDA port of the Seismic retrieval system (``repro``).

Same subpackage layout as the JAX package, so every module here has one
counterpart there. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
The hot stages run hand-written CUDA kernels (``repro_torch.kernels``);
a kernel wrapper takes its plain PyTorch version only for CPU tensors.
"""
