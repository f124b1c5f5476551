"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the ctypes build that loads them."""
