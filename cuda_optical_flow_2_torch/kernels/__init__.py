"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing needs no GPU and no nvcc: the library is built at the first CUDA
launch (``kernels/_build.py``).
"""
