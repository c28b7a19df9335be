"""Plain PyTorch ops: the reference path the kernels are held against."""
