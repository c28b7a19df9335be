"""NumPy correctness oracles.

``cpu_reference`` reproduces the reference's sequential C++ implementation
(OptFlowCPU.cpp) bit-exactly, including its integer truncation and its documented
bugs; ``gpu_reference`` reproduces the live CUDA path semantics
(OptFlowGpu.cu hot path).  These are the ground truth for every op and pipeline
test in the framework — the reference itself had no automated tests and used its
CPU twins as the de-facto oracle (see SURVEY.md section 4).
"""

from cuda_optical_flow_2_torch.oracle import cpu_reference, gpu_reference

__all__ = ["cpu_reference", "gpu_reference"]
