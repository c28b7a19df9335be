"""Dense optical flow (pyramidal Lucas-Kanade, Horn-Schunck, Farnebäck, TV-L1,
DIS) in PyTorch with CUDA kernels.

The PyTorch port of ``cuda_optical_flow_2_tpu`` (the JAX reference, which
stays beside it).  Same module names, same layouts: images are
``(..., H, W)`` float32, flow is ``(..., H, W, 2)`` with ``[..., 0] = u``.
A function runs on the device of its input tensors: on CUDA tensors the hot
stages launch hand-written Hopper kernels (``kernels/``, built from
``csrc/`` with nvcc at first use); on CPU tensors they take the kernels'
plain PyTorch versions.

    import cuda_optical_flow_2_torch as of

    flow = of.pyramidal_lk(prev_gray, next_gray, of.LKConfig(levels=4))
    flow = of.pyramidal_hs(prev_gray, next_gray, of.HSConfig())
    flow = of.pyramidal_farneback(prev_gray, next_gray, of.FBConfig())
    flow = of.pyramidal_tvl1(prev_gray, next_gray, of.TVL1_REALTIME)
    flow = of.pyramidal_dis(prev_gray, next_gray, of.DISConfig())
    flow = of.pyramidal_flow(prev_gray, next_gray, config)  # any of the five

``pyramidal_lk_jit`` (and ``models.<family>.pyramidal_<family>_jit`` for
the other four) is the JAX package's jitted entry: on CUDA tensors it
replays a CUDA graph captured once per config and input shape
(``capture``), on CPU tensors it is the eager entry.

``process_sequence``, ``init_state`` and ``step`` stream any of the five
families, warm or cold, with scene-cut recovery; on CUDA tensors
``init_state`` and ``step`` replay captured graphs, as the JAX package jits
them.  ``parallel`` shards batches
of pairs, or one pair's rows (any of the five families), over a mesh of
devices.

The quality signals ride on any family:

    flow, occluded = of.consistent_flow(prev_gray, next_gray, config, fill=True)
    trusted = of.confidence_mask(prev_gray, of.LKConfig(window=15))
    points, scores = of.good_features(prev_gray, of.LKConfig(window=15), 500)
    positions, alive = of.track_sequence(frames, points, config)  # (T-1, N, 2)

``utils`` holds numpy copies of the JAX package's scoring and I/O
(``metrics``, ``layered``, ``io``), the visualization (``viz``), the
native frame ingestion (``native``), device timing and traces
(``profiling``) and the per-stage A/B tool (``debug``).
``models.compat`` runs the reference's bug-exact uint8/int32 profiles
(``pyramidal_lk_exact``), held against the numpy ``oracle``.  ``cli`` holds
the command-line tools (``of2-torch-benchmark``, ``of2-torch-eval``,
``of2-torch-diff``, ``of2-torch-demo``), which run on ``--device cuda``
unless told ``--device cpu``.
"""

from cuda_optical_flow_2_torch.config import (
    PAPER_1080P,
    REFERENCE_CPU,
    REFERENCE_GPU,
    BilateralConfig,
    LKConfig,
)
from cuda_optical_flow_2_torch.models import pyramidal_flow
from cuda_optical_flow_2_torch.models.confidence import (
    confidence_mask,
    good_features,
    min_eigenvalue,
)
from cuda_optical_flow_2_torch.models.consistency import (
    consistent_flow,
    fb_consistency,
    occlusion_mask,
)
from cuda_optical_flow_2_torch.models.dis import DIS_REALTIME, DISConfig, pyramidal_dis
from cuda_optical_flow_2_torch.models.farneback import (
    FBConfig,
    fb_coarse_to_fine,
    fb_preprocess,
    pyramidal_farneback,
)
from cuda_optical_flow_2_torch.models.horn_schunck import (
    HSConfig,
    horn_schunck,
    hs_coarse_to_fine,
    hs_preprocess,
    pyramidal_hs,
)
from cuda_optical_flow_2_torch.models.lucas_kanade import (
    coarse_to_fine,
    compose_flow_pyramid,
    lk_level,
    preprocess,
    pyramidal_lk,
    pyramidal_lk_jit,
    pyramidal_lk_pyramid,
    solve_flow,
)
from cuda_optical_flow_2_torch.models.streaming import (
    FlowState,
    RecoveryConfig,
    init_state,
    process_sequence,
    step,
)
from cuda_optical_flow_2_torch.models.tracking import (
    advect_points,
    sample_flow,
    track_points,
    track_sequence,
)
from cuda_optical_flow_2_torch.models.tvl1 import TVL1_REALTIME, TVL1Config, pyramidal_tvl1
from cuda_optical_flow_2_torch import parallel

__version__ = "0.1.0"

__all__ = [
    "BilateralConfig",
    "DISConfig",
    "DIS_REALTIME",
    "FBConfig",
    "HSConfig",
    "LKConfig",
    "PAPER_1080P",
    "REFERENCE_CPU",
    "REFERENCE_GPU",
    "TVL1Config",
    "TVL1_REALTIME",
    "FlowState",
    "RecoveryConfig",
    "advect_points",
    "coarse_to_fine",
    "confidence_mask",
    "consistent_flow",
    "compose_flow_pyramid",
    "fb_coarse_to_fine",
    "fb_consistency",
    "fb_preprocess",
    "good_features",
    "horn_schunck",
    "hs_coarse_to_fine",
    "hs_preprocess",
    "init_state",
    "lk_level",
    "min_eigenvalue",
    "occlusion_mask",
    "parallel",
    "preprocess",
    "process_sequence",
    "pyramidal_dis",
    "pyramidal_farneback",
    "pyramidal_flow",
    "pyramidal_hs",
    "pyramidal_lk",
    "pyramidal_lk_jit",
    "pyramidal_lk_pyramid",
    "pyramidal_tvl1",
    "sample_flow",
    "solve_flow",
    "step",
    "track_points",
    "track_sequence",
    "__version__",
]
