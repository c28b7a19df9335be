"""Flow pipelines: pyramidal Lucas-Kanade, Horn-Schunck, Farnebäck, TV-L1 and
DIS, the model-generic :func:`pyramidal_flow`, the streaming loop over all
five, and the quality signals on top of them: forward-backward consistency
(occlusion masks and fill), structure-tensor confidence and good features,
and sparse point tracking."""

from cuda_optical_flow_2_torch.config import LKConfig
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
from cuda_optical_flow_2_torch.models.dis import (
    DIS_REALTIME,
    DISConfig,
    pyramidal_dis,
    pyramidal_dis_jit,
)
from cuda_optical_flow_2_torch.models.farneback import (
    FBConfig,
    pyramidal_farneback,
    pyramidal_farneback_jit,
)
from cuda_optical_flow_2_torch.models.horn_schunck import HSConfig, pyramidal_hs, pyramidal_hs_jit
from cuda_optical_flow_2_torch.models.lucas_kanade import (
    coarse_to_fine,
    compose_flow_pyramid,
    lk_level,
    preprocess,
    pyramidal_lk,
    pyramidal_lk_jit,
    pyramidal_lk_pyramid,
)
from cuda_optical_flow_2_torch.models.streaming import (
    FlowState,
    init_state,
    not_ported,
    process_sequence,
    step,
)
from cuda_optical_flow_2_torch.models.tracking import (
    advect_points,
    sample_flow,
    track_points,
    track_sequence,
)
from cuda_optical_flow_2_torch.models.tvl1 import (
    TVL1_REALTIME,
    TVL1Config,
    pyramidal_tvl1,
    pyramidal_tvl1_jit,
)

__all__ = [
    "pyramidal_flow",
    "consistent_flow",
    "fb_consistency",
    "occlusion_mask",
    "confidence_mask",
    "good_features",
    "min_eigenvalue",
    "lk_level",
    "pyramidal_lk",
    "pyramidal_lk_pyramid",
    "compose_flow_pyramid",
    "coarse_to_fine",
    "preprocess",
    "FlowState",
    "init_state",
    "step",
    "process_sequence",
    "sample_flow",
    "advect_points",
    "track_points",
    "track_sequence",
    "HSConfig",
    "pyramidal_hs",
    "FBConfig",
    "pyramidal_farneback",
    "TVL1_REALTIME",
    "TVL1Config",
    "pyramidal_tvl1",
    "DIS_REALTIME",
    "DISConfig",
    "pyramidal_dis",
]


def pyramidal_flow(prev, nxt, config):
    """Dense flow for one frame pair, dispatched on the config type:
    ``LKConfig`` -> :func:`pyramidal_lk`, ``HSConfig`` -> :func:`pyramidal_hs`,
    ``FBConfig`` -> :func:`pyramidal_farneback`, ``TVL1Config`` ->
    :func:`pyramidal_tvl1`, ``DISConfig`` -> :func:`pyramidal_dis`.  Anything
    else raises ``TypeError``, a config of the JAX package included."""
    if isinstance(config, HSConfig):
        return pyramidal_hs(prev, nxt, config)
    if isinstance(config, FBConfig):
        return pyramidal_farneback(prev, nxt, config)
    if isinstance(config, TVL1Config):
        return pyramidal_tvl1(prev, nxt, config)
    if isinstance(config, DISConfig):
        return pyramidal_dis(prev, nxt, config)
    if isinstance(config, LKConfig):
        return pyramidal_lk(prev, nxt, config)
    raise not_ported(config)


def _jit_entry(config):
    """The captured entry of the config's family (``pyramidal_<family>_jit``),
    dispatched as :func:`pyramidal_flow` dispatches.  Private: the JAX
    package has no public ``pyramidal_flow_jit`` either."""
    if isinstance(config, HSConfig):
        return pyramidal_hs_jit
    if isinstance(config, FBConfig):
        return pyramidal_farneback_jit
    if isinstance(config, TVL1Config):
        return pyramidal_tvl1_jit
    if isinstance(config, DISConfig):
        return pyramidal_dis_jit
    if isinstance(config, LKConfig):
        return pyramidal_lk_jit
    raise not_ported(config)
