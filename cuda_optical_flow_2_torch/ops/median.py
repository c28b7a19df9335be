"""Spatial median filter: the TV-L1 flow-cleaning step.

Counterpart of ``cuda_optical_flow_2_tpu.ops.median``.  The k x k
neighbourhood is the k^2 shifted slices of an edge-replicated copy (OpenCV's
BORDER_REPLICATE, what ``medianBlur`` uses), stacked on a new leading axis,
and ``torch.median`` selects over that axis.  For the odd count the median is
one of the inputs, so the result is bit-equal to the JAX package's min/max
selection network.  This is the plain version of the hand-written CUDA
kernel ``kernels.median_select.median_filter_kernel``, which TV-L1's kernel
path launches for sizes 3 and 5 and holds bit-equal to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["median_filter"]


def median_filter(x: torch.Tensor, size: int = 5) -> torch.Tensor:
    """k x k spatial median of (..., H, W) tensors, edge-replicated borders.

    ``size`` must be odd (the median of an odd count is unique).
    """
    if size % 2 != 1 or size < 1:
        raise ValueError(f"median size must be odd >= 1, got {size}")
    if size == 1:
        return x
    r = size // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    # replicate padding wants a (N, C, H, W) view
    xp = F.pad(x.reshape(1, -1, h, w), (r, r, r, r), mode="replicate").reshape(
        lead + (h + 2 * r, w + 2 * r)
    )
    stacked = torch.stack(
        [xp[..., dy : dy + h, dx : dx + w] for dy in range(size) for dx in range(size)]
    )
    return stacked.median(dim=0).values
