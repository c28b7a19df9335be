"""Spatial median filter: the TV-L1 flow-cleaning step.

Counterpart of ``cuda_optical_flow_2_tpu.ops.median``.  The k x k
neighbourhood is the k^2 shifted slices of an edge-replicated copy (OpenCV's
BORDER_REPLICATE, what ``medianBlur`` uses), and the median is the JAX
package's min/max elimination network over them, written with
``torch.minimum`` / ``torch.maximum``.  For the odd count the median is one
of the inputs, so any selection gives the same value, a NaN window gives
NaN; the network also gives JAX's gradient, which splits a tie in half at
each exchange (``Tensor.median`` sends all of it to one element, and TV-L1's
first warp from zero flow is a 25-way tie).  This is the plain version of
the hand-written CUDA kernel ``kernels.median_select.median_filter_kernel``,
which TV-L1's kernel path launches for sizes 3 and 5 and holds bit-equal to
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    if torch.is_grad_enabled() and stacked.requires_grad:
        # the network's graph keeps every exchange's output, 600 planes for
        # a 5x5 median (TV-L1's gradient at 1080x1920 would not fit 80 GB):
        # keep the k^2 slices and run the network again for the backward
        return checkpoint(_median_network, stacked, use_reentrant=False)
    return _median_network(stacked)


def _median_network(stacked: torch.Tensor) -> torch.Tensor:
    """Median over the leading axis (an odd count) by pairwise min/max
    elimination (the JAX package's ``_median_network``): each pass bubbles
    the minimum to the first slot and the maximum to the last, and strips
    both, until one is left."""
    vals = list(stacked.unbind(0))
    while len(vals) > 1:
        for i in range(1, len(vals)):
            vals[0], vals[i] = torch.minimum(vals[0], vals[i]), torch.maximum(vals[0], vals[i])
        for i in range(1, len(vals) - 1):
            vals[i], vals[-1] = torch.minimum(vals[i], vals[-1]), torch.maximum(vals[i], vals[-1])
        vals = vals[1:-1]
    return vals[0]
