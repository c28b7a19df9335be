"""Row bands of a taller image: the global-row masks of spatial TP.

A band holds global rows ``[row0, row0 + n)`` of an ``h_global``-row image
(``parallel/spatial.py`` cuts one per shard, halo rows included, and
``row0`` may be negative).  The band forms of the kernels and of their plain
versions test positions against the global image with these masks.
Counterpart of ``cuda_optical_flow_2_tpu.parallel.spatial._zero_outside_global``.
"""

from __future__ import annotations

import torch

__all__ = ["rows_in_image", "zero_outside_global"]


def rows_in_image(n: int, row0: int, h_global: int, device) -> torch.Tensor:
    """(n, 1) bool: which of the band's rows lie in the global image."""
    rows = torch.arange(n, device=device)[:, None] + row0
    return (rows >= 0) & (rows < h_global)


def zero_outside_global(
    x: torch.Tensor, row0: int, h_global: int, row_axis: int = -2
) -> torch.Tensor:
    """Zero the rows of a band (rows along ``row_axis``) that fall outside
    the global image."""
    keep = rows_in_image(x.shape[row_axis], row0, h_global, x.device)
    keep = keep.reshape((-1,) + (1,) * (-row_axis - 1))
    return torch.where(keep, x, 0.0)
