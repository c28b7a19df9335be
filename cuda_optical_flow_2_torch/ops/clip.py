"""Clip to constant bounds with JAX's gradient at the bound.

``Tensor.clamp`` passes the whole gradient to an input that sits exactly on
a bound.  ``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` pass half of it,
and so do ``torch.maximum`` and ``torch.minimum`` between two equal
arguments.  Such ties are common in the flow pipelines: a zero flow at
column 0 samples the image border, a zero gradient meets the ``epsilon``
floor.  So the port clips with :func:`clip` wherever the JAX package's
differentiated path uses those functions.  The values are those of
``clamp``.
"""

from __future__ import annotations

import torch

__all__ = ["clip"]


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, either bound
    optional."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x
