"""The JAX package's ten ``examples/``, ported to PyTorch.

Each is a module with ``main(device="cuda", out_dir="/tmp")`` that returns
its key numbers, and runs from the root of a checkout as

    python -m cuda_optical_flow_2_torch.examples.<name> [--device cpu]

``basic``, ``streaming_video``, ``live_stream``, ``scene_cut_recovery``,
``flow_quality``, ``frame_interpolation``, ``sharded_batch``, ``spatial_tp``
(the last two take ``--shards n``), ``gradient_alignment`` and
``learned_refinement``.  An example runs on the card unless told
``--device cpu``, and without a card it exits with a message: it never
falls back to the CPU.  Each keeps its JAX twin's configuration, sizes,
seeds and checks; on the card the hot stages launch the CUDA kernels where
the JAX twin's config runs its Pallas kernels.
"""

from __future__ import annotations

import argparse

from cuda_optical_flow_2_torch.cli import add_device_argument

__all__ = ["EXAMPLES", "run"]

EXAMPLES = (
    "basic",
    "streaming_video",
    "live_stream",
    "scene_cut_recovery",
    "flow_quality",
    "frame_interpolation",
    "sharded_batch",
    "spatial_tp",
    "gradient_alignment",
    "learned_refinement",
)


def run(main, doc: str | None, shards: str | None = None) -> None:
    """Parse ``--device``, ``--out-dir`` (and ``--shards``, with its help
    text) and call ``main`` with them."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--out-dir", default="/tmp", help="where artifacts go (default /tmp)")
    if shards:
        ap.add_argument("--shards", type=int, default=None, help=shards)
    args = ap.parse_args()
    kw = {"shards": args.shards} if shards else {}
    main(device=args.device, out_dir=args.out_dir, **kw)
