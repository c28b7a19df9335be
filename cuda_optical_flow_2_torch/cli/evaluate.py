"""Dataset evaluation CLI: score any model family against ground-truth flow.

Counterpart of ``cuda_optical_flow_2_tpu.cli.evaluate``: the same layouts,
flags, records and summary, with ``--device`` (default ``cuda``).  Point it
at a directory of frame pairs with Middlebury ``.flo`` ground truth and it
reports per-pair and aggregate EPE / angular error / KITTI Fl outlier rate
for the chosen model family, through the production pipeline on the device.
Each pair's device work (the flow, and with ``--fill-occlusions`` the
consistency check and the fill) is one captured entry, a replay of a CUDA
graph per frame shape on the card, as the JAX tool jits its step.

Four directory layouts are recognized:

* **KITTI**: a root containing an ``image_2`` (2015) or ``colored_0`` (2012)
  directory of ``XXXXXX_10.png`` / ``XXXXXX_11.png`` frame pairs, with
  ground truth as 16-bit flow PNGs of the same stem under ``flow_occ`` (or
  ``flow_noc`` if only that exists).
* **Sintel**: a root (the ``training`` directory) containing a render-pass
  directory (``--sintel-pass final`` by default, falling back to ``clean``)
  of per-sequence frame directories, plus a sibling ``flow`` tree with
  ``.flo`` truth named after the FIRST frame of each consecutive pair.
* **Pair directories** (Middlebury style): every immediate subdirectory that
  contains at least two images is one evaluation pair — the first two images
  in sorted order (``frame10.png``, ``frame11.png``) plus the single ``.flo``
  file (or a ``flow.png`` / ``*_flow.png`` / ``gt_flow.png`` KITTI-encoded
  truth), if present, as ground truth.
* **Flat sequence**: images directly in the directory, sorted; consecutive
  frames form pairs, and a ``.flo`` (or ``_flow.png``) named after the FIRST
  frame of a pair (``frame_0003.png`` -> ``frame_0003.flo``) is its truth.

Pairs without ground truth still run (useful as a smoke pass / for ``--out``
artifacts); they are scored only by flow statistics.

    of2-torch-eval --dataset DIR --model lk --levels 4 --window 19
    of2-torch-eval --dataset DIR --model dis --out /tmp/eval   # + flow-color PNGs
    of2-torch-eval --dataset DIR --device cpu              # plain PyTorch on the CPU

**Streaming mode** (``--streaming [--warm-start] [--compare-cold]``):
chains of consecutive pairs (flat-sequence / Sintel layouts, where
pair[i].second == pair[i+1].first) run through the carried-state
``models.streaming.step`` instead of stateless per-pair flow, scoring each
transition against its truth — the dataset-harness accuracy view of the
recommended serving configuration (warm start + shallow pyramid).  Each
record carries ``seq``/``t``; the summary adds chain count and
first/last-third EPE (drift/lock-loss indicator), and ``--compare-cold``
reports the stateless EPE next to every record.

    of2-torch-eval --dataset DIR --streaming --warm-start --levels 1 --window 15

``--recover-levels N`` (with ``--warm-start``) arms the on-device
scene-cut check: a warm seed that fails the coarse-level photometric
acquisition check (``--recover-ratio``, default 0.7) is dropped and the
pair re-acquired over an N-level pyramid — the serving configuration then
survives content cuts (models.streaming.RecoveryConfig).

    of2-torch-eval --dataset DIR --streaming --warm-start --levels 1 \\
             --recover-levels 3
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np

__all__ = ["main", "discover_pairs", "evaluate_pair"]

_IMAGE_EXTS = (".png", ".ppm", ".pgm", ".npy")


def _json_line(rec: dict) -> str:
    """json.dumps with non-finite floats mapped to null.

    The Sintel matched/unmatched EPE splits are NaN when a side is empty
    (metrics.evaluate_flow), and an inf pixel in a frame can make any
    metric infinite; bare json.dumps would emit the non-standard ``NaN`` /
    ``Infinity`` tokens, which strict consumers (jq, JSON.parse) reject.
    """
    clean = {
        k: (None if isinstance(v, float) and not np.isfinite(v) else v)
        for k, v in rec.items()
    }
    return json.dumps(clean, allow_nan=False)


def _discover_kitti(root: str) -> list[dict]:
    """Recognize the KITTI flow directory layout, if present.

    ``root/image_2`` (2015) or ``root/colored_0`` (2012) holds
    ``XXXXXX_10.png`` / ``XXXXXX_11.png`` frame pairs; 16-bit flow-PNG ground
    truth of the first frame's stem lives under ``root/flow_occ`` (all
    pixels) or ``root/flow_noc`` (non-occluded only) — ``flow_occ`` wins when
    both exist.  Returns [] when the layout is absent.
    """
    img_dir = None
    for cand in ("image_2", "colored_0"):
        if os.path.isdir(os.path.join(root, cand)):
            img_dir = os.path.join(root, cand)
            break
    if img_dir is None:
        return []
    flow_dir = None
    for cand in ("flow_occ", "flow_noc"):
        if os.path.isdir(os.path.join(root, cand)):
            flow_dir = os.path.join(root, cand)
            break

    pairs: list[dict] = []
    for f in sorted(os.listdir(img_dir)):
        if not f.endswith("_10.png"):
            continue
        second = os.path.join(img_dir, f[: -len("_10.png")] + "_11.png")
        if not os.path.exists(second):
            continue
        truth = os.path.join(flow_dir, f) if flow_dir else None
        pairs.append(
            {
                "name": f[: -len("_10.png")],
                "first": os.path.join(img_dir, f),
                "second": second,
                "truth": truth if truth and os.path.exists(truth) else None,
            }
        )
    return pairs


def _discover_sintel(root: str, sintel_pass: str = "final") -> list[dict]:
    """Recognize the MPI-Sintel training layout, if present.

    ``root/<pass>/<sequence>/frame_XXXX.png`` frames (pass = ``final`` or
    ``clean``; the requested one preferred, the other as fallback) with
    ``root/flow/<sequence>/frame_XXXX.flo`` truth named after the first
    frame of each consecutive pair.  Every consecutive pair of every
    sequence is one evaluation pair.  Returns [] when the layout is absent.
    """
    flow_root = os.path.join(root, "flow")
    order = (sintel_pass, "clean" if sintel_pass == "final" else "final")
    pass_dir = None
    for cand in order:
        if os.path.isdir(os.path.join(root, cand)):
            pass_dir = os.path.join(root, cand)
            break
    if pass_dir is None:
        return []
    has_flow = os.path.isdir(flow_root)

    pairs: list[dict] = []
    for seq in sorted(os.listdir(pass_dir)):
        sdir = os.path.join(pass_dir, seq)
        if not os.path.isdir(sdir):
            continue
        imgs = sorted(
            os.path.join(sdir, f)
            for f in os.listdir(sdir)
            if f.lower().endswith(_IMAGE_EXTS)
        )
        for a, b in zip(imgs, imgs[1:]):
            stem = os.path.splitext(os.path.basename(a))[0]
            flo = os.path.join(flow_root, seq, stem + ".flo")
            # Sintel ships per-pair occlusion masks (occ/<seq>/<stem>.png,
            # white = occluded) used for the EPE matched/unmatched split.
            occ = os.path.join(root, "occ", seq, stem + ".png")
            pairs.append(
                {
                    # '/' would split --out artifact names into directories
                    "name": f"{seq}_{stem}",
                    "first": a,
                    "second": b,
                    "truth": flo if has_flow and os.path.exists(flo) else None,
                    "occ": occ if os.path.exists(occ) else None,
                }
            )
    return pairs


def discover_pairs(root: str, sintel_pass: str = "final") -> list[dict]:
    """Find (name, frame0, frame1, truth-or-None) evaluation pairs under root.

    See module docstring for the recognized layouts.  Returns a sorted
    list of dicts with keys ``name``, ``first``, ``second``, ``truth``.
    Layout sniffing is greedy (KITTI, then Sintel, then generic); this
    programmatic entry point is silent (no stderr side effect in a library
    function).  The ``of2-torch-eval`` CLI announces the detected layout via
    ``_discover``.
    """
    _, pairs = _discover_impl(root, sintel_pass)
    return pairs


def _discover(root: str, sintel_pass: str) -> tuple[str, list[dict]]:
    """Sniff the dataset layout and collect pairs, reporting on stderr.

    Layout sniffing is greedy (KITTI, then Sintel, then generic), so the
    detection is always announced — a mis-detection silently drops pairs
    otherwise.
    """
    import sys

    layout, pairs = _discover_impl(root, sintel_pass)
    print(
        f"of2-torch-eval: detected {layout} layout ({len(pairs)} pairs)",
        file=sys.stderr,
    )
    return layout, pairs


def _discover_impl(root: str, sintel_pass: str) -> tuple[str, list[dict]]:
    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset directory not found: {root}")

    def is_flow_png(name: str) -> bool:
        # Exact-suffix/name match only ("flower_10.png" is a frame, not truth).
        stem = os.path.basename(os.path.splitext(name)[0]).lower()
        return name.lower().endswith(".png") and (
            stem.endswith("_flow") or stem in ("flow", "gt_flow")
        )

    def images_in(d: str) -> list[str]:
        return sorted(
            os.path.join(d, f)
            for f in os.listdir(d)
            if f.lower().endswith(_IMAGE_EXTS) and not is_flow_png(f)
        )

    kitti = _discover_kitti(root)
    if kitti:
        return "KITTI", kitti
    sintel = _discover_sintel(root, sintel_pass)
    if sintel:
        return "Sintel", sintel

    pairs: list[dict] = []
    subdirs = sorted(
        os.path.join(root, d)
        for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )
    for sub in subdirs:
        imgs = images_in(sub)
        if len(imgs) < 2:
            continue
        truths = sorted(
            os.path.join(sub, f)
            for f in os.listdir(sub)
            if f.lower().endswith(".flo") or is_flow_png(f)
        )
        pairs.append(
            {
                "name": os.path.basename(sub),
                "first": imgs[0],
                "second": imgs[1],
                "truth": truths[0] if truths else None,
            }
        )
    if pairs:
        return "pair-directories", pairs

    imgs = images_in(root)
    for a, b in zip(imgs, imgs[1:]):
        stem = os.path.splitext(a)[0]
        truth = None
        for cand in (stem + ".flo", stem + "_flow.png"):
            if os.path.exists(cand):
                truth = cand
                break
        pairs.append(
            {
                "name": os.path.basename(stem),
                "first": a,
                "second": b,
                "truth": truth,
            }
        )
    if not pairs:
        raise FileNotFoundError(
            f"no evaluation pairs found under {root} (looked for image "
            f"subdirectories and for flat {'/'.join(_IMAGE_EXTS)} sequences)"
        )
    return "flat-sequence", pairs


def _load_gray(path: str) -> np.ndarray:
    """Load an image file as a float32 grayscale (H, W) plane, 0-255 scale.

    16-bit frames rescale by 1/257 (65535 -> 255) so scale-dependent knobs
    (e.g. the bilateral prefilter's sigma_range) see the intensity range
    every config documents; 16-bit decoding exists for flow-PNG truth.
    """
    import torch

    from cuda_optical_flow_2_torch.ops.color import grayscale
    from cuda_optical_flow_2_torch.utils import io as uio

    img = uio.read_image(path)
    scale = 1.0 / 257.0 if img.dtype == np.uint16 else 1.0
    if img.ndim == 3:
        img = grayscale(torch.as_tensor(img.astype(np.float32))).numpy()
    return np.asarray(img, np.float32) * np.float32(scale)


def _bucket_shape(shape: tuple[int, int], bucket: int) -> tuple[int, int]:
    """Round (H, W) up to multiples of ``bucket`` (identity when 0)."""
    if not bucket:
        return shape
    h, w = shape
    return (-(-h // bucket) * bucket, -(-w // bucket) * bucket)


def _load_pair(pair: dict) -> tuple[np.ndarray, np.ndarray]:
    """Decode one pair's frames (the host-side half of evaluate_pair —
    prefetched on a worker thread by main() so decode overlaps compute)."""
    return _load_gray(pair["first"]), _load_gray(pair["second"])


def evaluate_pair(
    pair: dict,
    flow_fn,
    margin: int,
    out_dir: str | None = None,
    bucket: int = 0,
    frames: tuple[np.ndarray, np.ndarray] | None = None,
) -> dict:
    """Run one pair through ``flow_fn`` and score it against its truth.

    ``flow_fn`` takes and returns host arrays (``main`` wraps the device
    call).  With ``bucket`` > 0, frames are edge-padded (bottom/right) up to
    the next multiple of ``bucket`` per side before the pipeline and the
    flow is cropped back, as in the JAX tool, whose jitted pipeline then
    compiles once per bucket instead of once per distinct shape.
    ``frames`` supplies pre-decoded frame planes (see :func:`_load_pair`).
    """
    prev, nxt = frames if frames is not None else _load_pair(pair)
    if prev.shape != nxt.shape:
        raise ValueError(
            f"{pair['name']}: frame shapes differ "
            f"({prev.shape} vs {nxt.shape})"
        )
    h, w = prev.shape
    bh, bw = _bucket_shape((h, w), bucket)
    if (bh, bw) != (h, w):
        pad = ((0, bh - h), (0, bw - w))
        prev = np.pad(prev, pad, mode="edge")
        nxt = np.pad(nxt, pad, mode="edge")
    flow = flow_fn(prev, nxt)
    flow = flow[:h, :w]

    rec: dict = {"pair": pair["name"], "shape": [h, w]}
    if (bh, bw) != (h, w):
        rec["padded_shape"] = [bh, bw]
    rec.update(_score_flow(pair, flow, (h, w), margin))
    _write_artifacts(pair, flow, out_dir)
    return rec


def _score_flow(
    pair: dict, flow: np.ndarray, shape: tuple[int, int], margin: int
) -> dict:
    """Score a computed flow against the pair's truth (or flow stats when
    truthless) — the scoring half of :func:`evaluate_pair`, shared with the
    streaming evaluation path."""
    from cuda_optical_flow_2_torch.utils import io as uio
    from cuda_optical_flow_2_torch.utils import metrics

    h, w = shape
    occ = None
    if pair.get("occ"):
        occ = uio.read_image(pair["occ"])
        if occ.ndim == 3:
            occ = occ[..., 0]
        occ = occ > 0
    if pair["truth"] is not None:
        truth = uio.read_flow(pair["truth"])
        if truth.shape[:2] != (h, w):
            raise ValueError(
                f"{pair['name']}: ground truth shape {truth.shape[:2]} does "
                f"not match frames {(h, w)}"
            )
        return metrics.evaluate_flow(flow, truth, margin=margin, occ=occ)
    return {f"flow_{k}": v for k, v in metrics.flow_stats(flow).items()}


def _write_artifacts(pair: dict, flow: np.ndarray, out_dir: str | None) -> None:
    if not out_dir:
        return
    from cuda_optical_flow_2_torch.utils import io as uio
    from cuda_optical_flow_2_torch.utils import viz

    os.makedirs(out_dir, exist_ok=True)
    viz.write_png(
        os.path.join(out_dir, f"{pair['name']}_color.png"),
        viz.flow_to_color(flow),
    )
    uio.write_flo(os.path.join(out_dir, f"{pair['name']}.flo"), flow)
    # KITTI-encoded 16-bit artifact named per the truth convention, so an
    # --out directory is directly consumable as flow-PNG ground truth.
    uio.write_flow_png(os.path.join(out_dir, f"{pair['name']}_flow.png"), flow)


def _chain_pairs(pairs: list[dict]) -> list[list[dict]]:
    """Group pairs into streaming chains: consecutive pairs that share a
    frame file (pair[i].second == pair[i+1].first) form one chain — the
    shape flat-sequence and Sintel layouts produce.  Isolated pairs (KITTI,
    pair-directories) become length-1 chains, for which streaming reduces
    to the cold pairwise evaluation."""
    chains: list[list[dict]] = []
    for pair in pairs:
        if chains and chains[-1][-1]["second"] == pair["first"]:
            chains[-1].append(pair)
        else:
            chains.append([pair])
    return chains


def _run_streaming(
    pairs: list[dict],
    cfg,
    margin: int,
    out_dir: str | None,
    bucket: int,
    warm_start: bool,
    flow_fn=None,
    recovery=None,
    device=None,
) -> tuple[list[dict], int]:
    """Streaming evaluation: run each chain of consecutive frames through
    ``models.streaming.step`` with carried state on ``device`` (optionally
    warm-started from the previous pair's flow) and score every transition's
    flow against that pair's truth — the dataset-harness accuracy view of
    the serving configuration (warm-start + shallow pyramid), which the
    stateless per-pair path cannot score.

    ``flow_fn`` (optional, stateless pairwise flow on host arrays) adds a
    ``cold_epe_mean`` field per scored record so warm-start drift /
    lock-loss is visible directly against the cold path.

    ``recovery`` (optional :class:`models.streaming.RecoveryConfig`, needs
    ``warm_start``) arms the on-device scene-cut check + deep
    re-acquisition in every streaming step.

    Returns (records, number_of_chains).  Each record carries ``seq`` (chain
    index) and ``t`` (step index within the chain).
    """
    chains = _chain_pairs(pairs)
    # Same decode-prefetch doctrine as the cold loop: one worker decodes the
    # next frame while the device runs the current step.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        records = _run_chains(
            chains, cfg, margin, out_dir, bucket, warm_start, flow_fn, pool,
            recovery, device,
        )
    finally:
        # An exception mid-chain (frame-shape drift, decode failure in
        # _score_flow) must not leak the pool and its pending decode thread.
        pool.shutdown(wait=False, cancel_futures=True)
    return records, len(chains)


def _run_chains(
    chains, cfg, margin, out_dir, bucket, warm_start, flow_fn, pool,
    recovery=None, device=None,
) -> list[dict]:
    import torch

    from cuda_optical_flow_2_torch.models import streaming

    def on_device(frame: np.ndarray):
        return torch.as_tensor(frame, device=device)

    records: list[dict] = []
    for ci, chain in enumerate(chains):
        prev = _load_gray(chain[0]["first"])
        h, w = prev.shape
        bh, bw = _bucket_shape((h, w), bucket)

        def padded(frame: np.ndarray) -> np.ndarray:
            if frame.shape != (h, w):
                raise ValueError(
                    f"chain {ci}: frame shape drift {frame.shape} vs {(h, w)}"
                )
            if (bh, bw) != (h, w):
                frame = np.pad(
                    frame, ((0, bh - h), (0, bw - w)), mode="edge"
                )
            return frame

        state = streaming.init_state(on_device(padded(prev)), cfg, recovery)
        pending = pool.submit(_load_gray, chain[0]["second"])
        for t, pair in enumerate(chain):
            nxt = pending.result()
            if t + 1 < len(chain):
                pending = pool.submit(_load_gray, chain[t + 1]["second"])
            state, flow = streaming.step(
                state, on_device(padded(nxt)), cfg, warm_start, recovery
            )
            flow = flow.cpu().numpy()[:h, :w]
            rec: dict = {
                "pair": pair["name"], "shape": [h, w], "seq": ci, "t": t,
            }
            if (bh, bw) != (h, w):
                rec["padded_shape"] = [bh, bw]
            rec.update(_score_flow(pair, flow, (h, w), margin))
            if flow_fn is not None and pair["truth"] is not None:
                cold = flow_fn(padded(prev), padded(nxt))[:h, :w]
                cold_rec = _score_flow(pair, cold, (h, w), margin)
                rec["cold_epe_mean"] = cold_rec.get("epe_mean")
            _write_artifacts(pair, flow, out_dir)
            records.append(rec)
            prev = nxt
    return records


def _step(p, n, cfg, fill: bool):
    """The device part of one pair's flow: the family's flow, or with
    ``fill`` ``consistent_flow``'s occlusion-filled forward flow (the JAX
    tool's jitted ``_step``)."""
    from cuda_optical_flow_2_torch.models import consistent_flow, pyramidal_flow

    if fill:
        return consistent_flow(p, n, cfg, fill=True)[0]
    return pyramidal_flow(p, n, cfg)


@functools.cache
def _step_jit():
    """:func:`_step` as a captured entry (one graph per frame shape, config
    and ``fill``), made at first use and shared by every run in the
    process."""
    from cuda_optical_flow_2_torch.capture import captured

    return captured(_step)


def main(argv=None) -> None:
    from cuda_optical_flow_2_torch.cli import add_device_argument, device_from_flag

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, help="dataset directory")
    ap.add_argument(
        "--model", default="lk", choices=("lk", "hs", "fb", "tvl1", "dis")
    )
    ap.add_argument(
        "--preset", default=None,
        choices=(
            "reference_gpu", "reference_cpu", "paper_1080p",
            "tvl1_realtime", "dis_realtime",
        ),
        help="named operating point (fixes the model family and every "
        "config knob; combining it with an explicit --levels/--window/"
        "--iterations/--window-weights is an error, not a silent override)",
    )
    ap.add_argument("--levels", type=int, default=None,
                    help="pyramid depth (default 4)")
    ap.add_argument("--window", type=int, default=None,
                    help="integration window side (default 19)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="per-level iterations/sweeps (model default if unset)")
    ap.add_argument(
        "--window-weights", default=None, choices=("box", "tri", "gauss"),
        help="integration-window weighting for lk/dis (default: the config's"
        " default — see LKConfig.window_weights)",
    )
    ap.add_argument(
        "--refine-penalty", default=None,
        choices=("quadratic", "charbonnier"),
        help="DIS variational-refinement penalty (the recommended accuracy "
        "point is --refine-penalty charbonnier --refine-alpha 40)",
    )
    ap.add_argument(
        "--refine-alpha", type=float, default=None,
        help="DIS refinement smoothness weight (default 20.0)",
    )
    ap.add_argument(
        "--no-pallas", action="store_true",
        help="run the plain PyTorch versions instead of the CUDA kernels",
    )
    ap.add_argument(
        "--margin", type=int, default=None,
        help="border crop before scoring (default: window size)",
    )
    ap.add_argument("--out", default=None, help="write flow PNG/.flo per pair")
    ap.add_argument(
        "--sintel-pass", default="final", choices=("final", "clean"),
        help="render pass preferred in the Sintel layout",
    )
    ap.add_argument(
        "--bucket", type=int, default=0,
        help="pad frames up to multiples of this per side (edge replication,"
        " flow cropped back; the JAX tool's compile-once-per-bucket knob,"
        " kept so the two give the same flows); 0 = exact shapes",
    )
    ap.add_argument(
        "--streaming", action="store_true",
        help="evaluate chains of consecutive frames through the carried-"
        "state streaming step (models.streaming) instead of stateless "
        "per-pair flow; pairs sharing a frame file form one chain "
        "(flat-sequence / Sintel layouts)",
    )
    ap.add_argument(
        "--warm-start", action="store_true",
        help="with --streaming: seed each pair with the previous pair's "
        "flow (the serving configuration, e.g. --levels 1)",
    )
    ap.add_argument(
        "--compare-cold", action="store_true",
        help="with --streaming: also run the stateless pairwise flow per "
        "pair and report cold_epe_mean next to each streaming record "
        "(lock-loss / drift visibility)",
    )
    ap.add_argument(
        "--fill-occlusions", action="store_true",
        help="run the model in both directions per pair, detect occlusions "
        "with the cycle check, and replace masked flow with the side-aware "
        "diffusion fill (models.consistency.fill_occluded_flow) before "
        "scoring — ~2x the flow cost; not available with --streaming",
    )
    ap.add_argument(
        "--recover-levels", type=int, default=None, metavar="N",
        help="with --warm-start: arm on-device scene-cut detection; when "
        "the warm seed fails the photometric acquisition check the pair is "
        "re-solved from scratch over an N-level pyramid "
        "(models.streaming.RecoveryConfig)",
    )
    ap.add_argument(
        "--recover-ratio", type=float, default=0.7,
        help="seed-validity threshold: drop the seed when its warped "
        "residual >= RATIO x the zero-flow residual at the deepest carried "
        "level (default 0.7 — see models.streaming.RecoveryConfig)",
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if (args.warm_start or args.compare_cold) and not args.streaming:
        ap.error("--warm-start/--compare-cold require --streaming")
    if args.recover_levels is not None and not args.warm_start:
        ap.error("--recover-levels requires --streaming --warm-start")
    if args.fill_occlusions and args.streaming:
        ap.error(
            "--fill-occlusions needs per-pair backward flow and does not "
            "compose with --streaming"
        )

    device = device_from_flag(args.device)

    import dataclasses

    import torch

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.cli.benchmark import _model_cfg

    if args.preset is not None:
        # A preset fixes every config knob; an explicitly-passed conflicting
        # flag must error, not vanish.
        conflicting = [
            flag
            for flag, val in (
                ("--levels", args.levels),
                ("--window", args.window),
                ("--iterations", args.iterations),
                ("--window-weights", args.window_weights),
                ("--refine-penalty", args.refine_penalty),
                ("--refine-alpha", args.refine_alpha),
            )
            if val is not None
        ]
        if conflicting:
            ap.error(
                f"--preset {args.preset} fixes the config knobs; drop "
                f"{'/'.join(conflicting)} or select them without a preset"
            )
        cfg = getattr(of, args.preset.upper())
        if args.no_pallas:
            cfg = dataclasses.replace(cfg, use_pallas=False)
        margin = args.margin if args.margin is not None else getattr(
            cfg, "window", getattr(cfg, "winsize", 16)
        )
    else:
        levels = args.levels if args.levels is not None else 4
        window = args.window if args.window is not None else 19
        lk = of.LKConfig(levels=levels, window=window)
        cfg = _model_cfg(args.model, lk, args.no_pallas)
        if args.iterations is not None and hasattr(cfg, "iterations"):
            cfg = dataclasses.replace(cfg, iterations=args.iterations)
        for flag, attr, val in (
            ("--window-weights", "window_weights", args.window_weights),
            ("--refine-penalty", "refine_penalty", args.refine_penalty),
            ("--refine-alpha", "refine_alpha", args.refine_alpha),
        ):
            if val is None:
                continue
            if not hasattr(cfg, attr):
                # an explicitly passed knob the family lacks errors, never
                # vanishes
                ap.error(
                    f"{flag} does not apply to --model {args.model}"
                )
            cfg = dataclasses.replace(cfg, **{attr: val})
        margin = args.margin if args.margin is not None else window

    # `compiles` keeps the JAX tool's summary key: the number of distinct
    # frame shapes the pipeline ran at (the JAX tool compiles once per
    # shape), so with --bucket it is the number of buckets.
    shapes: set = set()
    step = _step_jit()

    def flow_fn(p: np.ndarray, n: np.ndarray) -> np.ndarray:
        shapes.add(p.shape)
        p = torch.as_tensor(p, device=device)
        n = torch.as_tensor(n, device=device)
        # on CUDA a replay; the host copy stays outside the graph
        return step(p, n, cfg, args.fill_occlusions).cpu().numpy()

    layout, pairs = _discover(args.dataset, sintel_pass=args.sintel_pass)
    recovery = None
    if args.recover_levels is not None:
        recovery = of.RecoveryConfig(
            levels=args.recover_levels, ratio=args.recover_ratio
        )
    if args.streaming:
        records, n_chains = _run_streaming(
            pairs, cfg, margin, args.out, args.bucket, args.warm_start,
            flow_fn=flow_fn if args.compare_cold else None,
            recovery=recovery, device=device,
        )
        scored = []
        for rec in records:
            print(_json_line(rec), flush=True)
            if "epe_mean" in rec:
                scored.append(rec)
        summary: dict = {
            "aggregate": True,
            "model": type(cfg).__name__ if args.preset else args.model,
            **({"preset": args.preset} if args.preset else {}),
            "layout": layout,
            "mode": "streaming-warm" if args.warm_start else "streaming",
            **(
                {"recover_levels": recovery.levels}
                if recovery is not None
                else {}
            ),
            "pairs": len(pairs),
            "chains": n_chains,
            "pairs_with_truth": len(scored),
        }
        if scored:
            for key in (
                "epe_mean", "angular_deg_mean", "fl_all", "bad_1px",
                "bad_3px", "epe_matched", "epe_unmatched", "cold_epe_mean",
            ):
                vals = [
                    r[key]
                    for r in scored
                    if r.get(key) is not None and np.isfinite(r[key])
                ]
                if vals:
                    summary[key] = float(np.mean(vals))
            # Drift indicator: mean EPE over the first vs last third of each
            # chain's timeline (lock loss shows as late >> early).
            # Finite-filtered like the aggregates above: one degenerate
            # pair's inf/NaN EPE must not null out the drift indicator.
            third = [
                r for r in scored
                if r.get("seq") is not None and np.isfinite(r["epe_mean"])
            ]
            if third:
                by_seq: dict = {}
                for r in third:
                    by_seq.setdefault(r["seq"], []).append(r)
                early, late = [], []
                for seq in by_seq.values():
                    seq.sort(key=lambda r: r["t"])
                    k = max(1, len(seq) // 3)
                    early += [r["epe_mean"] for r in seq[:k]]
                    late += [r["epe_mean"] for r in seq[-k:]]
                if early and late:
                    summary["epe_early_third"] = float(np.mean(early))
                    summary["epe_late_third"] = float(np.mean(late))
        print(_json_line(summary), flush=True)
        return
    scored = []
    # One decode worker prefetches the NEXT pair's frames while the device
    # evaluates the current one (PNG inflate + grayscale are host work that
    # would otherwise serialize with compute — the FrameStream doctrine,
    # native/framesrc.cpp, applied to the eval loop).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(_load_pair, pairs[0]) if pairs else None
        for i, pair in enumerate(pairs):
            frames = pending.result()
            pending = (
                pool.submit(_load_pair, pairs[i + 1])
                if i + 1 < len(pairs)
                else None
            )
            rec = evaluate_pair(
                pair, flow_fn, margin, args.out, bucket=args.bucket,
                frames=frames,
            )
            print(_json_line(rec), flush=True)
            if "epe_mean" in rec:
                scored.append(rec)

    summary: dict = {
        "aggregate": True,
        "model": type(cfg).__name__ if args.preset else args.model,
        **({"preset": args.preset} if args.preset else {}),
        **({"fill_occlusions": True} if args.fill_occlusions else {}),
        "layout": layout,
        "pairs": len(pairs),
        "pairs_with_truth": len(scored),
        "compiles": len(shapes),
    }
    if scored:
        for key in (
            "epe_mean", "angular_deg_mean", "fl_all", "bad_1px", "bad_3px",
            "epe_matched", "epe_unmatched",
        ):
            # Finite-filtered: a pair whose matched/occluded side is empty
            # reports NaN for that split (metrics.evaluate_flow), and a
            # degenerate pair can report inf; neither may poison the run
            # aggregate.
            vals = [
                r[key] for r in scored if key in r and np.isfinite(r[key])
            ]
            if vals:
                summary[key] = float(np.mean(vals))
    print(_json_line(summary), flush=True)


if __name__ == "__main__":
    main()
