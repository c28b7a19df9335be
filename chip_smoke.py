#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 8p   # phase 8p alone, on every card present
    python3 chip_smoke.py --phase 8q   # phase 8q alone (the handoff kernel)
    python3 chip_smoke.py --phase 8r   # phase 8r alone (OpenCV's DIS PRESET_MEDIUM)
    python3 chip_smoke.py --phase 8s   # phase 8s alone (the LK kernel's geometry)
    python3 chip_smoke.py --phase 8t   # phase 8t alone (TV-L1's clustered relaxation)

Run from the root of a checkout.  It builds the CUDA kernels from
``cuda_optical_flow_2_torch/csrc`` (one nvcc per source, in parallel) and
then, in order:

1. device: requires a CUDA device, prints its name and power limit, and
   turns TF32 off for cuDNN and matmul;
2. build: compiles the kernels and prints the build time;
3. kernels: each kernel against its plain PyTorch version at the paths'
   level-0 shapes (1080x1920 and 480x640); the time-tiled relaxations on a
   ragged batch (2x479x641, counts no launch depth divides), TV-L1
   bit-equal; ``lk_level_step``'s ``flow_half`` mode bit-equal to the step
   on ``upsample_flow`` of the coarser flow; the window kernels' tile edges
   (LK windows 65 and 1, FB windows 15 and 1 on the ragged batch, a band
   bit-equal to the whole image at the 1x1 windows, ``flow_half`` at
   2x478x642); the bilateral (windows 9 and 31, whole and on bands past the
   top and the bottom of the global image) and the expansion (``poly_n`` 5,
   7 and 31) on the ragged batch, each case naming the instance it took
   (compiled in or generic); ``median_filter_kernel`` ``torch.equal`` to
   the plain median at sizes 3 and 5 on the flow view and planes at
   1080x1920, the ragged batch and TP bands with their edge halos, and NaN
   where the plain median gives NaN; ``window_solve`` bit-equal at windows
   1, 15 and 33 (also on the ragged batch); ``fb_level_step`` at winsize 33,
   ``poly_n`` 31 on the ragged batch no farther from a float64 run of the
   plain version than the float32 plain version is;
   ``fill_occluded_flow_kernel`` bitwise equal to the plain fill (NaN and
   -0.0 included) on the ragged batch of random disks at 0, 1, 7, 8, 9 and
   96 sweeps, beta 0 and 1, the matched pixels bitwise the input;
4. path ``PAPER_1080P``: ``pyramidal_lk`` on a 1080x1920 pair translating at
   (2, 1) px, against the plain path (``use_pallas=False``, the same plain
   ops without the budget clamp, which (2, 1) never reaches);
5. path entry config: ``LKConfig(levels=4, window=19)`` on a random 480x640
   pair;
6. path serving loop: warm ``process_sequence`` with scene-cut recovery
   over eight 1080x1920 frames with a cut and a dropped frame;
7. path ``REFERENCE_GPU`` (bilateral prefilter, the reference's live loop):
   ``pyramidal_lk`` at 480x640 and 1080x1920 against the plain path, cold
   ``process_sequence`` over eight numpy 480x640 frames (which go to the
   card by default), and a (2, 1) translation check with a prefilter;
8. path Horn-Schunck: ``pyramidal_hs`` at 1080x1920 with both penalties and
   single-scale ``horn_schunck``, against the plain path, with a (2, 1)
   translation check;
8b. paths Farnebäck at 1080x1920: ``pyramidal_farneback`` in the image form
   (``FBConfig()``) and the coeff form, each against the plain path with a
   (2, 1) translation check and its launch counts checked against the
   predicted ones, and the warm serving loop (``levels=1``, one iteration,
   ``RecoveryConfig(levels=3)``) over eight frames with a cut and a dropped
   frame, against its plain run;
8c. paths model-generic entry points at 480x640: ``pyramidal_flow`` on all
   five families, and warm HS, TV-L1 and DIS streaming with recovery, each
   against its plain run;
8d. paths TV-L1 at 1080x1920: ``TVL1_REALTIME`` and ``TVL1Config()``, each
   against the plain path with a (2, 1) translation check and its launch
   counts checked against the predicted ones (one median launch per warp;
   none on the plain path);
8e. paths DIS at 1080x1920: ``DISConfig()``, ``DIS_REALTIME`` and the
   Charbonnier refinement, likewise;
8f. spatial TP at 2160x3840 (4K UHD, period 48, a (2, 1) translation): each
   band kernel against its plain version at its level-0 band shape (720
   rows plus its halos) on the top, an interior and the bottom band;
   ``spatial_pyramidal_lk`` at ``PAPER_1080P`` and ``REFERENCE_GPU`` and
   ``spatial_pyramidal_hs`` at ``HSConfig()`` on a 3-shard mesh over the
   one card, against the plain TP path, the unsharded kernel path and the
   translation, and on a 1-shard mesh against the unsharded kernel path;
   ``grid_pyramidal_lk`` on a batch of 2 over a (2 batch x 3 space) mesh;
   launch counts checked against the predicted ones;
8g. spatial TP for TV-L1 and Farnebäck at 2160x3840 on the same meshes:
   ``tvl1_relax_band`` (8 iterations, carried duals) and ``fb_band_step``
   (first and warm) against their plain versions on the top, an interior
   and the bottom band; ``spatial_pyramidal_tvl1`` at ``TVL1_REALTIME`` and
   ``spatial_pyramidal_fb`` at ``FBConfig()`` against the plain TP path,
   the unsharded kernel path and the translation on 3 shards and the
   unsharded kernel path on 1; ``FBConfig(gaussian_window=True)`` (the
   non-fused level) and ``TVL1Config()`` on 3 shards against the unsharded
   kernel path; launch counts checked against the predicted ones;
8h. window limits: ``LKConfig(levels=3, window=67)`` and a 33-wide
   bilateral prefilter at 480x640, past the CUDA kernels' limits, take the
   plain composition for that stage (no launch of the kernel) and are held
   against the plain path;
8i. ``fused_half_upsample=True``: ``PAPER_1080P`` and ``DISConfig()`` at
   1080x1920 bit-equal to the flag off, with the (2, 1) checks and the flag
   off's launches (the port takes the same route either way), and a warm
   LK stream (``levels=3``) over phase 6's frames bit-equal to the flag off
   with its launches;
8j. spatial TP for DIS at 2160x3840: ``DISConfig(levels=4)`` and its
   Charbonnier form on 3 shards (``DISConfig()`` does not fit 3 shards at
   4K: level 4 holds 45 rows per shard against a halo of 46),
   ``DISConfig()`` and ``DIS_REALTIME`` on 1 shard, each against the
   unsharded kernel path and the translation, launch counts checked against
   the predicted ones;
8k. paths quality signals: ``consistent_flow`` with ``TVL1Config(levels=3)``
   on the layered scenes of tests/test_layered_motion.py (192x256: the disk,
   seed 3, and the bar, seed 7), held to that file's detection bounds (disk
   precision > 0.45 and recall > 0.50 at beta 0.5, bar average precision >
   0.55) with the port's ``utils.layered`` and ``utils.metrics``; the disk
   scene at 1080x1920 (centre (540, 960), radius 45 * 1080 / 192 = 253.125,
   the motion kept: background (-2, 1), disk (3, 1) px) through
   ``consistent_flow(..., TVL1_REALTIME)`` with and without the fill
   (matched and unmatched EPE before and after it), each against the plain
   path; ``fb_consistency``'s cycle warp (#3 on both planes, budget
   max(H, W)) against the plain warp; ``good_features`` (500 points,
   ``LKConfig(window=15)``) on a period-48 frame equal to a CPU run of it;
   ``track_sequence`` at ``PAPER_1080P``, warm, over 8 frames translating at
   (2, 1) seeded by those points (points 64 px or more inside within 0.35 px
   of p0 + t (2, 1)), and ``track_points`` within 1e-5 px of it; launch
   counts checked against the predicted ones (``consistent_flow``: twice a
   pair's and one cycle warp, with the fill also one call of the occlusion
   fill kernel, which is held bitwise to its plain version on the path's
   flow and mask; ``good_features`` and the plain paths none);
8l. the reference-exact profiles and the four command-line tools:
   ``models.compat.pyramidal_lk_exact`` (both profiles) on the golden 64x64
   pair against ``tests/golden/`` and at 480x640 and 1080x1920 against a
   CPU run of the port (uint8 pyramids and int32 sums ``torch.equal``, the
   CPU profile within 1e-9, the GPU profile within 2e-3), no kernel
   launched; ``cli.benchmark`` configs 1-5 on LK and config 4 on HS, FB,
   TV-L1 and DIS, each EPE within 1e-3 px of its ``--no-pallas`` run and
   its launches those of its calls of a direct call; ``cli.evaluate`` on a
   Sintel tree at 1080x1920 (two ``synthetic_sequence`` sequences of five
   frames and phase 8k's disk scene with its ``occ/`` truth): the
   ``paper_1080p`` preset, ``tvl1_realtime`` on the disk with and without
   ``--fill-occlusions`` (tests/test_evaluate.py's bounds; the fill runs the
   occlusion fill kernel, ``--no-pallas`` its plain version), warm streaming
   with recovery and DIS, each summary within 1e-3 px of ``--no-pallas``;
   ``utils.debug.stage_report`` of every family at 1080x1920 (kernel,
   banded and oracle against plain; each kernel row within its kernel's
   limits above) and ``sharded`` over 3 shards of the card bit-equal to the
   kernel path for LK, HS, TV-L1 and FB, and ``cli.diff``; ``cli.demo`` on
   8 synthetic frames for the five models (LK at 1080x1920 with the
   bilateral, warm with recovery over the native stream, and plain; the
   others at 480x640), each with its EPE lines and artifacts, and
   ``utils.native`` built;
8m. the examples, gradients and multihost: each of the ten
   ``cuda_optical_flow_2_torch.examples`` through ``main(device="cuda")``
   with its own asserts and printed numbers, its launches those
   ``example_launches`` predicts (none for ``gradient_alignment`` and
   ``learned_refinement``, which train through the plain path); forward +
   backward of the plain path (``use_pallas=False``) of ``PAPER_1080P``,
   ``HSConfig()``, ``FBConfig()``, ``TVL1Config()`` and ``DISConfig()`` at
   1080x1920 (ms, peak memory), no launch, the gradient within 1e-4 of
   max |g| of a CPU run of the same code (at the max; ``TVL1Config()`` at
   135x240 at the median and ``DISConfig()`` at the p99, with the JAX
   test's TV-L1 config and DIS without mean normalization at the max:
   ``GRAD_REL_ERR``), and the same call with ``use_pallas=True`` and an
   input that requires grad raising;
   ms per adam step of ``gradient_alignment`` and per train step of
   ``learned_refinement``; two processes (``--multihost-worker``) in a
   gloo group on the one card, each feeding its half of a 4-pair
   ``PAPER_1080P`` batch through ``parallel.multihost``, bit-equal to the
   single-process ``sharded_flow``;
8n. the captured entries (CUDA graphs, ``capture.captured``): each family's
   ``pyramidal_<family>_jit`` at ``PAPER_1080P`` (also with
   ``fused_half_upsample``), ``REFERENCE_GPU``, both HS penalties, FB image
   and coeff, ``TVL1_REALTIME``, ``TVL1Config()``, ``DISConfig()`` and
   ``DIS_REALTIME`` at 1080x1920 and the entry config at 480x640, each
   ``torch.equal`` to the eager entry on two pairs, its (2, 1) check, its
   launches the eager call's, one capture per key, the replay's kernels
   those of the eager call in the profiler, captured and eager ms per pair,
   busy share, graph nodes, pool MB and capture seconds; the warm LK and FB
   serving loops with recovery over phase 6's frames through the captured
   ``init_state`` / ``step``, every step ``torch.equal`` to the eager
   ``_step``; a step is one replay (the recovery check's solves as CUDA
   conditional nodes, the state donated): launches after
   ``capture.settle()`` the eager loop's, both branches replayed as the
   eager loop took them (device counts), only the frame copied in after
   the first warm step (the general pool refilled with NaN between steps),
   no sync under ``torch.cuda.set_sync_debug_mode("error")`` with the
   program's spans off and recorded under a profiler, ms between
   events and back to back, busy share, device ops per branch and the warm
   key's memory; a grad input running the eager plain path; a failing
   capture raising;
8o. the rest of the JAX package's jitted surface, captured: at 2160x3840
   on the 3-shard mesh of the one card ``spatial_pyramidal_lk`` at
   ``PAPER_1080P`` and ``REFERENCE_GPU``, ``spatial_pyramidal_hs``
   (``HSConfig()``), ``_tvl1`` (``TVL1_REALTIME``), ``_fb`` (``FBConfig()``),
   ``_dis`` (``DISConfig(levels=4)``) and ``grid_pyramidal_lk`` over (2 batch
   x 3 space); at 1080x1920 ``sharded_flow`` (batch 4 over the card twice),
   ``chunked_flow`` (batch 8, chunk 2), ``track_sequence`` (8 frames) and the
   evaluate tool's step without and with the occlusion fill: each
   ``torch.equal`` to its eager body (``.eager``) on two inputs, one capture
   per key, launches per call the eager call's, the replayed kernels (and,
   for one graph per call, every device op) those of the eager call in the
   profiler, its (2, 1) check, captured and eager ms, busy share, graph
   nodes, pool MB and capture seconds; every band kernel launched inside a
   replay.  The plain references of phases 8f and 9 for the TP and tracking
   paths run the eager bodies, as before these entries were captured;
8p. every multi-device entry over the cards present (on one card over
   meshes that name it ``cuda`` and ``cuda:0`` in turn, which the
   placement rule counts as two devices): DP (``sharded_flow`` of the five
   family defaults, 8 pairs at 1080x1920 over 4 mesh entries;
   ``sharded_pyramidal_lk``; ``chunked_flow`` on each card), spatial TP at
   2160x3840 (``HSConfig()`` and ``FBConfig()`` over 4, phase 8o's LK,
   TV-L1 and DIS entries over 3), ``grid_pyramidal_lk`` (``REFERENCE_GPU``)
   and ``grid_pyramidal_flow`` (``TVL1_REALTIME``) over 2 x 2, one warm LK
   and FB serving stream with recovery per mesh entry, the ``sharded_batch``
   and ``spatial_tp`` examples, and one NCCL process per card: each
   ``torch.equal`` to its eager body and to the same entry with its shards
   on one card, launches the eager call's, every TP / grid graph spanning
   its axis's cards, no host read in a warm call, TP bit-equal to the
   unsharded path (DIS within ``DIS_TP_MAX_ERR``), DP's cards running at
   once; ms captured and eager on the cards and on one card, device busy
   per card, the copies between cards, pool MB per card, capture seconds.
   ``python3 chip_smoke.py --phase 8p`` runs it alone after the build, on
   every card of the machine (its last line the ok line, no kernel line);
8q. the coarse-to-fine handoff kernel (``kernels/upsample_flow``):
   ``torch.equal`` (every bit, NaN, inf and -0.0 included) to
   ``upsample_flow_plain`` at each ``PAPER_1080P`` handoff at 1080x1920
   (67x120 -> 135x240 up to 540x960 -> 1080x1920) at batches 1, 8 and 54,
   on ragged shapes (odd W: the float2-store path; 1x1 -> 3x3) and on a
   transposed and an offset view; 4 launches per captured ``PAPER_1080P``
   and ``TVL1Config()`` call (the replay ``torch.equal`` to the capturing
   call and to eager) and per warm serving step (4 streams,
   ``RecoveryConfig()``), none with ``use_pallas=False``, levels - 1 per
   ``HSConfig()``, ``FBConfig()``, ``DISConfig()`` and ``TVL1_REALTIME``
   call and no octave handoff of theirs on the plain stencil; the captured
   ``PAPER_1080P`` replay's device ops; the kernel's, the plain version's,
   ``F.interpolate``'s and the bound's ms at 540x960 -> 1080x1920 and over
   a pair's four handoffs; its largest |d| at the plain version's finite
   values is the kernel's ``max_abs_err`` in the kernels line (its
   launches there are those of the paths of phases 4-8p, its times phase
   9's).  ``python3 chip_smoke.py --phase 8q`` runs it alone after the
   build;
8r. OpenCV's DIS PRESET_MEDIUM (the ``fields`` of
   ``flowbench/configs/dis_opencv_medium_1080p.json``: 7 levels solved from
   6 to 1, 25 centered steps per level, window 9, Charbonnier refinement)
   on an 8-pair 1080x1920 uint8 batch: the eager call's launches are
   ``DIS_MEDIUM_LAUNCHES``; through
   ``pyramidal_dis_jit`` the capturing call and replays on two batches
   ``torch.equal`` to the eager calls, the counters moved by the eager
   call's launches per call, and ``capture.stats()``'s ``launches`` of the
   one graph equal to them; the spans ``dis.search`` and ``dis.refine``
   once per solved level in an eager call under the profiler, none in a
   replay; the replay's device ops, pool MB, capture s, ms per pair
   captured and eager, and the inner median flow (printed: the preset's 25
   undamped steps drift on this texture).  ``python3 chip_smoke.py --phase
   8r`` runs it alone after the build;
8s. the LK kernel's geometry (``csrc/of2_lk_tile.cuh``,
   ``kernels/tile_geometry.lk_launch``): each of the instances
   (``lk_residual``, ``lk_level_step``, each plain and centered, and
   ``lk_band_step``) at the benchmark's level-0 shapes
   (``PAPER_1080P`` at 8 x 1080 x 1920, the DIS 9x9 box centered mode at
   8 x 540 x 960) ``torch.equal`` to the same C entry launched with two
   forced blocks (the walker: segments of a step's rows and of the whole
   image; the centered tile: 8 and 24 rows), and ``lk_band_step`` on a band over
   the middle half of the
   rows bit-equal to ``lk_level_step``'s rows at least the warp halo from
   its edges, both modes; the halo factor at those shapes
   (``tile_geometry.lk_cells``).  ``python3
   chip_smoke.py --phase 8s`` runs it alone after the build;
8t. TV-L1's relaxation in thread-block clusters (``csrc/tvl1_sweep.cu``,
   ``kernels/tile_geometry.tvl1_cluster``): ``tvl1_relax`` (30 iterations)
   ``torch.equal`` to ``tvl1_relax_plain`` at ``TVL1Config()``'s five level
   shapes at 1080x1920 with 8 pairs and with one, and on the ragged
   2x479x641 batch, through the wrapper (its cluster the rule's, counted
   in ``launches_clustered``) and in every cluster shape compiled in;
   ``tvl1_relax_band`` (8 iterations, carried duals) ``torch.equal`` to
   ``tvl1_relax_band_plain`` on the top, an interior and the bottom band
   of a 3-shard 2160x3840 split, likewise; the counters over one eager
   ``TVL1Config()`` call at 1080x1920: 25 ``tvl1_relax`` calls, 10
   clustered with 8 pairs, 5 with one; the card's SMs and
   ``cudaOccupancyMaxActiveClusters`` per cluster shape, and each level
   shape's device ms plain and in the rule's cluster.  ``python3
   chip_smoke.py --phase 8t`` runs it alone after the build;
9. timing with CUDA events: each path (the TP paths beside their unsharded
   runs at 4K; host time included; ``consistent_flow`` with the fill off
   and on, the fill alone and its plain version, ``good_features`` and
   ``track_sequence`` per frame), each kernel (the occlusion fill on phase
   8k's disk mask and on occluded stripes that leave no tile idle, the
   stripes first held to its plain version), its plain version and,
   where one PyTorch call computes the same function, that call, in device
   time (the card waits in a sleep kernel while the host enqueues the
   calls, so a wrapper's launch cost does not hide a faster kernel);
10. profile: ``torch.profiler`` over a few pairs (or calls) of each path of
    phase 9 (device busy share, kernels per pair, the kernels that lead);
    every trace (phases 8n and 10) lies between two spin kernels, each
    with a run of lead kernels outside it, and is taken again with longer
    leads when the profiler lost a spin or all the leads beside it.

Each phase prints one line per check; any failed check raises and the
script exits non-zero.  The launch counters are zeroed just before each path
(phases 4-8m) and read just after it: every kernel must launch on the paths
that use it.  The line before the last is a JSON object with each kernel's
numbers, the centered (DIS) modes of ``lk_residual``, ``lk_level_step`` and
``lk_band_step`` as entries of their own (``launches`` is its sum over the
path runs, ``bound_ms`` the least time the card could take for the timed
call's work: the larger of its bytes over the memory rate and its operations
over the peak rate of their kind);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# (name, module, plain version, source, TPU kernel replaced)
KERNELS = [
    ("lk_residual", "lk_fused", "lk_residual_plain",
     "cuda_optical_flow_2_torch/csrc/lk_fused.cu",
     "cuda_optical_flow_2_tpu/kernels/lk_fused.py:327"),
    ("lk_level_step", "lk_step_fused", "lk_level_step_plain",
     "cuda_optical_flow_2_torch/csrc/lk_step_fused.cu",
     "cuda_optical_flow_2_tpu/kernels/lk_step_fused.py:278"),
    ("warp_bilinear_select", "warp_select", "warp_bilinear_select_plain",
     "cuda_optical_flow_2_torch/csrc/warp_select.cu",
     "cuda_optical_flow_2_tpu/kernels/warp_select.py:108"),
    ("pyr_down", "pyr_down", "pyr_down_plain",
     "cuda_optical_flow_2_torch/csrc/pyr_down.cu",
     "cuda_optical_flow_2_tpu/kernels/pyr_down.py:66"),
    ("bilateral_kernel", "bilateral_tap", "bilateral_kernel_plain",
     "cuda_optical_flow_2_torch/csrc/bilateral.cu",
     "cuda_optical_flow_2_tpu/kernels/bilateral_tap.py:202"),
    ("hs_relax", "hs_sweep", "hs_relax_plain",
     "cuda_optical_flow_2_torch/csrc/hs_sweep.cu",
     "cuda_optical_flow_2_tpu/kernels/hs_sweep.py:214"),
    ("poly_expansion_kernel", "poly_exp_fused", "poly_expansion_plain",
     "cuda_optical_flow_2_torch/csrc/poly_exp.cu",
     "cuda_optical_flow_2_tpu/kernels/poly_exp_fused.py:69"),
    ("window_solve", "win_solve", "window_solve_plain",
     "cuda_optical_flow_2_torch/csrc/win_solve.cu",
     "cuda_optical_flow_2_tpu/kernels/win_solve.py:83"),
    ("fb_level_step", "fb_step_fused", "fb_level_step_plain",
     "cuda_optical_flow_2_torch/csrc/fb_step.cu",
     "cuda_optical_flow_2_tpu/kernels/fb_step_fused.py:246"),
    ("tvl1_relax", "tvl1_sweep", "tvl1_relax_plain",
     "cuda_optical_flow_2_torch/csrc/tvl1_sweep.cu",
     "cuda_optical_flow_2_tpu/kernels/tvl1_sweep.py:202"),
    # TV-L1's per-warp median: its TPU counterpart has no pallas_call
    ("median_filter_kernel", "median_select", "median_filter_plain",
     "cuda_optical_flow_2_torch/csrc/median_select.cu",
     "cuda_optical_flow_2_tpu/ops/median.py:27"),
    # the occlusion fill's 96 sweeps: a lax.fori_loop in JAX, no pallas_call
    ("fill_occluded_flow_kernel", "occlusion_fill", "fill_occluded_flow_plain",
     "cuda_optical_flow_2_torch/csrc/occlusion_fill.cu",
     "cuda_optical_flow_2_tpu/models/consistency.py:124"),
    # the coarse-to-fine flow handoff: plain XLA in JAX, no pallas_call
    ("upsample_flow", "upsample_flow", "upsample_flow_plain",
     "cuda_optical_flow_2_torch/csrc/upsample_flow.cu",
     "cuda_optical_flow_2_tpu/ops/resize.py:49"),
    # the spatial-TP band entries: the same sources with the band's global rows
    ("lk_band_step", "lk_step_fused", "lk_band_step_plain",
     "cuda_optical_flow_2_torch/csrc/lk_step_fused.cu",
     "cuda_optical_flow_2_tpu/kernels/lk_step_fused.py:309"),
    ("warp_bilinear_select_band", "warp_select", "warp_bilinear_select_band_plain",
     "cuda_optical_flow_2_torch/csrc/warp_select.cu",
     "cuda_optical_flow_2_tpu/kernels/warp_select.py:132"),
    ("bilateral_kernel_band", "bilateral_tap", "bilateral_kernel_band_plain",
     "cuda_optical_flow_2_torch/csrc/bilateral.cu",
     "cuda_optical_flow_2_tpu/kernels/bilateral_tap.py:220"),
    ("hs_relax_band", "hs_sweep", "hs_relax_band_plain",
     "cuda_optical_flow_2_torch/csrc/hs_sweep.cu",
     "cuda_optical_flow_2_tpu/kernels/hs_sweep.py:252"),
    ("tvl1_relax_band", "tvl1_sweep", "tvl1_relax_band_plain",
     "cuda_optical_flow_2_torch/csrc/tvl1_sweep.cu",
     "cuda_optical_flow_2_tpu/kernels/tvl1_sweep.py:233"),
    ("fb_band_step", "fb_step_fused", "fb_band_step_plain",
     "cuda_optical_flow_2_torch/csrc/fb_step.cu",
     "cuda_optical_flow_2_tpu/kernels/fb_step_fused.py:271"),
]
# The DIS (centered=True) mode of three of them, an entry of its own in the
# kernels line: launches from the wrappers' ``launches_centered``.
CENTERED = ["lk_residual", "lk_level_step", "lk_band_step"]

WARP_MAX_ERR = 1e-3      # intensities 0-255: float order of four taps
PYR_MAX_ERR = 1e-4       # intensities 0-255: 9-tap sum against separable slices
BILATERAL_MAX_ERR = 1e-3  # intensities 0-255: order of up to 361 weighted taps
LK_MEDIAN_ERR = 1e-4     # px, kernel vs plain, per pixel
LK_P999_ERR = 1e-2       # px: ill-conditioned pixels amplify summation order
# px, 100 sweeps, kernel vs plain, per pixel: tightened from 1e-4 / 1e-2 to
# what the card shows with margin (max 2.4e-6 on an H100 80GB HBM3, 700 W)
HS_MEDIAN_ERR = 1e-5
HS_P999_ERR = 1e-4
# intensities 0-255: expansion planes, |d| <= atol + rtol |plain| (float order
# of ~60 taps and the mixing); atol tightened from 1e-3 to what the card shows
# with margin (max 5.2e-5 on an H100 80GB HBM3, 700 W)
POLY_RTOL, POLY_ATOL = 1e-4, 2e-4
# px, kernel vs plain, per pixel: 1/det amplifies summation order, as for LK.
# Tightened from 1e-4 / 1e-2 to what the card shows with margin (same card):
# fb_level_step median 1.4e-6, p99.9 7.2e-4 (a flow of up to 20 px);
# window_solve bit-equal to its plain version (same sums in the same order),
# which phase 3 requires besides these limits
FB_STEP_MEDIAN_ERR, FB_STEP_P999_ERR = 1e-5, 5e-3
WIN_SOLVE_MEDIAN_ERR, WIN_SOLVE_P999_ERR = 1e-6, 1e-5
# px, 14-30 iterations, kernel vs plain, per pixel: the threshold step's
# near-ties (rho against +-th) flip on float-order differences and move a
# pixel far, so the median and p99.9 are held, not the max.  The kernel
# rounds every step in the plain version's order, and the card showed it
# bit-equal (an H100 80GB HBM3, 700 W); the limits leave room for isolated
# flips only.
TVL1_MEDIAN_ERR, TVL1_P999_ERR = 1e-6, 1e-5
# px, centered (DIS) window sums, kernel vs plain, per pixel: S_ab - S_a S_b / n
# cancels and 1/det amplifies it; the card showed median 0, p99.9 1.9e-6 and
# max 2.9e-6 px (same card), so 1e-5 / 1e-4
CENTERED_MEDIAN_ERR, CENTERED_P999_ERR = 1e-5, 1e-4
# px, the occlusion fill kernel vs its plain version at the filled pixels,
# should it stop being bit-equal (exp, division and sqrt round as the plain
# ops do on the card; an H100 80GB HBM3, 700 W, showed it bit-equal); the
# matched pixels are held bitwise to the input always
FILL_MAX_ERR = 1e-5
PATH_MEDIAN_ERR = 1e-3   # px, whole pipeline, kernel vs plain path
PATH_P99_ERR = 1e-2
TRANSLATION_TOL = 0.1    # px, LK inner median flow vs the true (2, 1)
HS_TRANSLATION_TOL = 0.15  # px, HS inner median flow (tests/test_horn_schunck.py)
TVL1_EPE_TOL = 0.1         # px, TVL1Config() inner EPE (tests/test_tvl1.py)
DIS_EPE_TOL = 0.15         # px, DISConfig() inner EPE (tests/test_dis.py)
PRESET_TRANSLATION_TOL = 0.3  # px, TVL1_REALTIME / DIS_REALTIME inner median
LAYERED_MARGIN = 16  # px cropped per side in layered scoring (tests/test_layered_motion.py)
# good_features on the card vs the CPU: the same float32 ops in the same
# order, but torch's CPU sqrt is 1 ulp off (not correctly rounded), so the
# scores may differ by a few ulp; the points must be equal
GF_SCORE_RTOL = 1e-6
TRACK_TOL = 0.35           # px, tracked point vs p0 + t (2, 1) (tests/test_tracking.py)
# px from the border: LK's zero-padded windows (a 15x15 window at the fifth
# level spans 240 px of level 0) bias the flow near the edges, in the JAX
# package alike, so the translation check is held on points this far inside
TRACK_MARGIN = 64

# Peak rates of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s and
# FP32 operations/s outside the tensor cores.  Special-function results
# (exp2, rsqrt) run 16 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instructions, compute capability 9.0), at the clock implied by
# the FP32 peak over 132 SMs x 128 FP32 lanes x 2 operations per FMA.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * FP32_OPS_PER_S / (132 * 128 * 2)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def err_stats(got, want) -> dict:
    a = got.detach().double().cpu().numpy()
    b = want.detach().double().cpu().numpy()
    require(a.shape == b.shape, f"shape {a.shape} vs {b.shape}")
    require(np.isfinite(a).all(), "kernel output not finite")
    require(np.isfinite(b).all(), "plain output not finite")
    d = np.abs(a - b)
    return {
        "max": float(d.max()),
        "median": float(np.median(d)),
        "p99": float(np.percentile(d, 99)),
        "p999": float(np.percentile(d, 99.9)),
    }


def textured_pair(h: int, w: int, seed: int):
    """Two frames of a textured scene plus a smooth flow field of up to
    ~20 px that sends border pixels out of the image."""
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    fr = synthetic_sequence(2, h, w, velocity=(3.0, -2.0), period=13, seed=seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u = 20.0 * np.sin(2 * np.pi * ys / h) * np.cos(np.pi * xs / w)
    v = 15.0 * np.cos(2 * np.pi * xs / w) * np.sin(np.pi * ys / h) - 4.0
    flow = np.stack([u, v], -1).astype(np.float32)
    return fr[0].astype(np.float32), fr[1].astype(np.float32), flow


def fill_scene(b: int, h: int, w: int, kind: str, seed: int):
    """A random flow (b, h, w, 2) and an occlusion mask (b, h, w): random
    disks ("blobs") or occluded stripes 3 px wide every 12 px ("stripes",
    every tile active), with a NaN and -0.0 under the mask and a NaN at a
    kept pixel."""
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 2, (b, h, w, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    occ = np.zeros((b, h, w), bool)
    if kind == "stripes":
        occ[:] = (xx // 3) % 4 == 0
    else:
        for i in range(b):
            for _ in range(60):
                cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 20)
                occ[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    under = np.argwhere(occ)
    flow[tuple(under[0])] = [np.nan, 1.0]
    flow[tuple(under[1])] = [-0.0, -0.0]
    flow[tuple(under[len(under) // 2])] = [-0.0, 2.0]
    kept = np.argwhere(~occ)
    flow[tuple(kept[len(kept) // 3])] = [0.5, np.nan]
    return flow, occ


def fill_active_tiles(occ, wt: int, t: int) -> tuple[int, int]:
    """(sweep tiles that run, all sweep tiles) in a launch of the occlusion
    fill on an (H, W) mask: a t x t output tile runs when a wt x wt block of
    the weights launch under it holds an occluded pixel."""
    o = np.asarray(occ.cpu())
    h, w = o.shape
    fh, fw = -(-h // wt), -(-w // wt)
    padded = np.zeros((fh * wt, fw * wt), bool)
    padded[:h, :w] = o
    flags = padded.reshape(fh, wt, fw, wt).any(axis=(1, 3))
    active = sum(bool(flags[y // wt:(min(y + t, h) - 1) // wt + 1,
                            x // wt:(min(x + t, w) - 1) // wt + 1].any())
                 for y in range(0, h, t) for x in range(0, w, t))
    return active, -(-h // t) * -(-w // t)


def scene_frames(h: int, w: int) -> list:
    """Eight serving-loop frames: a (2, 1) px/frame translation, a scene cut
    at frame 5 (another texture, seed and motion), a dropped frame at 7."""
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    a = synthetic_sequence(5, h, w, velocity=(2.0, 1.0), seed=0)
    b = synthetic_sequence(2, h, w, velocity=(-1.0, 1.5), period=23, seed=1)
    return [*a, *b, None]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# about 11 ms of SM clock: longer than the host takes to enqueue the calls
# of one timed run, plain versions included
DEVICE_PAD_CYCLES = 20_000_000


def cuda_ms(fn, reps: int, inner: int = 1, warmup: int = 3, device: bool = False) -> float:
    """Median over ``reps`` of the ms per call of ``inner`` back-to-back calls
    between two CUDA events: the host enqueue time included where it exceeds
    the device's, or with ``device`` the device's alone (the card waits in a
    sleep kernel until the host has enqueued the calls)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device:
            torch.cuda.synchronize()
            torch.cuda._sleep(DEVICE_PAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def inner_median(flow, margin: int = 64):
    return flow[margin:-margin, margin:-margin].reshape(-1, 2).median(dim=0).values.cpu().numpy()


# --- the least time for each kernel's work --------------------------------


def _nonzero(mask) -> int:
    return int(np.count_nonzero(mask))


def _taps_in_image(n: int, r: int, row0: int = 0, h_global: int | None = None) -> int:
    """Sum over the n positions of one axis of the window taps inside the
    image: the axis itself, or for a band the global rows [0, h_global),
    positions outside the image taking none."""
    hg = n if h_global is None else h_global
    return sum(min(y + r, hg - 1) - max(y - r, 0) + 1
               for y in range(row0, row0 + n) if 0 <= y < hg)


def _gradient_ops(temporal_kernel: str) -> int:
    """Ops per pixel of Sobel Ix, Iy (6 taps each) and It over the frame
    difference: one multiply per tap, the adds between them."""
    from cuda_optical_flow_2_torch.constants import MASKS

    t = _nonzero(MASKS[temporal_kernel])
    return 2 * 11 + 1 + (2 * t - 1)


def work(name: str, args, kw) -> tuple[float, float, float]:
    """(bytes, FP32 operations, special-function operations) that the call
    ``name(*args, **kw)`` must do: each input read once, each output written
    once, the arithmetic of the function on these inputs."""
    if name in ("lk_residual", "lk_level_step", "lk_band_step"):
        prev, cfg = args[0], args[4 if name == "lk_band_step" else -1]
        px = prev.numel()
        centered = kw.get("centered", False)
        planes = 9 if centered else 5  # centered: + Ix, Iy, It and the count
        window = planes * 2 * (2 * cfg.window - 1)  # row and column passes
        ops = _gradient_ops(cfg.temporal_kernel) + 5 + window + 12  # products, sums, solve
        if centered:
            ops += 16  # max(n, 1) and S_ab - S_a S_b / n five times; one division
        sfu = float(px) if centered else 0.0
        if name == "lk_residual":
            return 16.0 * px, float(ops * px), sfu
        if kw.get("flow_half"):
            # the flow read at a quarter size (2 bytes per pixel), upsampled:
            # per channel three 0.75/0.25 blends (3 each) and the doubling
            return 18.0 * px, float((ops + 23 + 20) * px), sfu
        # + clamp (4), sample coordinates (2), bilinear weights and taps (15), accumulate (2)
        return 24.0 * px, float((ops + 23) * px), sfu
    if name in ("tvl1_relax", "tvl1_relax_band"):
        px = args[0].numel()
        it = kw["iterations"]
        # constants: Sobel pair (22), |g|^2 (3), threshold and floor (2), it (1);
        # per iteration 46: rho (6), compares (2), threshold step (8),
        # divergences (6), primal (4), forward differences (4), norms (8),
        # dual updates (8); special functions per iteration: the step's two
        # divisions, four by the norms, two square roots.  Bytes: the frames
        # and the flows (32 per pixel); the band entry reads and writes the
        # six state planes instead of a flow in and out (+32)
        nbytes = (32.0 if name == "tvl1_relax" else 64.0) * px
        return nbytes, float((28 + 46 * it) * px), float(8 * it * px)
    if name in ("warp_bilinear_select", "warp_bilinear_select_band"):
        img = args[0]
        return 16.0 * img.numel(), 21.0 * img.numel(), 0.0
    if name == "pyr_down":
        x = args[0]
        out_px = x.numel() // x.shape[-1] // x.shape[-2] * (x.shape[-2] // 2) * (x.shape[-1] // 2)
        return 4.0 * x.numel() + 4.0 * out_px, 17.0 * out_px, 0.0
    if name in ("bilateral_kernel", "bilateral_kernel_band"):
        img = args[0]
        if name == "bilateral_kernel":
            window, guide, row0, hg = args[1], (args[4] if len(args) > 4 else None), 0, None
        else:
            window, guide, (row0, hg) = args[3], None, args[1:3]
        h, w = img.shape[-2:]
        r = window // 2
        planes = img.numel() // (h * w)
        cols = _taps_in_image(w, r)
        # the outputs inside the global image, and the in-image taps they
        # take (centres included): all of them, and those on another output
        rows = max(0, min(row0 + h, h if hg is None else hg) - max(row0, 0))
        px = planes * rows * w
        taps = planes * _taps_in_image(h, r, row0, hg) * cols
        inner = planes * _taps_in_image(rows, r) * cols
        # a range weight is symmetric in its pair (k^2 and the spatial taps
        # are), so one exp for each unordered pair of distinct pixels:
        # output-output pairs once, output-halo pairs once; none for a centre
        pairs = (inner - px) // 2 + (taps - inner)
        read = img.element_size() * img.numel() + (0 if guide is None else 4 * guide.numel())
        # per pair: difference, square (the guide pre-scaled once per pixel);
        # per tap but the centre: spatial product, FMA (2), add; per centre:
        # FMA (2), add; per output: the pre-scale; special functions: the
        # pairs' exps and one divide per output
        ops = 2 * pairs + 4 * (taps - px) + 3 * px + px
        return float(read + 4 * img.numel()), float(ops), float(pairs + px)
    if name == "poly_expansion_kernel":
        f, n = args[0], args[1]
        # 3 vertical and 6 horizontal multiply-adds per tap, 30 of mixing
        return 24.0 * f.numel(), float((18 * n + 60) * f.numel()), 0.0
    if name == "window_solve":
        px, window = args[0].numel(), args[5]
        # two box passes over five planes, then det, numerators, one divide
        return 28.0 * px, float((10 * (window - 1) + 12) * px), 0.0
    if name == "upsample_flow":
        # the coarse flow read once, the fine flow written once; per value
        # two products and a sum on each axis (rows, then columns), then x 2
        (h, w), (th, tw) = args[0].shape[-3:-1], args[1]
        n = args[0].numel() // (2 * h * w)
        return 8.0 * n * (h * w + th * tw), float(n * (6 * 2 * h * w + 6 * th * tw + 2 * th * tw)), 0.0
    if name == "median_filter_kernel":
        # a selection: each plane element read once and written once; the
        # network's exchanges depend on the algorithm and are not counted
        return 8.0 * args[0].numel(), 0.0, 0.0
    if name in ("fb_level_step", "fb_band_step"):
        nxt = args[0]
        cfg, i_first = (args[3], 4) if name == "fb_level_step" else (args[4], 6)
        first = args[i_first] if len(args) > i_first else kw.get("first", False)
        px = nxt.numel()
        # expansion, products (32), box passes over five planes, solve (12),
        # and unless first the clipped four-tap warp (21)
        ops = (18 * cfg.poly_n + 60) + 32 + 10 * (cfg.winsize - 1) + 12 + (0 if first else 21)
        return (32.0 if first else 40.0) * px, float(ops * px), 0.0
    if name == "fill_occluded_flow_kernel":
        occ = args[1]
        it = args[2] if len(args) > 2 else kw.get("iterations", 96)
        px, n_occ = occ.numel(), int(occ.sum())
        # bytes: the flow (8), the mask (1) and the output (8) per pixel.
        # Operations: the weights at every pixel, four blur rounds (12 each),
        # the two stencils (8), the norm (4), the projection (3), clip and
        # scale (3), the trust weight (2), the state (2): 70, with a square
        # root, a division and an exp; then per sweep at each occluded pixel
        # alone (the others keep their state), three averages (9 each), the
        # test and the weight floor: 29, with two divisions
        return 17.0 * px, float(70 * px + 29 * it * n_occ), float(3 * px + 2 * it * n_occ)
    if name in ("hs_relax", "hs_relax_band"):
        prev, _nxt, flow_init = args[:3]
        px = prev.numel()
        ops = _gradient_ops(kw["temporal_kernel"])
        it = kw["iterations"] if name == "hs_relax" else kw["sweeps"]
        sfu = 0
        if kw.get("robust") is None:
            ops += 4 + 27 * it  # denominator; per sweep two averages (18), rate (5), update (4)
        else:
            from cuda_optical_flow_2_torch.kernels.hs_sweep import MAX_SWEEPS

            chunks = math.ceil(it / MAX_SWEEPS)
            # per chunk: weights, normalizers (49, two rsqrt); per sweep: four
            # averages and two products (38), combine (8), rate (6), update (4)
            ops += 49 * chunks + 56 * it
            sfu = 2 * chunks * px
        read = 8 * px + (0 if flow_init is None else 8 * px)
        if kw.get("it_offset") is not None:
            read += 4 * px
            ops += 1
        return float(read + 8 * px), float(ops * px), float(sfu)
    raise KeyError(name)


def bound(name: str, args, kw) -> tuple[float, str]:
    """(least ms for the work of ``name(*args, **kw)``, "bytes" or "operations")."""
    nbytes, ops, sfu = work(name, args, kw)
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "operations": max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


# --- profile ----------------------------------------------------------------


# late in a long run the profiler can lose the first device events of a
# trace (a few in phase 10, most of a graph replay once in phase 8n), while
# a short process loses none.  So each trace brackets the calls with two
# spin kernels, and those with runs of tiny lead kernels: a trace whose
# spins both arrived, each with a lead kernel kept on its outer side, holds
# every event between them.  One that does not is taken again with twice the
# leads, which the later traces keep.
PROFILE_PAD_S = 0.05  # host wait at each end of a trace
PROFILE_MARK_CYCLES = 100_000  # about 50 us of SM clock
PROFILE_LEAD = 64  # the first run of lead kernels at each end
PROFILE_TRIES = 7  # leads up to 64 x 2**6
profile_lead = PROFILE_LEAD
lost_traces = 0  # traces taken again because a spin or its leads were lost


def sync_all() -> None:
    """Wait for every card."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def traced(fn, calls: int) -> tuple[list, float]:
    """The device events ``(start_us, end_us, name, card)`` of ``calls``
    calls of ``fn`` in time order, every card's, and the host's wall seconds
    for those calls (every card awaited), from a trace whose two spins (on
    the current card) arrived with a lead kernel outside each (after one
    unprofiled call)."""
    global lost_traces, profile_lead
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all()
    lead = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(profile_lead):
                lead.add_(1)
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
            sync_all()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync_all()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
            for _ in range(profile_lead):
                lead.add_(1)
            sync_all()
            time.sleep(PROFILE_PAD_S)
        dev = sorted((e.time_range.start, e.time_range.end, e.name, e.device_index)
                     for e in prof.events() if e.device_type == DeviceType.CUDA)
        spins = [i for i, (_, _, name, _) in enumerate(dev) if "spin_kernel" in name]
        if len(spins) == 2 and spins[0] > 0 and spins[1] < len(dev) - 1:
            return dev[spins[0] + 1:spins[1]], wall
        lost_traces += 1
        print(f"profiler trace lost events ({len(dev)} device events, spins at {spins}, "
              f"{profile_lead} lead kernels at each end); tracing again with twice the leads",
              file=sys.stderr)
        profile_lead *= 2
    raise CheckFailed(f"the profiler lost events in {PROFILE_TRIES} traces in a row")


def profiler_note() -> str:
    """The traces taken again so far and the leads the traces use now."""
    return f"{lost_traces} traces taken again for lost events, {profile_lead} lead kernels now"


def profile_path(fn, pairs: int) -> dict:
    """torch.profiler over ``pairs`` calls: device busy ms per pair (merged
    kernel and copy intervals), wall ms per pair under the profiler, device
    operations per pair, and the three kernels with the most device time."""
    dev, wall = traced(fn, pairs)
    busy, end = 0.0, -math.inf
    by_name: dict[str, float] = {}
    for s, e, name, _ in dev:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {
        "device_ms": busy / 1e3 / pairs, "wall_ms": wall * 1e3 / pairs,
        "ops_per_pair": len(dev) / pairs,
        "top": [(name[:60], ms / 1e3 / pairs) for name, ms in top],
    }


# --- phase 8l: the reference-exact profiles and the four command-line tools --

# compat: the CPU profile's sums are exact integers and its solve float64, so
# the card and the CPU agree to float64 rounding; the GPU profile's float32
# window sums are held at tests/test_compat.py's 2e-3 (rtol and atol)
COMPAT_CPU_TOL = 1e-9
COMPAT_GOLDEN_CPU_TOL = 1e-6  # tests/test_golden.py
COMPAT_GPU_TOL = 2e-3
CLI_EPE_TOL = 1e-3  # px, a tool's EPE on the kernel path vs the same run with --no-pallas
# A benchmark run has found the motion when its plain path's EPE is under
# this share of it. FB and TV-L1 at config 4 do not: five levels alias its
# period-24 texture (plain path EPE: FB 28.40 px on the card and the CPU,
# TV-L1 33.96 on the card and 26.56 on the CPU; the JAX package's XLA twin
# on the CPU 28.25 and 33.97). Float-order differences move a diverged flow
# by whole pixels, so those runs' kernel-vs-plain EPE is printed, not held.
CONVERGED = 0.5
BENCH_KEYS = {"config", "name", "fps", "ms_per_frame", "epe_vs_truth"}
FILL_EPE_MOVE = 0.05  # px, tests/test_evaluate.py:757-763
BENCH_ITERS = 10
# The kernel each stage of a stage report runs once, for the rows of its
# "kernel" and "banded" backends: ("max", limit) or ("median/p99.9", (m, p)).
# The "level", DIS "search" and "refine" and end-to-end "flow" rows compose
# several launches (iterations, a warp and a relaxation, levels) and are held
# to the path limits.
STAGE_KERNEL = {
    "residual": "lk_residual", "warp": "warp_bilinear_select", "expand": "poly_expansion_kernel",
    "window_solve": "window_solve",
}


def stage_limits(family: str, stage: str):
    if stage in ("level", "search", "refine", "flow"):
        return "median/p99", (PATH_MEDIAN_ERR, PATH_P99_ERR)
    if stage == "sweeps":
        name = "tvl1_relax" if family == "TVL1Config" else "hs_relax"
    else:
        name = STAGE_KERNEL.get(stage)
    if name is None:
        return None, None  # gradients, window sums, solve: no kernel runs them
    if name == "warp_bilinear_select":
        return "max", WARP_MAX_ERR
    if name == "poly_expansion_kernel":
        # |d| <= POLY_ATOL implies |d| <= POLY_ATOL + POLY_RTOL |plain|
        return "max", POLY_ATOL
    return "median/p99.9", {
        "lk_residual": (LK_MEDIAN_ERR, LK_P999_ERR),
        "window_solve": (WIN_SOLVE_MEDIAN_ERR, WIN_SOLVE_P999_ERR),
        "hs_relax": (HS_MEDIAN_ERR, HS_P999_ERR),
        "tvl1_relax": (TVL1_MEDIAN_ERR, TVL1_P999_ERR),
    }[name]


def run_cli(main_fn, argv: list) -> tuple[str, float]:
    """A tool's ``main(argv)`` with its standard output captured: (output,
    wall seconds, the card synchronized at the end)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def json_records(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def phase_8l(of, dev, run_path, big, card: str) -> dict:
    """Drive the compat profiles, the benchmark, evaluate, diff and demo
    tools on the card; print one line per check; return the numbers phase
    9 prints beside its own."""
    import shutil
    import tempfile

    import torch

    from cuda_optical_flow_2_torch.cli import benchmark as cli_bench
    from cuda_optical_flow_2_torch.cli import demo as cli_demo
    from cuda_optical_flow_2_torch.cli import diff as cli_diff
    from cuda_optical_flow_2_torch.cli import evaluate as cli_eval
    from cuda_optical_flow_2_torch.constants import DX_3X3, DY_3X3, GAUS_KERNEL_3X3
    from cuda_optical_flow_2_torch.models import compat
    from cuda_optical_flow_2_torch.utils import debug, native, profiling
    from cuda_optical_flow_2_torch.utils import io as uio
    from cuda_optical_flow_2_torch.utils import viz

    out: dict = {}

    def cuda(a):
        return torch.as_tensor(a, device=dev)

    def close(got, want, tol, what):
        """NaN/inf patterns equal, the rest within tol (rtol and atol)."""
        g, w = got.double().cpu(), want.double().cpu()
        fg, fw = torch.isfinite(g), torch.isfinite(w)
        require(torch.equal(fg, fw) and torch.equal(g[~fg].nan_to_num(7.0), w[~fw].nan_to_num(7.0)),
                f"{what}: NaN/inf patterns differ")
        d = (g[fg] - w[fw]).abs()
        excess = float((d - tol * w[fw].abs()).max()) if d.numel() else 0.0
        require(excess <= tol, f"{what}: |d| - tol |want| {excess} > {tol}")
        return float(d.max()) if d.numel() else 0.0

    # -- compat: the golden pair, then 480x640 and 1080x1920 against the CPU
    golden = ROOT / "tests" / "golden"
    gp, gn = (np.load(golden / f"pair_{s}.npy") for s in ("prev", "next"))
    parts = []
    for profile in ("cpu", "gpu"):
        flows, counts = run_path(f"compat {profile} golden 64x64", lambda: compat.pyramidal_lk_exact(
            cuda(gp), cuda(gn), levels=4, profile=profile), ())
        require(not counts, f"compat launched {counts}")
        worst = 0.0
        for k, f in enumerate(flows):
            want = np.load(golden / f"{profile}_flow_L{k}.npy")
            got = f.cpu().numpy()
            finite = np.isfinite(want).all(axis=-1)
            require(np.array_equal(finite, np.isfinite(got).all(axis=-1)),
                    f"compat {profile} golden level {k}: finite patterns differ")
            tol = COMPAT_GOLDEN_CPU_TOL if profile == "cpu" else COMPAT_GPU_TOL
            d = np.abs(got[finite] - want[finite])
            require(bool((d <= tol + tol * np.abs(want[finite])).all()),
                    f"compat {profile} golden level {k}: max |d| {d.max()}")
            worst = max(worst, float(d.max()) if d.size else 0.0)
        parts.append(f"{profile} profile max |d| {worst:.3g}")
    print("phase 8l compat pyramidal_lk_exact vs tests/golden (4 levels, 64x64): "
          + "; ".join(parts) + "; no kernel launched")

    for h, w in ((480, 640), (1080, 1920)):
        fr = synthetic_sequence_rgb(h, w)
        (pc, nc), (pcpu, ncpu) = [cuda(f) for f in fr], [torch.as_tensor(f) for f in fr]
        pyr_g, pyr_c = compat.build_pyramid_u8(pc, 4), compat.build_pyramid_u8(pcpu, 4)
        require(all(torch.equal(a.cpu(), b) for a, b in zip(pyr_g, pyr_c)),
                f"compat {h}x{w}: uint8 pyramids differ from the CPU run")
        npyr_g, npyr_c = compat.build_pyramid_u8(nc, 4), compat.build_pyramid_u8(ncpu, 4)
        for k in range(4):
            sums = []
            for pp, nn in ((pyr_g[k], npyr_g[k]), (pyr_c[k], npyr_c[k])):
                ix = compat.conv_3ch_to_1ch_u8(pp, DX_3X3)
                iy = compat.conv_3ch_to_1ch_u8(pp, DY_3X3)
                it = compat.sub_arr_u8(compat.conv_3ch_to_1ch_u8(nn, GAUS_KERNEL_3X3),
                                       compat.conv_3ch_to_1ch_u8(pp, GAUS_KERNEL_3X3))
                sums.append([compat.srm_1ch_i32(a, b, 9).cpu()
                             for a, b in ((ix, ix), (iy, iy), (ix, iy), (ix, it), (iy, it))])
            require(all(torch.equal(a, b) for a, b in zip(*sums)),
                    f"compat {h}x{w} level {k}: int32 window sums differ from the CPU run")
        parts = []
        for profile, tol in (("cpu", COMPAT_CPU_TOL), ("gpu", COMPAT_GPU_TOL)):
            fg, counts = run_path(f"compat {profile} {h}x{w}", lambda: compat.pyramidal_lk_exact(
                pc, nc, levels=4, profile=profile), ())
            require(not counts, f"compat launched {counts}")
            fc = compat.pyramidal_lk_exact(pcpu, ncpu, levels=4, profile=profile)
            worst = max(close(a, b, tol, f"compat {profile} {h}x{w} level {k}")
                        for k, (a, b) in enumerate(zip(fg, fc)))
            nonfinite = int((~torch.isfinite(fc[0])).any(-1).sum())
            ms = cuda_ms(lambda: compat.pyramidal_lk_exact(pc, nc, levels=4, profile=profile), 5)
            out[f"compat {profile} {h}x{w}"] = ms
            parts.append(f"{profile} profile max |d| {worst:.3g} (limit {tol:g}), "
                         f"{nonfinite} non-finite pixels at level 0 as on the CPU, {ms:.3f} ms")
        print(f"phase 8l compat {h}x{w} 4 levels vs a CPU run: uint8 pyramids and int32 sums "
              f"torch.equal; " + "; ".join(parts) + f" [{card}]; no kernel launched")

    # -- benchmark: every config on LK, config 4 on the other families
    def bench(model: str, idx: int) -> None:
        spec = cli_bench.CONFIGS[idx]
        cfg = cli_bench._model_cfg(model, spec["cfg"], False)
        label = f"benchmark config {idx} {model}"
        (text, _secs), counts = run_path(label, lambda: run_cli(cli_bench.main, [
            "--configs", str(idx), "--model", model, "--iters", str(BENCH_ITERS)]), ())
        (rec,) = json_records(text)
        (ptext, _), pcounts = run_path(label + " plain", lambda: run_cli(cli_bench.main, [
            "--configs", str(idx), "--model", model, "--iters", "1", "--no-pallas"]), ())
        require(not pcounts, f"{label} --no-pallas launched {pcounts}")
        (prec,) = json_records(ptext)
        # one direct call on the CLI's inputs: the CLI launches its calls' kernels and no more
        fn, args, _frames = cli_bench.config_call(dict(spec, cfg=cfg), dev)
        _, direct = run_path(label + " direct", lambda: fn(*args), ())
        timed = max(BENCH_ITERS // 4, 2) if spec.get("batch") else BENCH_ITERS
        calls = profiling.WARMUP + timed + 1
        require(direct and counts == {k: v * calls for k, v in direct.items()},
                f"{label}: launches {counts}, {calls} calls of a direct call's {direct}")
        for r in (rec, prec):
            require(math.isfinite(r["epe_vs_truth"]) and r.keys() == BENCH_KEYS,
                    f"{label}: record {r}")
        motion = math.hypot(*spec["velocity"])
        converged = prec["epe_vs_truth"] < CONVERGED * motion
        if converged:
            d = abs(rec["epe_vs_truth"] - prec["epe_vs_truth"])
            require(d <= CLI_EPE_TOL, f"{label}: EPE {rec} vs --no-pallas {prec}")
            held = f"within {CLI_EPE_TOL} px"
        else:
            held = (f"not held: the estimate diverges on both paths (EPE over "
                    f"{CONVERGED:g} of the {motion:.2f} px motion)")
        out[label] = rec["ms_per_frame"]
        print(f"phase 8l {label} ({rec['name']}): {rec['ms_per_frame']:.3f} ms/call, "
              f"{rec['fps']:.2f} fps [{card}]; EPE {rec['epe_vs_truth']:.4f} px, --no-pallas "
              f"{prec['epe_vs_truth']:.4f} ({prec['ms_per_frame']:.3f} ms/call), {held}; "
              f"launches per call {direct} = a direct call's ({calls} calls)")

    for idx in (1, 2, 3, 4, 5):
        bench("lk", idx)
    for model in ("hs", "fb", "tvl1", "dis"):
        bench(model, 4)

    tmp = Path(tempfile.mkdtemp(prefix="of2_chip_smoke_"))
    try:
        # -- evaluate: a Sintel tree of two synthetic sequences and the disk scene
        full, disk = tmp / "sintel", tmp / "disk"
        seqs = {
            "seq_a": (uio.synthetic_sequence(5, 1080, 1920, velocity=(2.0, 1.0), period=48),
                      (2.0, 1.0)),
            "seq_b": (uio.synthetic_sequence(5, 1080, 1920, velocity=(-1.0, 1.5), period=48,
                                             seed=1), (-1.0, 1.5)),
        }
        for seq, (frames, v) in seqs.items():
            (full / "final" / seq).mkdir(parents=True)
            (full / "flow" / seq).mkdir(parents=True)
            truth = np.full((1080, 1920, 2), v, np.float32)
            for t, f in enumerate(frames):
                np.save(full / "final" / seq / f"frame_{t + 1:04d}.npy", f)
                if t < len(frames) - 1:
                    uio.write_flo(str(full / "flow" / seq / f"frame_{t + 1:04d}.flo"), truth)
        for root in (full, disk):
            for sub in ("final", "flow", "occ"):
                (root / sub / "disk").mkdir(parents=True)
            for t, f in enumerate((big.prev, big.nxt), start=1):
                np.save(root / "final" / "disk" / f"frame_{t:04d}.npy", f.astype(np.float32))
            uio.write_flo(str(root / "flow" / "disk" / "frame_0001.flo"), big.flow)
            viz.write_png(str(root / "occ" / "disk" / "frame_0001.png"),
                          (big.occ * 255).astype(np.uint8))

        lk_needs = ("lk_residual", "lk_level_step", "pyr_down")
        tvl1_needs = ("pyr_down", "warp_bilinear_select", "tvl1_relax", "median_filter_kernel")
        runs = {
            "lk preset paper_1080p": ([full, "--model", "lk", "--preset", "paper_1080p"], lk_needs),
            "tvl1_realtime disk": ([disk, "--preset", "tvl1_realtime"], tvl1_needs),
            "tvl1_realtime disk fill": ([disk, "--preset", "tvl1_realtime", "--fill-occlusions"],
                                        tvl1_needs + ("fill_occluded_flow_kernel",)),
            "streaming warm levels=1 recover 3": (
                [full, "--streaming", "--warm-start", "--levels", "1", "--recover-levels", "3"],
                ("lk_residual", "lk_level_step", "pyr_down", "warp_bilinear_select")),
            "dis": ([full, "--model", "dis"], ("pyr_down", "lk_residual", "lk_level_step",
                                               "warp_bilinear_select", "hs_relax")),
        }
        summaries = {}
        for label, (argv, needs) in runs.items():
            argv = ["--dataset", str(argv[0]), *argv[1:]]
            (text, secs), counts = run_path(f"evaluate {label}", lambda: run_cli(
                cli_eval.main, argv), needs)
            (ptext, _), pcounts = run_path(f"evaluate {label} plain", lambda: run_cli(
                cli_eval.main, [*argv, "--no-pallas"]), ())
            require(not pcounts, f"evaluate {label} --no-pallas launched {pcounts}")
            agg, pagg = json_records(text)[-1], json_records(ptext)[-1]
            require(agg["pairs"] == agg["pairs_with_truth"] == pagg["pairs"] > 0,
                    f"evaluate {label}: {agg}")
            keys = [k for k in ("epe_mean", "epe_matched", "epe_unmatched") if k in agg]
            # the summary's EPE and the matched split are held; at occluded
            # pixels TV-L1 has no data term and float order flips near-tied
            # decisions (phase 8k), so the unmatched split is printed
            for key in ("epe_mean", "epe_matched"):
                if key in agg:
                    require(abs(agg[key] - pagg[key]) <= CLI_EPE_TOL,
                            f"evaluate {label} {key}: {agg[key]} vs --no-pallas {pagg[key]}")
            summaries[label] = agg
            out[f"evaluate {label}"] = 1e3 * secs / agg["pairs"]
            print(f"phase 8l evaluate {label} ({agg['layout']}, {agg['pairs']} pairs at "
                  f"1080x1920): {1e3 * secs / agg['pairs']:.1f} ms/pair wall with the host's "
                  f"decode and scoring [{card}]; " + ", ".join(
                      f"{k} {agg[k]:.4f} (--no-pallas {pagg[k]:.4f})" for k in keys)
                  + f"; launches {counts}")
        raw, fill = summaries["tvl1_realtime disk"], summaries["tvl1_realtime disk fill"]
        require(fill["epe_unmatched"] < raw["epe_unmatched"] - FILL_EPE_MOVE
                and abs(fill["epe_matched"] - raw["epe_matched"]) < FILL_EPE_MOVE,
                f"--fill-occlusions: unmatched {raw['epe_unmatched']} -> {fill['epe_unmatched']}, "
                f"matched {raw['epe_matched']} -> {fill['epe_matched']}")
        print(f"phase 8l evaluate --fill-occlusions on the disk: EPE unmatched "
              f"{raw['epe_unmatched']:.4f} -> {fill['epe_unmatched']:.4f} (must fall by more than "
              f"{FILL_EPE_MOVE}), matched {raw['epe_matched']:.4f} -> {fill['epe_matched']:.4f} "
              f"(must move less than {FILL_EPE_MOVE}; tests/test_evaluate.py:757-763)")

        # -- diff: the stage reports of every family at 1080x1920
        fr = uio.synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48, noise=0.0)
        dp, dn = cuda(fr[0]).float(), cuda(fr[1]).float()
        diff_cfgs = {
            "LKConfig": (of.LKConfig(levels=3, window=9, window_weights="box"),
                         ("lk_residual", "lk_level_step", "warp_bilinear_select")),
            "HSConfig": (of.HSConfig(levels=3), ("hs_relax",)),
            "TVL1Config": (of.TVL1Config(levels=3), ("tvl1_relax", "median_filter_kernel")),
            "FBConfig": (of.FBConfig(levels=3), ("poly_expansion_kernel", "window_solve",
                                                 "fb_level_step", "warp_bilinear_select")),
            "DISConfig": (of.DISConfig(levels=3), ("lk_residual", "lk_level_step", "hs_relax")),
        }
        for family, (cfg, needs) in diff_cfgs.items():
            rep, counts = run_path(f"stage_report {family}", lambda: debug.stage_report(
                dp, dn, cfg, backends=("kernel", "banded", "oracle"), n_bands=3), needs)
            held = []
            for r in rep:
                kind, lim = stage_limits(family, r.stage)
                if kind is None or r.backend == "oracle":
                    continue
                if kind == "max":
                    ok = r.max_abs <= lim
                elif kind == "median/p99":
                    ok = r.median_abs <= lim[0] and r.p99_abs <= lim[1]
                else:
                    ok = r.median_abs <= lim[0] and r.p999_abs <= lim[1]
                require(ok, f"stage_report {family}: {r} median {r.median_abs} p99 {r.p99_abs} "
                            f"p99.9 {r.p999_abs} past its {kind} limit {lim}")
                held.append(r)
            lines = "; ".join(
                f"{'E2E' if r.level < 0 else f'L{r.level}'} {r.stage} {r.backend} max "
                f"{r.max_abs:.3g} p99.9 {r.p999_abs:.3g}" for r in rep)
            shard = ""
            if family != "DISConfig":
                srep, _ = run_path(f"stage_report {family} sharded", lambda: debug.stage_report(
                    dp, dn, cfg, backends=("sharded",), baseline="kernel", stages=("flow",),
                    n_bands=3), ())
                require(len(srep) == 1 and srep[0].max_abs == 0.0,
                        f"stage_report {family} sharded (3 shards) vs kernel: {srep}")
                shard = "; sharded (3 shards) vs kernel max |d| 0"
            print(f"phase 8l stage_report {family} 1080x1920 3 levels vs plain: {lines}{shard}; "
                  f"{len(held)} rows within their kernels' limits; launches {counts}")
        text, _ = run_cli(cli_diff.main, ["--model", "lk", "--size", "1080x1920", "--levels", "3",
                                          "--n-bands", "3", "--backends", "kernel", "banded",
                                          "oracle"])
        rows = text.strip().splitlines()
        require(len(rows) > 10 and all(" vs plain: max " in r for r in rows),
                f"diff printed {text[:400]}")
        print(f"phase 8l diff --model lk --size 1080x1920: {len(rows)} rows, e.g. "
              f"{rows[0].strip()}")

        # -- demo: all five models; native ingestion
        require(native.available(), "native.available() is False on the card's machine")
        demo_runs = {
            "lk --bilateral 1080x1920": (["--size", "1080x1920", "--bilateral", "--out",
                                          str(tmp / "demo_lk")],
                                         ("bilateral_kernel", "lk_residual", "lk_level_step")),
            "lk warm + recovery, native stream 1080x1920": (
                ["--size", "1080x1920", "--warm-start", "--levels", "1", "--recover-levels", "3",
                 "--native-stream", "--out-video", str(tmp / "demo_warm.y4m")],
                ("lk_level_step", "warp_bilinear_select")),
            "lk 1080x1920": (["--size", "1080x1920"], ("lk_residual", "lk_level_step")),
            **{f"{m} 480x640": (["--size", "480x640", "--model", m, "--out", str(tmp / f"demo_{m}")],
                                needs) for m, needs in (
                ("hs", ("hs_relax",)), ("fb", ("fb_level_step",)),
                ("tvl1", ("tvl1_relax", "median_filter_kernel")),
                ("dis", ("lk_residual", "hs_relax")))},
        }
        for label, (argv, needs) in demo_runs.items():
            (text, _), counts = run_path(f"demo {label}", lambda: run_cli(
                cli_demo.main, ["--synthetic", "8", *argv]), needs)
            epe = [float(line.rsplit(":", 1)[1]) for line in text.splitlines() if "EPE" in line]
            require(len(epe) == 7 and all(math.isfinite(e) for e in epe),
                    f"demo {label}: EPE lines {text[:400]}")
            fps = float(text.strip().splitlines()[-1].split("(")[1].split()[0])
            if "--out" in argv:
                files = os.listdir(argv[argv.index("--out") + 1])
                require(sum(f.startswith("flow") for f in files) == 7
                        and sum(f.startswith("arrows") for f in files) == 7,
                        f"demo {label} wrote {sorted(files)}")
            if "--out-video" in argv:
                require(len(list(uio.read_y4m(argv[argv.index("--out-video") + 1]))) == 7,
                        f"demo {label}: the flow video does not hold 7 frames")
            out[f"demo {label}"] = fps
            print(f"phase 8l demo {label} (8 frames): EPE {min(epe):.3f}-{max(epe):.3f} px, "
                  f"{fps:.1f} fps end to end with the host's I/O [{card}]; artifacts written; "
                  f"launches {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def synthetic_sequence_rgb(h: int, w: int) -> list:
    """Two (H, W, 3) uint8 frames of a translating texture, a different
    plane in each channel (the compat profiles read channel 0 and decimate
    all three)."""
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    fr = synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=24)
    return [np.stack([f, 255 - f, f // 2], -1) for f in fr]


# --- phase 8m: the examples, gradients through the plain path, multihost -----

# |d| / max |g|: the card's gradient against a CPU run of the same port code
# (the index backward accumulates in another order on the card), held at
# the max where the gradient is continuous in float order.  Two defaults
# are not (an H100 80GB HBM3, 700 W, against this script's CPU run):
# - TV-L1's gradient follows discrete choices (the threshold step's
#   branch, which input of a median window's tie takes the gradient) that
#   a float-order difference flips: TVL1Config() at 135x240 showed median
#   3.1e-6, p99 2.6e-4, max 1.8e-2, so it is held at the median; the JAX
#   test's config (tests/test_differentiability.py) at 1080x1920 showed
#   max 1.4e-6 and is held at the max;
# - DIS's mean-normalized data term sums its windows by cumsum down 1080
#   rows, which the card and the CPU associate differently (the flow: max
#   1.2e-4 px apart): DISConfig() showed median 2.2e-7, p99 5.1e-5, max
#   2.1e-2 and is held at the p99; with mean_normalize=False the flows are
#   equal and the gradient's max is 1.2e-7, held at the max
GRAD_REL_ERR = 1e-4
# TVL1Config()'s forward and backward take minutes on the CPU at 1080x1920
GRAD_CPU_TVL1_SHAPE = (135, 240)
MULTIHOST_PAIRS = 4
MULTIHOST_TIMEOUT = 300  # s, for both worker processes


def example_launches(n_cards: int) -> dict[str, dict[str, int]]:
    """The launches of each example's ``main(device="cuda")``, from PERF.md's
    launch rules: an LK pair of L levels is L - 1 ``pyr_down`` (the stacked
    pair, or the new frame when streaming), one ``lk_residual`` at a cold
    coarsest level and one ``lk_level_step`` per other level, each level
    ``iterations`` passes; an FB image pair is L - 1 ``pyr_down``, L
    expansions and L x iterations steps; a downsampled flow one
    ``pyr_down`` per plane per level; every pyramid of L levels L - 1
    ``upsample_flow`` handoffs."""
    return {
        "basic": {"pyr_down": 3, "lk_residual": 1, "lk_level_step": 3, "upsample_flow": 3},
        # cold LKConfig(levels=3) over 10 frames: 2 pyr_down per frame, 9 pairs
        "streaming_video": {"pyr_down": 20, "lk_residual": 9, "lk_level_step": 18,
                            "upsample_flow": 18},
        # warm levels=1, 120 flows: the first pair cold, then one step each
        "live_stream": {"lk_residual": 1, "lk_level_step": 119},
        # 9 pairs twice, iterations=2.  Plain warm: residual + step, then 2
        # steps per pair.  Recovery (levels=3): a cold 3-level solve (1
        # residual + 5 steps) at the first pair and at the two pairs after
        # the cut, 2 steps at the other six; one check warp per warm pair;
        # pyr_down 4 at the first pair (both frames' 2 levels), 6 at each
        # later pair (the frame's 2 levels, the seed's 2 levels x 2 planes);
        # 2 handoffs in each of the 3 cold solves
        "scene_cut_recovery": {"lk_residual": 4, "lk_level_step": 44, "pyr_down": 52,
                               "warp_bilinear_select": 8, "upsample_flow": 6},
        # FBConfig(levels=3, iterations=2): 2 pyr_down, 3 expansions and 6
        # steps per flow, two flows; one cycle warp per fb_consistency
        "flow_quality": {"pyr_down": 4, "poly_expansion_kernel": 6, "fb_level_step": 12,
                         "warp_bilinear_select": 1, "upsample_flow": 4},
        "frame_interpolation": {"pyr_down": 4, "poly_expansion_kernel": 6, "fb_level_step": 12,
                                "warp_bilinear_select": 2, "upsample_flow": 4},
        # two pairs per card, one batched LKConfig(levels=3) call each
        "sharded_batch": {"pyr_down": 2 * n_cards, "lk_residual": n_cards,
                          "lk_level_step": 2 * n_cards, "upsample_flow": 2 * n_cards},
        # the FB part on 3 shards, FBConfig(levels=2, iterations=2): per
        # shard 1 pyr_down, 2 expansions, 4 band steps; the LK part is plain
        "spatial_tp": {"pyr_down": 3, "poly_expansion_kernel": 6, "fb_band_step": 12},
        # the plain path only: the kernels carry no gradient
        "gradient_alignment": {},
        "learned_refinement": {},
    }


def grad_of(of, config, prev, nxt):
    """d mean(u) / d next through ``pyramidal_flow`` at a fresh leaf."""
    x = nxt.clone().requires_grad_(True)
    of.pyramidal_flow(prev, x, config)[..., 0].mean().backward()
    return x.grad


def multihost_worker(rank: int, port: int, out_dir: str) -> int:
    """One of the two processes of phase 8m's multihost run: join the gloo
    group, feed this process's half of the 4-pair batch through
    ``sharded_flow_from_local`` on the card, save the flow, print the ms
    per pair."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.parallel import multihost
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = multihost.make_global_mesh()
    per, off = multihost.host_local_batch(MULTIHOST_PAIRS, mesh)
    fr = synthetic_sequence(MULTIHOST_PAIRS + 1, 1080, 1920, velocity=(2.0, 1.0), period=48)
    prev = torch.from_numpy(np.stack(fr[off:off + per]).astype(np.float32)).to(dev)
    nxt = torch.from_numpy(np.stack(fr[off + 1:off + per + 1]).astype(np.float32)).to(dev)

    def run():
        return multihost.sharded_flow_from_local(prev, nxt, of.PAPER_1080P, mesh)

    flow = run()
    ms = cuda_ms(run, reps=10) / per
    torch.save(flow.cpu(), Path(out_dir) / f"flow{rank}.pt")
    ok = torch.ones(())
    dist.all_reduce(ok)  # both processes got here
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "pairs": per, "offset": off, "ms_per_pair": ms,
                      "processes": int(ok)}))
    print("MULTIHOST_OK", flush=True)
    return 0


def phase_8m(of, dev, run_path, prev, nxt, card: str) -> dict:
    """Run the ten examples on the card, gradients of every family at full
    width, the training steps, and two multihost processes; print one line
    per check; return the numbers."""
    import contextlib
    import importlib
    import io
    import shutil
    import socket
    import tempfile

    import torch

    from cuda_optical_flow_2_torch import parallel
    from cuda_optical_flow_2_torch.examples import EXAMPLES
    from cuda_optical_flow_2_torch.examples import gradient_alignment as align
    from cuda_optical_flow_2_torch.examples import learned_refinement as refine
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="of2_8m_")
    try:
        # the examples, each with its own asserts and printed numbers
        expect = example_launches(torch.cuda.device_count())
        for name in EXAMPLES:
            mod = importlib.import_module(f"cuda_optical_flow_2_torch.examples.{name}")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res, counts = run_path(f"example {name}",
                                       lambda: mod.main(device="cuda", out_dir=tmp),
                                       tuple(expect[name]))
            wall = time.perf_counter() - t0
            require(counts == expect[name],
                    f"example {name} launches {counts}, predicted {expect[name]}")
            printed = " | ".join(line.strip() for line in buf.getvalue().splitlines())
            print(f"phase 8m example {name} [{card}]: {wall:.2f} s wall; launches {counts} "
                  f"(as predicted); printed: {printed}")
            out[name] = res

        # gradients at full width: forward + backward of each family's plain
        # path on the card, held against a CPU run of the same code
        families = {"PAPER_1080P": of.PAPER_1080P, "HSConfig()": of.HSConfig(),
                    "FBConfig()": of.FBConfig(), "TVL1Config()": of.TVL1Config(),
                    "DISConfig()": of.DISConfig()}
        sp, sn = (torch.from_numpy(f.astype(np.float32)) for f in synthetic_sequence(
            2, *GRAD_CPU_TVL1_SHAPE, velocity=(2.0, 1.0), period=48))
        for label, cfg in families.items():
            t0 = time.perf_counter()
            plain = dataclasses.replace(cfg, use_pallas=False)
            g, counts = run_path(f"gradient {label}", lambda: grad_of(of, plain, prev, nxt), ())
            require(not counts, f"gradient {label}: the plain path launched {counts}")
            require(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                    f"gradient {label}: not finite, or zero")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            # TV-L1's call takes seconds: one timed call beside run_path's
            ms = cuda_ms(lambda: grad_of(of, plain, prev, nxt), warmup=0,
                         reps=1 if label == "TVL1Config()" else 3)
            peak = torch.cuda.max_memory_allocated(dev)
            # (config, its pair, the statistic held): GRAD_REL_ERR above
            against = {label: (plain, prev, nxt, "max")}
            if label == "TVL1Config()":
                against = {"TVL1Config()": (plain, sp, sn, "median"),
                           "TVL1Config(levels=2, warps=1, iterations=5)": (
                               of.TVL1Config(levels=2, warps=1, iterations=5, use_pallas=False),
                               prev, nxt, "max")}
            if label == "DISConfig()":
                against = {label: (plain, prev, nxt, "p99"),
                           "DISConfig(mean_normalize=False)": (
                               dataclasses.replace(plain, mean_normalize=False), prev, nxt, "max")}
            stats, cpu_fail = [], []
            for what, (c, a, b, stat) in against.items():
                gd = (g if c is plain and a is prev else grad_of(of, c, a.to(dev), b.to(dev))).cpu()
                gc = grad_of(of, c, a.cpu(), b.cpu())
                require(float(gc.abs().max()) > 0, f"gradient {what}: zero on the CPU")
                e = err_stats(gd / gc.abs().max(), gc / gc.abs().max())
                stats.append(f"{what} at {a.shape[-2]}x{a.shape[-1]}: max {e['max']:.3g} median "
                             f"{e['median']:.3g} p99 {e['p99']:.3g} p99.9 {e['p999']:.3g} "
                             f"({stat} held at {GRAD_REL_ERR})")
                if e[stat] > GRAD_REL_ERR:
                    cpu_fail.append(f"{what}: {e}")
            try:
                of.pyramidal_flow(prev, nxt.clone().requires_grad_(True), cfg)
                raised = "nothing"
            except RuntimeError as err:
                raised = str(err)
            require("carry no gradient" in raised,
                    f"gradient {label}: use_pallas=True with a grad input raised {raised}")
            out[f"gradient {label}"] = {"ms": ms, "peak_gib": peak / 2**30,
                                        "call_gib": (peak - before) / 2**30}
            print(f"phase 8m gradient {label} 1080x1920 [{card}]: forward + backward "
                  f"{ms:.3f} ms (use_pallas=False, no launch); peak {peak / 2**30:.3f} GiB "
                  f"allocated ({(peak - before) / 2**30:.3f} GiB above the "
                  f"{before / 2**30:.3f} GiB held before); max |g| {float(g.abs().max()):.4g}; "
                  f"card vs CPU |d| / max |g|, " + "; ".join(stats)
                  + f"; use_pallas=True with a grad input raised; "
                  f"{time.perf_counter() - t0:.1f} s with the CPU runs")
            require(not cpu_fail, f"gradient {label}: card vs CPU " + "; ".join(cpu_fail))
        del g, gd, gc

        # training steps
        t0 = time.perf_counter()
        ap, an = (torch.from_numpy(a).to(dev) for a in align.shifted_pair(160, 192, (3.6, -2.2)))
        params = torch.tensor([0.0, 0.0, 0.0, 0.0, -3.5, 2.1], device=dev, requires_grad=True)
        opt = torch.optim.Adam([params], lr=align.LR, betas=(0.9, 0.999), eps=1e-8)

        def adam_step():
            opt.zero_grad()
            align.photometric_loss(params, ap, an).backward()
            opt.step()

        out["adam step ms"] = cuda_ms(adam_step, reps=10, inner=10)
        rng = np.random.default_rng(3)
        pairs = [refine.make_pair(rng) for _ in range(32)]
        rp, rn, rt = (torch.from_numpy(np.stack(a)).to(dev) for a in zip(*pairs))
        coarse = of.pyramidal_lk(rp, rn, refine.CFG)
        feats = refine.features(rp, rn, coarse)
        net = refine.RefineNet(generator=torch.Generator().manual_seed(0)).to(dev)
        ropt = torch.optim.Adam(net.parameters(), lr=refine.LR, betas=(0.9, 0.999), eps=1e-8)

        def train_step():
            ropt.zero_grad()
            refine.epe(refine.refine(net, feats, coarse), rt).backward()
            ropt.step()

        out["train step ms"] = cuda_ms(train_step, reps=10, inner=5)
        lr_out = out["learned_refinement"]
        print(f"phase 8m training [{card}]: gradient_alignment {out['adam step ms']:.3f} ms per "
              f"adam step (160x192, translation error {out['gradient_alignment']['error']:.4f} px "
              f"after 400); learned_refinement {out['train step ms']:.3f} ms per train step "
              f"(32 pairs of 64x80), held-out EPE {lr_out['coarse_epe']:.4f} -> "
              f"{lr_out['refined_epe']:.4f} px after 250); {time.perf_counter() - t0:.1f} s")

        # multihost: two processes on the one card over gloo (NCCL refuses two
        # ranks on one GPU; data-parallel flow needs no collective)
        t0 = time.perf_counter()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker", str(rank),
             str(port), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        try:
            outs = [proc.communicate(timeout=MULTIHOST_TIMEOUT)[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for rank, (proc, text) in enumerate(zip(procs, outs)):
            require(proc.returncode == 0 and "MULTIHOST_OK" in text,
                    f"multihost worker {rank} failed ({proc.returncode}):\n{text[-3000:]}")
        fr = synthetic_sequence(MULTIHOST_PAIRS + 1, 1080, 1920, velocity=(2.0, 1.0), period=48)
        gp = torch.from_numpy(np.stack(fr[:-1]).astype(np.float32)).to(dev)
        gn = torch.from_numpy(np.stack(fr[1:]).astype(np.float32)).to(dev)
        want = parallel.sharded_flow(gp, gn, of.PAPER_1080P, parallel.make_mesh(devices=[dev]))
        per_proc = []
        for rank, text in enumerate(outs):
            rec = json_records(text)[-1]
            got = torch.load(Path(tmp) / f"flow{rank}.pt").to(dev)
            lo = rec["offset"]
            require(torch.equal(got, want[lo:lo + rec["pairs"]]),
                    f"multihost rank {rank}: flow not bit-equal to the single-process sharded_flow")
            per_proc.append(rec["ms_per_pair"])
        out["multihost ms per pair"] = per_proc
        print(f"phase 8m multihost [{card}]: 2 processes (gloo) on the one card, "
              f"{MULTIHOST_PAIRS} PAPER_1080P pairs at 1080x1920, each process its 2: "
              f"bit-equal to the single-process sharded_flow; ms per pair per process "
              + ", ".join(f"{ms:.3f}" for ms in per_proc) + f"; {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --- phase 8n: the captured entries (CUDA graphs) against the eager calls ----

CAPTURED_REPS = {"PAPER_1080P": 30, "PAPER_1080P fused_half_upsample": 30, "REFERENCE_GPU": 30,
                 "HSConfig() quadratic": 10, "HSConfig() charbonnier": 10, "FBConfig() image": 10,
                 "FBConfig() coeff": 10, "TVL1_REALTIME": 10, "TVL1Config()": 5,
                 "DISConfig()": 10, "DIS_REALTIME": 10}
STEP_REPS = 30


def back_to_back_ms(fn, n: int) -> float:
    """Host wall ms per call of ``n`` calls in a row, the device awaited once
    at the end (after one call outside the clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def device_names(fn) -> list:
    """The device events (kernels, copies, memsets) of one call of ``fn``,
    after one unprofiled call."""
    return [name for _, _, name, _ in traced(fn, 1)[0]]


def phase_8n(of, dev, run_path, card: str) -> dict:
    """Each path's captured entry (``pyramidal_<family>_jit``) against its
    eager entry at 1080x1920 and the entry config at 480x640, the captured
    serving loops against the eager ``_step``, autograd and a failing capture;
    print one line per check; return the numbers for PERF.md."""
    import torch

    from cuda_optical_flow_2_torch import capture
    from cuda_optical_flow_2_torch.models import dis, farneback, horn_schunck, lucas_kanade
    from cuda_optical_flow_2_torch.models import streaming, tvl1
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    def cuda(a):
        return torch.as_tensor(a, device=dev).float()

    def pairs(h, w, period):
        """The (2, 1) pair and a second pair of another scene and motion."""
        a = synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=period)
        b = synthetic_sequence(2, h, w, velocity=(-1.0, 1.5), period=period, seed=1)
        return (cuda(a[0]), cuda(a[1])), (cuda(b[0]), cuda(b[1]))

    def median_ok(tol):
        def check(flow):
            m = inner_median(flow)
            return abs(m[0] - 2.0) <= tol and abs(m[1] - 1.0) <= tol, f"inner median ({m[0]:.4f}, {m[1]:.4f})"
        return check

    def epe_ok(tol):
        def check(flow):
            epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
            return epe < tol, f"inner EPE {epe:.4f}"
        return check

    lk = (lucas_kanade.pyramidal_lk_jit, lucas_kanade.pyramidal_lk)
    hs = (horn_schunck.pyramidal_hs_jit, horn_schunck.pyramidal_hs)
    fb = (farneback.pyramidal_farneback_jit, farneback.pyramidal_farneback)
    tv = (tvl1.pyramidal_tvl1_jit, tvl1.pyramidal_tvl1)
    ds = (dis.pyramidal_dis_jit, dis.pyramidal_dis)
    p48, p24 = pairs(1080, 1920, 48), pairs(1080, 1920, 24)
    small = pairs(480, 640, 48)
    prefiltered = of.LKConfig(levels=4, window=19, prefilter=of.BilateralConfig())
    # label -> (entries, config, pairs, (2, 1) check, the check's config when not the path's)
    paths = {
        "PAPER_1080P": (lk, of.PAPER_1080P, p48, median_ok(TRANSLATION_TOL), None),
        "PAPER_1080P fused_half_upsample": (
            lk, dataclasses.replace(of.PAPER_1080P, fused_half_upsample=True), p48,
            median_ok(TRANSLATION_TOL), None),
        # REFERENCE_GPU is no translation oracle: its prefilter's (2, 1) check
        # runs the prefiltered entry config (phase 7) at 480x640
        "REFERENCE_GPU": (lk, of.REFERENCE_GPU, p48, median_ok(TRANSLATION_TOL), prefiltered),
        "HSConfig() quadratic": (hs, of.HSConfig(), p24, median_ok(HS_TRANSLATION_TOL), None),
        "HSConfig() charbonnier": (hs, of.HSConfig(penalty="charbonnier"), p24,
                                   median_ok(HS_TRANSLATION_TOL), None),
        "FBConfig() image": (fb, of.FBConfig(), p24, median_ok(TRANSLATION_TOL), None),
        "FBConfig() coeff": (fb, of.FBConfig(warp_planes="coeff"), p24,
                             median_ok(TRANSLATION_TOL), None),
        "TVL1_REALTIME": (tv, of.TVL1_REALTIME, p48, median_ok(PRESET_TRANSLATION_TOL), None),
        "TVL1Config()": (tv, of.TVL1Config(), p48, epe_ok(TVL1_EPE_TOL), None),
        "DISConfig()": (ds, of.DISConfig(), p48, epe_ok(DIS_EPE_TOL), None),
        "DIS_REALTIME": (ds, of.DIS_REALTIME, p48, median_ok(PRESET_TRANSLATION_TOL), None),
        "entry LKConfig(levels=4, window=19)": (
            lk, of.LKConfig(levels=4, window=19), small, median_ok(TRANSLATION_TOL), None),
    }
    capture.clear()  # the earlier phases' graphs: each key below captures anew
    torch.cuda.empty_cache()
    out: dict = {}
    for label, ((jit, eager), cfg, ((pa, na), (pb, nb)), check, check_cfg) in paths.items():
        h, w = pa.shape
        want_a, counts = run_path(f"8n eager {label}", lambda: eager(pa, na, cfg), ())
        want_b = eager(pb, nb, cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graphs = capture.graphs_captured()
        t0 = time.perf_counter()
        got_a, c_counts = run_path(f"8n captured {label}", lambda: jit(pa, na, cfg), ())
        first_s = time.perf_counter() - t0
        require(capture.graphs_captured() == graphs + 1, f"8n {label}: first call did not capture once")
        require(c_counts == counts, f"8n {label}: captured launches {c_counts}, eager {counts}")
        equal_a = torch.equal(got_a, want_a)
        ok, what = check(got_a if check_cfg is None else jit(*small[0], check_cfg))
        del got_a
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        got_b, b_counts = run_path(f"8n captured {label} second pair", lambda: jit(pb, nb, cfg), ())
        require(b_counts == counts, f"8n {label}: second call launches {b_counts}, eager {counts}")
        again = jit(pa, na, cfg)
        require(capture.graphs_captured() == graphs + 1 + (check_cfg is not None),
                f"8n {label}: a call with the same key captured again")
        equal = (equal_a, torch.equal(got_b, want_b), torch.equal(again, want_a))
        require(all(equal), f"8n {label}: captured flow torch.equal to the eager flow on the "
                            f"first pair, the second, the first again: {equal}")
        require(got_b.data_ptr() != again.data_ptr(), f"8n {label}: outputs share memory")
        require(ok, f"8n {label}: (2, 1) check failed: {what}")
        graph = jit.cache.entries[jit.key(pa, na, cfg)]
        # the kernels inside the replay: every one of the eager call's, by name
        names = device_names(graph.replay)
        eager_names = device_names(lambda: eager(pa, na, cfg))
        ours = sorted(n for n in names if "of2_" in n)
        require(ours == sorted(n for n in eager_names if "of2_" in n) and (ours or not counts),
                f"8n {label}: the replay's kernels {ours} are not the eager call's")
        reps = CAPTURED_REPS.get(label, 30)
        ms = cuda_ms(lambda: jit(pa, na, cfg), reps)
        eager_ms = cuda_ms(lambda: eager(pa, na, cfg), reps)
        busy = profile_path(lambda: jit(pa, na, cfg), 5)
        eager_busy = profile_path(lambda: eager(pa, na, cfg), 5)
        row = {"ms": ms, "eager_ms": eager_ms, "busy_share": busy["device_ms"] / ms,
               "eager_busy_share": eager_busy["device_ms"] / eager_ms,
               "graph_nodes": len(names), "graph_kernels_of2": len(ours),
               "eager_device_ops": len(eager_names), "pool_mb": pool_mb,
               "capture_s": graph.seconds, "first_call_s": first_s, "launches": counts}
        out[label] = row
        print(f"phase 8n {label} {h}x{w} [{card}]: captured torch.equal to eager on two pairs; "
              f"(2, 1) {what}; launches {counts} = eager; captured once; replay shows "
              f"{len(ours)} of2 kernels of {len(names)} graph nodes (eager {len(eager_names)} "
              f"device ops); {ms:.3f} ms/pair captured vs {eager_ms:.3f} eager (median of "
              f"{reps}); busy {100 * row['busy_share']:.1f} % vs {100 * row['eager_busy_share']:.1f} "
              f"%; pool {pool_mb:.1f} MB; capture {graph.seconds:.3f} s (first call "
              f"{first_s:.3f} s)")

    # the serving loops: phase 6's frames (a cut, a dropped frame), captured
    # init_state / step through process_sequence against the eager bodies
    frames = scene_frames(1080, 1920)
    recovery = of.RecoveryConfig(levels=3)
    seed_ok = streaming._seed_ok

    def eager_loop(cfg, checks):
        """The eager loop; ``checks`` collects the recovery check's outcome
        of each warm step (a host read, as the eager step makes anyway)."""
        def spy(*args):
            ok = seed_ok(*args)
            checks.append(bool(ok))
            return ok

        cf = [None if f is None else cuda(f) for f in frames]
        state, flows = streaming._init_state(cf[0], cfg, recovery), {}
        streaming._seed_ok = spy
        try:
            for i, f in enumerate(cf[1:], start=1):
                if f is None:
                    state = streaming.FlowState(state.pyramid, None)
                    continue
                state, flows[i] = streaming._step(state, f, cfg, True, recovery)
        finally:
            streaming._seed_ok = seed_ok
        return flows

    def warm_entry():
        """The loop's warm key: the one donating entry with two graphs."""
        (entry,) = [e for e in streaming._step_graphs.cache.entries.values()
                    if len(e.graphs) == 2]
        return entry

    for label, cfg in (("LK levels=1", of.LKConfig(levels=1, window=15)),
                       ("FB levels=1 iterations=1", of.FBConfig(levels=1, iterations=1))):
        checks: list = []
        want, counts = run_path(f"8n eager serving {label}", lambda: eager_loop(cfg, checks), ())
        capture.clear()  # this loop's keys capture anew
        graphs = capture.graphs_captured()
        got, c_counts = run_path(f"8n captured serving {label}", lambda: dict(of.process_sequence(
            (None if f is None else cuda(f) for f in frames), cfg, warm_start=True,
            recovery=recovery)), ())
        captured_graphs = capture.graphs_captured() - graphs
        require(sorted(got) == sorted(want) and all(torch.equal(got[i], want[i]) for i in want),
                f"8n serving {label}: a captured step differs from the eager step")
        require(c_counts == counts, f"8n serving {label}: launches after settle() {c_counts}, "
                                    f"eager {counts}")
        # init_state, the cold step (no carried flow), the warm step's G0 and G1
        require(captured_graphs == 4, f"8n serving {label}: {captured_graphs} graphs captured")
        entry = warm_entry()
        capture.settle()
        taken = [sum(g.taken[0][b] for g in entry.graphs) for b in (0, 1)]
        want_taken = [checks.count(True), checks.count(False)]
        require(taken == want_taken and min(taken) > 0,
                f"8n serving {label}: branches replayed (warm, cold) {taken}, the eager loop's "
                f"checks {want_taken}")
        require(sum(g.replays for g in entry.graphs) == len(checks) and entry.plain is None,
                f"8n serving {label}: {[g.replays for g in entry.graphs]} replays for "
                f"{len(checks)} warm steps, a copy-in graph built: {entry.plain is not None}")
        del got, want

        # a stream step by step beside the eager steps, the general pool
        # refilled with NaN between steps (a graph that wrote memory it does
        # not own would show): only the frame is copied in after the first
        # warm step, the state returned is the key's buffers and the flow a
        # clone that later steps leave alone
        cf = [cuda(f) for f in frames[:7]]
        state = of.init_state(cf[0], cfg, recovery)
        state, _ = of.step(state, cf[1], cfg, True, recovery)
        eager_state = streaming._init_state(cf[0], cfg, recovery)
        eager_state, _ = streaming._step(eager_state, cf[1], cfg, True, recovery)
        copies, kept = [], []
        for k, f in enumerate(cf[2:], start=2):
            before = sum(g.copied for g in entry.graphs)
            torch.cuda.empty_cache()
            junk = torch.full((2**28,), float("nan"), device=dev)
            state, flow = of.step(state, f, cfg, True, recovery)
            del junk
            eager_state, eager_flow = streaming._step(eager_state, f, cfg, True, recovery)
            copies.append(sum(g.copied for g in entry.graphs) - before)
            require(torch.equal(flow, eager_flow), f"8n serving {label}: step {k} differs from "
                                                   "eager with the pool refilled")
            sets = entry.sets[(k - 1) % 2]
            require(all(a.data_ptr() == b.data_ptr() for a, b in
                        zip((*state.pyramid, state.flow), sets, strict=True))
                    and flow.data_ptr() != state.flow.data_ptr(),
                    f"8n serving {label}: step {k}'s state is not the key's buffer set")
            kept.append((flow, flow.clone()))
        # the first warm step copies the carried pyramid, the flow and the frame
        require(copies[0] == len(entry.sets[0]) + 1 and all(c == 1 for c in copies[1:]),
                f"8n serving {label}: tensors copied in per warm step {copies}")
        require(all(torch.equal(a, b) for a, b in kept), f"8n serving {label}: a handed flow "
                                                         "changed in a later step")
        del kept, state, eager_state

        # no host read: a warm step with CUDA frames under the sync check,
        # with the program's spans off, then recorded (a profiler active)
        from torch.profiler import ProfilerActivity, profile

        from cuda_optical_flow_2_torch.utils import profiling

        state = of.init_state(cf[0], cfg, recovery)
        state, _ = of.step(state, cf[1], cfg, True, recovery)
        state, _ = of.step(state, cf[2], cfg, True, recovery)
        nxt = cf[3]
        of.step(state, nxt, cfg, True, recovery)
        for recording in (False, True):
            torch.cuda.synchronize()
            profiling.clear_spans()
            tracing = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                       if recording else contextlib.nullcontext())
            with tracing:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    of.step(state, nxt, cfg, True, recovery)
                    synced = ""
                except RuntimeError as exc:
                    synced = str(exc).splitlines()[0][:160]
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            names = sorted({sp.name for sp in profiling.spans()})
            require(not synced, f"8n serving {label}: a warm step synchronised (spans recorded: "
                                f"{recording}): {synced}")
            require(("capture.launch" in names) == recording,
                    f"8n serving {label}: spans {names} with recording {recording}")

        # the warm step from a state of the key's buffers, captured and eager
        ms = cuda_ms(lambda: of.step(state, nxt, cfg, True, recovery), STEP_REPS)
        eager_ms = cuda_ms(lambda: streaming._step(state, nxt, cfg, True, recovery), STEP_REPS)
        wall = {name: back_to_back_ms(fn, STEP_REPS) for name, fn in (
            ("captured", lambda: of.step(state, nxt, cfg, True, recovery)),
            ("eager", lambda: streaming._step(state, nxt, cfg, True, recovery)))}
        busy = profile_path(lambda: of.step(state, nxt, cfg, True, recovery), 5)
        eager_busy = profile_path(lambda: streaming._step(state, nxt, cfg, True, recovery), 5)
        warm_ops = len(device_names(lambda: of.step(state, nxt, cfg, True, recovery)))
        del state
        # a replay across the cut (a (2, 1) seed on the new scene) runs the cold branch
        state = of.init_state(cf[2], cfg, recovery)
        state, _ = of.step(state, cf[3], cfg, True, recovery)
        state, _ = of.step(state, cf[4], cfg, True, recovery)
        cut = cf[5]
        capture.settle()
        cold_before = sum(g.taken[0][1] for g in entry.graphs)
        cold_ops = len(device_names(lambda: of.step(state, cut, cfg, True, recovery)))
        capture.settle()
        require(sum(g.taken[0][1] for g in entry.graphs) > cold_before,
                f"8n serving {label}: the step across the cut ran no cold branch")
        del state
        require(entry.plain is None, f"8n serving {label}: a copy-in graph was built")
        # the warm key's memory: capture it alone from a clean cache
        del entry
        capture.clear()
        state = of.init_state(cf[0], cfg, recovery)
        state, _ = of.step(state, cf[1], cfg, True, recovery)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        state, flow = of.step(state, cf[2], cfg, True, recovery)
        del flow
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        entry = warm_entry()
        capture_s = sum(g.seconds for g in entry.graphs)
        del state, cf
        row = out[f"serving step {label}"] = {
            "ms": ms, "eager_ms": eager_ms, "busy_share": busy["device_ms"] / ms,
            "eager_busy_share": eager_busy["device_ms"] / eager_ms,
            "wall_ms": wall["captured"], "eager_wall_ms": wall["eager"],
            "device_ms": busy["device_ms"], "device_ops_warm": warm_ops,
            "device_ops_cold": cold_ops, "eager_device_ops": eager_busy["ops_per_pair"],
            "pool_mb": pool_mb, "capture_s": capture_s, "graphs": captured_graphs,
            "branches": taken, "copies": copies, "launches": counts}
        print(f"phase 8n serving {label} 8 frames 1080x1920 [{card}]: every step torch.equal "
              f"to the eager step; launches {counts} = eager after settle(); one replay per "
              f"step, {captured_graphs} graphs captured (init_state, cold step, the warm step's "
              f"G0 and G1); branches replayed warm {taken[0]}, cold {taken[1]} (device counts, "
              f"= the eager loop's checks); tensors copied in per warm step {copies} (the "
              f"frame alone after the first), flows equal with the pool refilled with NaN; no "
              f"sync in a warm step under set_sync_debug_mode('error'); warm step "
              f"{ms:.3f} ms captured vs {eager_ms:.3f} eager (median of {STEP_REPS} between "
              f"events), {wall['captured']:.3f} vs {wall['eager']:.3f} ms per step back to "
              f"back; device busy {busy['device_ms']:.3f} ms, {100 * row['busy_share']:.1f} % "
              f"vs {100 * row['eager_busy_share']:.1f} %; device ops per replay warm "
              f"{warm_ops}, cold {cold_ops} (eager warm {eager_busy['ops_per_pair']:.0f}); "
              f"warm key's memory {pool_mb:.1f} MB (two graphs' pools, branch pools, both "
              f"state sets, the frame buffer); capture {capture_s:.3f} s")

    # autograd: a grad input runs the eager entry (plain path); kernels refuse it
    (pa, na), _ = small
    plain = of.LKConfig(levels=4, window=19, use_pallas=False)
    graphs = capture.graphs_captured()
    grads = []
    for entry in (of.pyramidal_lk_jit, of.pyramidal_lk):
        x = na.clone().requires_grad_(True)
        entry(pa, x, plain)[..., 0].mean().backward()
        grads.append(x.grad)
    gerr = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    require(capture.graphs_captured() == graphs and gerr <= GRAD_REL_ERR,
            f"8n autograd: captured {capture.graphs_captured() - graphs}, gradient {gerr}")
    try:
        of.pyramidal_lk_jit(pa, na.clone().requires_grad_(True), of.LKConfig(levels=4, window=19))
        refused = False
    except RuntimeError as exc:
        refused = "gradient" in str(exc)
    require(refused, "8n autograd: the kernel path took an input that requires grad")
    # a capture that fails raises (a host sync inside the graph); nothing runs eagerly
    bad = capture.captured(lambda x, k: x * float(x.sum()))
    try:
        bad(pa, 0)
        raised = ""
    except RuntimeError as exc:
        raised = str(exc).splitlines()[0][:120]
    torch.cuda.synchronize()
    require(raised.startswith("capture of"), f"8n: a failing capture did not raise: {raised!r}")
    after = of.pyramidal_lk_jit(pa, na, of.LKConfig(levels=4, window=19))
    require(torch.equal(after, of.pyramidal_lk(pa, na, of.LKConfig(levels=4, window=19))),
            "8n: captured entries broken after a failed capture")
    print(f"phase 8n autograd and failures [{card}]: pyramidal_lk_jit with a grad input runs "
          f"the eager plain path (no capture, gradient max |d| / max |g| {gerr:.3g}); the "
          f"kernel path refuses it; a failing capture raises ({raised}); entries work after it; "
          f"profiler: {profiler_note()}")
    capture.clear()
    torch.cuda.empty_cache()
    return out


# --- phase 8o: the parallel/ entries, tracking and the tools' step, captured -

CAPTURED_8O_REPS = {"TP TVL1_REALTIME": 5, "evaluate step TVL1_REALTIME fill": 5}
# the band kernels (#2b, #2b centered, #3b, #5b, #6b, #7b, #8b): each must
# launch inside a replay of phase 8o
BAND_KERNELS = ("lk_band_step", "lk_band_step centered", "warp_bilinear_select_band",
                "bilateral_kernel_band", "hs_relax_band", "tvl1_relax_band", "fb_band_step")


def phase_8o(of, dev, run_path, card: str) -> dict:
    """Each captured ``parallel/`` entry, ``track_sequence`` and the evaluate
    tool's step against its eager body (``.eager``); print one line per path;
    return the numbers for PERF.md."""
    import torch

    from cuda_optical_flow_2_torch import capture, parallel
    from cuda_optical_flow_2_torch.cli import evaluate
    from cuda_optical_flow_2_torch.models import lucas_kanade, tracking
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    def cuda(a):
        return torch.as_tensor(a, device=dev).float()

    def pairs(h, w):
        """The (2, 1) pair and a second pair of another scene and motion."""
        a = synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=48)
        b = synthetic_sequence(2, h, w, velocity=(-1.0, 1.5), period=48, seed=1)
        return (cuda(a[0]), cuda(a[1])), (cuda(b[0]), cuda(b[1]))

    def median_ok(tol, pick=lambda out: out):
        def check(out):
            m = inner_median(pick(out))
            ok = abs(m[0] - 2.0) <= tol and abs(m[1] - 1.0) <= tol
            return ok, f"inner median ({m[0]:.4f}, {m[1]:.4f})"
        return check

    def epe_ok(tol):
        def check(flow):
            epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
            return epe < tol, f"inner EPE {epe:.4f}"
        return check

    def same(a, b) -> bool:
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
        return torch.equal(a, b)

    (ua, va), (ub, vb) = pairs(2160, 3840)
    (pa, na), (pb, nb) = pairs(1080, 1920)
    mesh3 = parallel.make_mesh(axis_name="space", devices=[dev] * 3)
    grid = parallel.Mesh([[dev] * 3] * 2, ("batch", "space"))
    mesh2 = parallel.make_mesh(devices=[dev] * 2)
    prefiltered = of.LKConfig(levels=4, window=19, prefilter=of.BilateralConfig())
    lk_tp = parallel.spatial_pyramidal_lk

    # the tracking clips: 8 frames at (2, 1), and 8 of another scene; interior points
    clip_a = cuda(synthetic_sequence(8, 1080, 1920, velocity=(2.0, 1.0), period=48, noise=0.0))
    clip_b = cuda(synthetic_sequence(8, 1080, 1920, velocity=(-1.0, 1.5), period=48, seed=1,
                                     noise=0.0))
    gy, gx = torch.meshgrid(torch.linspace(200.0, 880.0, 12, device=dev),
                            torch.linspace(200.0, 1720.0, 20, device=dev), indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)

    def track_ok(out):
        pos, alive = out
        truth = pts[None] + torch.arange(1, 8, device=dev)[:, None, None] * pts.new_tensor(
            [2.0, 1.0])
        err = float((pos - truth).norm(dim=-1).max())
        return bool(alive.all()) and err <= TRACK_TOL, f"max point error {err:.4f} px"

    step = evaluate._step_jit()
    # label -> (captured entry, eager body, args of the (2, 1) input, args of the
    # other, the cache that holds its graph, replays per call, (2, 1) check)
    paths = {
        "TP PAPER_1080P": (lk_tp, lk_tp.eager, (ua, va, of.PAPER_1080P, mesh3),
                           (ub, vb, of.PAPER_1080P, mesh3), lk_tp.cache, 1,
                           median_ok(TRANSLATION_TOL)),
        # REFERENCE_GPU is no translation oracle (phase 8f): its (2, 1) check
        # runs the prefiltered entry config through the same captured entry
        "TP REFERENCE_GPU": (lk_tp, lk_tp.eager, (ua, va, of.REFERENCE_GPU, mesh3),
                             (ub, vb, of.REFERENCE_GPU, mesh3), lk_tp.cache, 1,
                             lambda flow: median_ok(TRANSLATION_TOL)(
                                 lk_tp(ua, va, prefiltered, mesh3))),
        "TP HSConfig()": (parallel.spatial_pyramidal_hs, parallel.spatial_pyramidal_hs.eager,
                          (ua, va, of.HSConfig(), mesh3), (ub, vb, of.HSConfig(), mesh3),
                          parallel.spatial_pyramidal_hs.cache, 1, median_ok(HS_TRANSLATION_TOL)),
        "TP TVL1_REALTIME": (parallel.spatial_pyramidal_tvl1,
                             parallel.spatial_pyramidal_tvl1.eager,
                             (ua, va, of.TVL1_REALTIME, mesh3), (ub, vb, of.TVL1_REALTIME, mesh3),
                             parallel.spatial_pyramidal_tvl1.cache, 1,
                             median_ok(PRESET_TRANSLATION_TOL)),
        "TP FBConfig()": (parallel.spatial_pyramidal_fb, parallel.spatial_pyramidal_fb.eager,
                          (ua, va, of.FBConfig(), mesh3), (ub, vb, of.FBConfig(), mesh3),
                          parallel.spatial_pyramidal_fb.cache, 1, median_ok(TRANSLATION_TOL)),
        "TP DISConfig(levels=4)": (parallel.spatial_pyramidal_dis,
                                   parallel.spatial_pyramidal_dis.eager,
                                   (ua, va, of.DISConfig(levels=4), mesh3),
                                   (ub, vb, of.DISConfig(levels=4), mesh3),
                                   parallel.spatial_pyramidal_dis.cache, 1, epe_ok(DIS_EPE_TOL)),
        "grid PAPER_1080P 2x3": (parallel.grid_pyramidal_lk, parallel.grid_pyramidal_lk.eager,
                                 (torch.stack([ua, vb]), torch.stack([va, ub]), of.PAPER_1080P,
                                  grid),
                                 (torch.stack([ub, va]), torch.stack([vb, ua]), of.PAPER_1080P,
                                  grid), lk_tp.cache, 2,
                                 median_ok(TRANSLATION_TOL, lambda out: out[0])),
        "sharded_flow PAPER_1080P batch 4, 2 shards": (
            parallel.sharded_flow, parallel.sharded_flow.eager,
            (torch.stack([pa, pb, pa, pb]), torch.stack([na, nb, na, nb]), of.PAPER_1080P, mesh2),
            (torch.stack([pb, pa, nb, pb]), torch.stack([nb, na, pb, nb]), of.PAPER_1080P, mesh2),
            lucas_kanade.pyramidal_lk_jit.cache, 2,
            median_ok(TRANSLATION_TOL, lambda out: out[0])),
        "chunked_flow PAPER_1080P batch 8, chunk 2": (
            parallel.chunked_flow, parallel.chunked_flow.eager,
            (torch.stack([pa, pb] * 4), torch.stack([na, nb] * 4), of.PAPER_1080P, 2),
            (torch.stack([pb, na] * 4), torch.stack([nb, pa] * 4), of.PAPER_1080P, 2),
            parallel.chunked_flow.cache, 1, median_ok(TRANSLATION_TOL, lambda out: out[6])),
        "track_sequence PAPER_1080P 8 frames": (
            tracking.track_sequence, tracking.track_sequence.eager,
            (clip_a, pts, of.PAPER_1080P), (clip_b, pts, of.PAPER_1080P),
            tracking.track_sequence.cache, 1, track_ok),
        "evaluate step PAPER_1080P": (
            step, evaluate._step, (pa, na, of.PAPER_1080P, False),
            (pb, nb, of.PAPER_1080P, False), step.cache, 1, median_ok(TRANSLATION_TOL)),
        "evaluate step TVL1_REALTIME fill": (
            step, evaluate._step, (pa, na, of.TVL1_REALTIME, True),
            (pb, nb, of.TVL1_REALTIME, True), step.cache, 1,
            median_ok(PRESET_TRANSLATION_TOL)),
    }
    out: dict = {}
    in_replays: set = set()
    t_phase = time.perf_counter()
    for label, (jit, eager, args_a, args_b, cache, n_graph, check) in paths.items():
        capture.clear()
        torch.cuda.empty_cache()
        want_a, counts = run_path(f"8o eager {label}", lambda: eager(*args_a), ())
        want_b = eager(*args_b)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graphs = capture.graphs_captured()
        t0 = time.perf_counter()
        got_a, c_counts = run_path(f"8o captured {label}", lambda: jit(*args_a), ())
        first_s = time.perf_counter() - t0
        require(capture.graphs_captured() == graphs + 1 and len(cache.entries) == 1,
                f"8o {label}: first call captured {capture.graphs_captured() - graphs} graphs")
        require(c_counts == counts, f"8o {label}: captured launches {c_counts}, eager {counts}")
        in_replays |= set(c_counts)
        equal_a = same(got_a, want_a)
        ok, what = check(got_a)
        del got_a
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        graphs_after = capture.graphs_captured()
        got_b, b_counts = run_path(f"8o captured {label} second input", lambda: jit(*args_b), ())
        require(b_counts == counts, f"8o {label}: second call launches {b_counts}, eager {counts}")
        again = jit(*args_a)
        require(capture.graphs_captured() == graphs_after,
                f"8o {label}: a call with the same key captured again")
        equal = (equal_a, same(got_b, want_b), same(again, want_a))
        require(all(equal), f"8o {label}: captured torch.equal to the eager body on the first "
                            f"input, the second, the first again: {equal}")
        require(ok, f"8o {label}: (2, 1) check failed: {what}")
        graph = list(cache.entries.values())[-1]  # the key of the first input, used last
        # the replay's device ops against the eager call's: every op for one
        # graph per call; the kernels (and a gather of at most 2 ops) when a
        # call replays one graph per group or shard
        names = device_names(graph.replay)
        eager_names = device_names(lambda: eager(*args_a))
        ours = sorted(n for n in names if "of2_" in n) * n_graph
        require(sorted(ours) == sorted(n for n in eager_names if "of2_" in n) and ours,
                f"8o {label}: the replays' kernels are not the eager call's")
        gather = len(eager_names) - n_graph * len(names)
        require(gather == 0 if n_graph == 1 else 0 <= gather <= 2,
                f"8o {label}: {n_graph} x {len(names)} replayed device ops, eager "
                f"{len(eager_names)}")
        reps = CAPTURED_8O_REPS.get(label, 10)
        ms = cuda_ms(lambda: jit(*args_a), reps)
        eager_ms = cuda_ms(lambda: eager(*args_a), reps)
        busy = profile_path(lambda: jit(*args_a), 3)
        eager_busy = profile_path(lambda: eager(*args_a), 3)
        row = {"ms": ms, "eager_ms": eager_ms, "busy_share": busy["device_ms"] / ms,
               "eager_busy_share": eager_busy["device_ms"] / eager_ms,
               "device_ms": busy["device_ms"], "eager_device_ms": eager_busy["device_ms"],
               "graph_nodes": len(names), "graphs_per_call": n_graph,
               "eager_device_ops": len(eager_names), "pool_mb": pool_mb,
               "capture_s": graph.seconds, "first_call_s": first_s, "launches": counts}
        out[label] = row
        print(f"phase 8o {label} [{card}]: captured torch.equal to eager on two inputs; (2, 1) "
              f"{what}; launches {counts} = eager; captured once; {n_graph} replay(s) of "
              f"{len(names)} graph nodes ({len(ours) // n_graph} of2 kernels) per call vs "
              f"{len(eager_names)} eager device ops; {ms:.3f} ms captured vs {eager_ms:.3f} "
              f"eager (median of {reps}); device {busy['device_ms']:.3f} vs "
              f"{eager_busy['device_ms']:.3f} ms; busy {100 * row['busy_share']:.1f} % vs "
              f"{100 * row['eager_busy_share']:.1f} %; pool {pool_mb:.1f} MB; capture "
              f"{graph.seconds:.3f} s (first call {first_s:.3f} s)")
    missing = [k for k in BAND_KERNELS if k not in in_replays]
    require(not missing, f"8o: band kernels never launched inside a replay: {missing}")
    capture.clear()
    torch.cuda.empty_cache()
    print(f"phase 8o [{card}]: every band kernel ({', '.join(BAND_KERNELS)}) launched inside a "
          f"replay at the eager call's counts; {time.perf_counter() - t_phase:.1f} s; profiler: "
          f"{profiler_note()}")
    return out


# --- phase 8p: every multi-device entry on the cards present ----------------

# px: DIS under spatial TP against the unsharded path, max |d|: PERF.md §6
# states "within 2.9e-4 px" to two figures (the refinement's window means sum
# from each band's first row); the card shows 2.91e-4 at 4K for
# DISConfig(levels=4) on 3 shards, so the limit is what rounds to 2.9e-4.
# Spatial TP of LK, HS, TV-L1 and FB is bit-equal to the unsharded path.
DIS_TP_MAX_ERR = 2.95e-4
REPS_8P = 5
# DP over several cards: the device's busy time on any card at most this
# share of the cards' summed busy time (1 when they take turns, 1 / n when
# all n run at once): every shard is enqueued before the gather
OVERLAP_SHARE = 0.9
NCCL_PAIRS = 8
NCCL_TIMEOUT = 300  # s, for all worker processes


def mesh_cards(n_cards: int, k: int) -> list:
    """``k`` mesh entries over the cards present: ``cuda:0``, ``cuda:1``, ...
    in turn, or on one card ``cuda`` and ``cuda:0`` in turn (two devices to
    ``parallel.spatial.one_device``, one card)."""
    import torch

    if n_cards == 1:
        return [torch.device("cuda") if i % 2 == 0 else torch.device("cuda", 0) for i in range(k)]
    return [torch.device("cuda", i % n_cards) for i in range(k)]


def wall_ms(fn, reps: int) -> float:
    """Median host ms of one call of ``fn`` from every card idle to every
    card done (after one call outside the clock)."""
    fn()
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_cards(fn, calls: int) -> dict:
    """torch.profiler over ``calls`` calls: device busy ms per call on each
    card (merged kernel and copy intervals) and on any card (the union: it
    falls below the cards' sum as far as they run at once), and the copies
    between cards per call (the peer memcpy events, ``Memcpy PtoP``): their
    ms and count."""
    dev, _ = traced(fn, calls)
    busy: dict = {}
    end: dict = {}
    union, last = 0.0, -math.inf
    peer_ms = peer_n = 0
    for s, e, name, card in dev:
        busy[card] = busy.get(card, 0.0) + max(0.0, e - max(s, end.get(card, -math.inf)))
        end[card] = max(end.get(card, -math.inf), e)
        union += max(0.0, e - max(s, last))
        last = max(last, e)
        if "PtoP" in name:
            peer_ms += e - s
            peer_n += 1
    return {"busy_ms": {card: b / 1e3 / calls for card, b in sorted(busy.items())},
            "union_ms": union / 1e3 / calls,
            "peer_ms": peer_ms / 1e3 / calls, "peer_copies": peer_n / calls}


def nccl_worker(rank: int, nproc: int, port: int, out_dir: str) -> int:
    """One process of phase 8p's multihost run, one per card: join the
    NCCL group (``multihost.initialize`` with the default backend picks the
    process's own card), feed this process's slice of the 8-pair batch
    through ``sharded_flow_from_local``, save the flow, gather every
    process's checksum over NCCL, print the ms per pair."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.parallel import multihost
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    multihost.initialize(f"localhost:{port}", nproc, rank)
    backend = dist.get_backend()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = multihost.make_global_mesh()
    per, off = multihost.host_local_batch(NCCL_PAIRS, mesh)
    fr = synthetic_sequence(NCCL_PAIRS + 1, 1080, 1920, velocity=(2.0, 1.0), period=48)
    prev = np.stack(fr[off:off + per]).astype(np.float32)
    nxt = np.stack(fr[off + 1:off + per + 1]).astype(np.float32)

    def run():
        return multihost.sharded_flow_from_local(prev, nxt, of.PAPER_1080P, mesh)

    flow = run()
    ms = cuda_ms(run, reps=10) / per
    torch.save(flow.cpu(), Path(out_dir) / f"nccl{rank}.pt")
    total = flow.double().sum().float()
    sums = [torch.zeros((), device=dev) for _ in range(nproc)]
    dist.all_gather(sums, total)  # the group's one collective: every process's checksum
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "backend": backend, "card": dev.index, "pairs": per,
                      "offset": off, "ms_per_pair": ms, "mesh": str(mesh),
                      "checksums": [float(x) for x in sums]}))
    print("NCCL_OK", flush=True)
    return 0


def phase_8p(of, dev, run_path, card: str) -> dict:
    """Every multi-device entry on distinct cards (on one card: over meshes
    that name it ``cuda`` and ``cuda:0`` in turn) against the same entry
    with its shards on one card: DP, spatial TP, grid, serving per card,
    the two mesh examples and NCCL multihost; print one line per path;
    return the numbers for PERF.md."""
    import contextlib
    import io
    import shutil
    import socket
    import tempfile

    import torch

    from cuda_optical_flow_2_torch import capture, parallel
    from cuda_optical_flow_2_torch.examples import sharded_batch, spatial_tp
    from cuda_optical_flow_2_torch.models import _jit_entry, streaming
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60)
    topo = (topo.stdout + topo.stderr).rstrip()
    print(f"phase 8p distinct cards {n_cards}: "
          + "; ".join(torch.cuda.get_device_name(i) for i in range(n_cards))
          + ("" if n_cards > 1 else "; the meshes name the one card as cuda and cuda:0 in turn "
             "(two devices to one_device, so the several-devices path runs; no copy crosses "
             "cards)"))
    print(f"phase 8p cards (name, power limit):\n{smi}")
    print(f"phase 8p nvidia-smi topo -m:\n{topo}")
    peers = {(a, b): torch.cuda.can_device_access_peer(a, b)
             for a in range(n_cards) for b in range(n_cards) if a != b}
    print("phase 8p peer access: " + ("; ".join(f"{a}->{b} {ok}" for (a, b), ok in peers.items())
                                      or "one card, no pair"))
    captures = parallel.spatial.peer_access(cards)
    require(captures == all(peers.values()),
            "8p: spatial.peer_access disagrees with can_device_access_peer")
    if not captures:
        print("phase 8p: a pair of cards lacks peer access, so a TP or grid entry over them "
              "runs its eager body (parallel.spatial.peer_access): a graph cannot hold a copy "
              "between them")

    def cuda(a):
        return torch.as_tensor(a, device=dev).float()

    def reserved() -> list:
        sync_all()
        torch.cuda.empty_cache()
        return [torch.cuda.memory_reserved(c) for c in cards]

    def no_sync(fn) -> str:
        sync_all()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            return ""
        except RuntimeError as exc:
            return str(exc).splitlines()[0][:160]
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def graphs_of(caches) -> list:
        return [g for c in caches for g in c.entries.values()]

    out: dict = {}

    def run(label, jit, eager, args_n, args_1, caches, span, extra=None, overlap=False):
        """One entry: captured against eager over the mesh of distinct cards
        (``args_n``) and against the same entry with its shards on one card
        (``args_1``); every graph of the call spans ``span`` cards (None:
        the call runs eagerly, no graph); with ``overlap`` the cards must
        run at once."""
        capture.clear()
        want, counts = run_path(f"8p eager {label}", lambda: eager(*args_n), ())
        require(counts, f"8p {label}: the eager call launched no kernel")
        before = reserved()
        graphs = capture.graphs_captured()
        t0 = time.perf_counter()
        got, c_counts = run_path(f"8p captured {label}", lambda: jit(*args_n), ())
        first_s = time.perf_counter() - t0
        n_graphs = capture.graphs_captured() - graphs
        pool = [(r - b) / 2**20 for r, b in zip(reserved(), before)]
        require(c_counts == counts, f"8p {label}: captured launches {c_counts}, eager {counts}")
        require(torch.equal(got, want), f"8p {label}: captured not torch.equal to eager")
        held = graphs_of(caches)
        spans = sorted({len({g.device, *g.peers}) for g in held})
        require(n_graphs == len(held) and spans == ([] if span is None else [span]),
                f"8p {label}: {n_graphs} graphs captured, {len(held)} held, spanning {spans} "
                f"cards, not {span}")
        capture_s = sum(g.seconds for g in held)
        again, a_counts = run_path(f"8p captured again {label}", lambda: jit(*args_n), ())
        require(torch.equal(again, want) and a_counts == counts
                and capture.graphs_captured() == graphs + n_graphs,
                f"8p {label}: a second call differs, launched otherwise or captured again")
        synced = no_sync(lambda: jit(*args_n))
        require(not synced, f"8p {label}: a warm call synchronised: {synced}")
        want1 = eager(*args_1)
        got1, counts1 = run_path(f"8p captured one card {label}", lambda: jit(*args_1), ())
        require(torch.equal(want1, want) and torch.equal(got1, got) and counts1 == counts,
                f"8p {label}: not torch.equal to the same entry with its shards on one card")
        what = ""
        if extra is not None:
            ok, what = extra(got)
            require(ok, f"8p {label}: {what}")
        ms = {name: wall_ms(fn, REPS_8P) for name, fn in (
            ("captured", lambda: jit(*args_n)), ("eager", lambda: eager(*args_n)),
            ("captured one card", lambda: jit(*args_1)), ("eager one card", lambda: eager(*args_1)))}
        prof = profile_cards(lambda: jit(*args_n), 3)
        total = sum(prof["busy_ms"].values())
        if overlap and len(prof["busy_ms"]) > 1:
            require(prof["union_ms"] <= OVERLAP_SHARE * total,
                    f"8p {label}: the cards did not run at once: busy on any card "
                    f"{prof['union_ms']:.3f} ms of their sum {total:.3f}")
        row = out[label] = {"ms": ms, "busy_ms": prof["busy_ms"], "union_ms": prof["union_ms"],
                            "peer_ms": prof["peer_ms"],
                            "peer_copies": prof["peer_copies"], "pool_mb": pool,
                            "capture_s": capture_s, "first_call_s": first_s, "graphs": n_graphs,
                            "launches": counts}
        print(f"phase 8p {label} [{card}]: captured torch.equal to eager and to the shards on "
              f"one card, launches {counts} = eager; {n_graphs} graph(s) of {span} card(s) "
              f"each, captured once, no sync in a warm call{'; ' + what if what else ''}; ms "
              f"per call captured {ms['captured']:.3f} / eager {ms['eager']:.3f} over "
              f"[{', '.join(args_devices(args_n))}], captured {ms['captured one card']:.3f} "
              f"/ eager {ms['eager one card']:.3f} with the shards on one card (host clock, "
              f"median of {REPS_8P}); device busy per card "
              + ", ".join(f"{c}: {b:.3f}" for c, b in row["busy_ms"].items())
              + f" ms (any card {prof['union_ms']:.3f} of their sum {total:.3f}); copies "
              f"between cards {prof['peer_ms']:.3f} ms in "
              f"{prof['peer_copies']:.0f} peer memcpys per call; pool MB per card "
              + ", ".join(f"{p:.1f}" for p in pool)
              + f"; capture {capture_s:.3f} s (first call {first_s:.3f} s)")
        return got

    def args_devices(args) -> list:
        mesh = next(a for a in args if isinstance(a, parallel.Mesh))
        return [str(d) for d in mesh.devices.reshape(-1)]

    # DP: an 8-pair 1080x1920 batch over 4 mesh entries, two pairs each
    fr = synthetic_sequence(9, 1080, 1920, velocity=(2.0, 1.0), period=48)
    bp = torch.from_numpy(np.stack(fr[:-1]).astype(np.float32)).to(dev)
    bn = torch.from_numpy(np.stack(fr[1:]).astype(np.float32)).to(dev)
    del fr
    dp_n = parallel.Mesh(mesh_cards(n_cards, 4), ("batch",))
    dp_1 = parallel.Mesh([dev] * 4, ("batch",))
    dp_families = {"PAPER_1080P": of.PAPER_1080P, "HSConfig()": of.HSConfig(),
                   "FBConfig()": of.FBConfig(), "TVL1_REALTIME": of.TVL1_REALTIME,
                   "DISConfig()": of.DISConfig()}
    for name, cfg in dp_families.items():
        run(f"DP sharded_flow {name} 8 x 1080x1920 over 4", parallel.sharded_flow,
            parallel.sharded_flow.eager, (bp, bn, cfg, dp_n), (bp, bn, cfg, dp_1),
            [_jit_entry(cfg).cache], 1, overlap=True)
    capture.clear()
    lk_alias = parallel.sharded_pyramidal_lk(bp, bn, of.PAPER_1080P, dp_n)
    require(torch.equal(lk_alias, parallel.sharded_flow(bp, bn, of.PAPER_1080P, dp_1)),
            "8p sharded_pyramidal_lk differs from sharded_flow on one card")
    chunked = [parallel.chunked_flow(bp.to(c), bn.to(c), of.PAPER_1080P, 2) for c in cards]
    one = parallel.chunked_flow.eager(bp, bn, of.PAPER_1080P, 2)
    require(all(torch.equal(f.to(dev), one) for f in chunked),
            "8p chunked_flow on a card differs from the eager call on card 0")
    require(len(parallel.chunked_flow.cache.entries) == n_cards,
            f"8p chunked_flow: {len(parallel.chunked_flow.cache.entries)} keys for {n_cards} "
            "card(s)")
    print(f"phase 8p DP sharded_pyramidal_lk PAPER_1080P over 4 [{card}]: torch.equal to "
          f"sharded_flow with the shards on one card; chunked_flow (8 pairs, chunk 2) on each "
          f"of {n_cards} card(s), one graph per card, torch.equal to the eager call on card 0")
    del lk_alias, chunked, one, bp, bn
    capture.clear()

    # spatial TP at 2160x3840: HS and FB over 4 mesh entries, the other four
    # over 3 (phase 8o's shapes), each against its shards on one card and the
    # unsharded path
    a = synthetic_sequence(2, 2160, 3840, velocity=(2.0, 1.0), period=48)
    b = synthetic_sequence(2, 2160, 3840, velocity=(-1.0, 1.5), period=48, seed=1)
    ua, va, ub, vb = cuda(a[0]), cuda(a[1]), cuda(b[0]), cuda(b[1])
    del a, b

    def unsharded(cfg, limit):
        def check(flow):
            e = err_stats(flow, of.pyramidal_flow(ua, va, cfg))
            return e["max"] <= limit, f"vs unsharded max |d| {e['max']:.3g} (limit {limit})"
        return check

    tp = {
        "HSConfig()": (parallel.spatial_pyramidal_hs, of.HSConfig(), 4, 0.0),
        "FBConfig()": (parallel.spatial_pyramidal_fb, of.FBConfig(), 4, 0.0),
        "PAPER_1080P": (parallel.spatial_pyramidal_lk, of.PAPER_1080P, 3, 0.0),
        "REFERENCE_GPU": (parallel.spatial_pyramidal_lk, of.REFERENCE_GPU, 3, 0.0),
        "TVL1_REALTIME": (parallel.spatial_pyramidal_tvl1, of.TVL1_REALTIME, 3, 0.0),
        "DISConfig(levels=4)": (parallel.spatial_pyramidal_dis, of.DISConfig(levels=4), 3,
                                DIS_TP_MAX_ERR),
    }
    for name, (entry, cfg, k, limit) in tp.items():
        mesh_n = parallel.make_mesh(axis_name="space", devices=mesh_cards(n_cards, k))
        mesh_1 = parallel.make_mesh(axis_name="space", devices=[dev] * k)
        span = min(k, n_cards) if captures else None
        run(f"TP {name} 2160x3840 over {k}", entry, entry.eager, (ua, va, cfg, mesh_n),
            (ua, va, cfg, mesh_1), [entry.cache], span, unsharded(cfg, limit))

    # grid: 2 (batch) x 2 (space) mesh entries, one TP group per batch index
    pg, ng = torch.stack([ua, ub]), torch.stack([va, vb])
    grid_n = parallel.Mesh(np.array(mesh_cards(n_cards, 4), dtype=object).reshape(2, 2),
                           ("batch", "space"))
    grid_1 = parallel.Mesh([[dev] * 2] * 2, ("batch", "space"))
    grid_span = min(2, n_cards) if captures else None
    run("grid_pyramidal_lk REFERENCE_GPU 2 x 2160x3840 over 2 x 2", parallel.grid_pyramidal_lk,
        parallel.grid_pyramidal_lk.eager, (pg, ng, of.REFERENCE_GPU, grid_n),
        (pg, ng, of.REFERENCE_GPU, grid_1), [parallel.spatial_pyramidal_lk.cache], grid_span)
    run("grid_pyramidal_flow TVL1_REALTIME 2 x 2160x3840 over 2 x 2",
        parallel.grid_pyramidal_flow, parallel.grid_pyramidal_flow.eager,
        (pg, ng, of.TVL1_REALTIME, grid_n), (pg, ng, of.TVL1_REALTIME, grid_1),
        [parallel.spatial_pyramidal_tvl1.cache], grid_span)
    del ua, va, ub, vb, pg, ng
    capture.clear()

    # serving: one stream per mesh entry, its frames a sharded batch, the
    # captured init_state / step on each card's shard with recovery, against
    # the eager loop of each stream on card 0
    recovery = of.RecoveryConfig(levels=3)
    k = max(n_cards, 2)
    serve_mesh = parallel.Mesh(mesh_cards(n_cards, k), ("batch",))
    base = scene_frames(1080, 1920)
    # stream c: phase 6's frames shifted 40 c px across (another scene per stream)
    batches = [None if f is None else torch.stack([cuda(np.roll(f, 40 * c, axis=1))
                                                   for c in range(k)]) for f in base]
    for label, cfg in (("LK levels=1", of.LKConfig(levels=1, window=15)),
                       ("FB levels=1 iterations=1", of.FBConfig(levels=1, iterations=1))):
        def eager_loop():
            flows = {}
            for c in range(k):
                state = streaming._init_state(batches[0][c:c + 1], cfg, recovery)
                for t, f in enumerate(batches[1:], start=1):
                    if f is None:
                        state = streaming.FlowState(state.pyramid, None)
                        continue
                    state, flows[c, t] = streaming._step(state, f[c:c + 1], cfg, True, recovery)
            return flows

        def loop(mesh):
            shards = [None if f is None else parallel.shard_batch(f, mesh) for f in batches]
            states = [of.init_state(s, cfg, recovery) for s in shards[0]]
            flows = {}
            for t, f in enumerate(shards[1:], start=1):
                for c in range(k):
                    if f is None:
                        states[c] = streaming.FlowState(states[c].pyramid, None)
                        continue
                    states[c], flows[c, t] = of.step(states[c], f[c], cfg, True, recovery)
            return flows, states

        capture.clear()
        want, counts = run_path(f"8p eager serving {label}", eager_loop, ())
        graphs = capture.graphs_captured()
        (got, states), c_counts = run_path(f"8p captured serving {label}",
                                           lambda: loop(serve_mesh), ())
        n_graphs = capture.graphs_captured() - graphs
        require(sorted(got) == sorted(want)
                and all(torch.equal(got[key].to(dev), want[key]) for key in want),
                f"8p serving {label}: a card's step differs from one card's eager step")
        require(c_counts == counts, f"8p serving {label}: launches after settle() {c_counts}, "
                                    f"eager {counts}")
        capture.settle()
        entries = list(streaming._step_graphs.cache.entries.values())
        replays = sum(g.replays for e in entries
                      for g in [*e.graphs, *([e.plain] if e.plain is not None else [])])
        steps = len(got)
        require(replays == steps, f"8p serving {label}: {replays} replays for {steps} steps")
        cards_used = sorted({f.device.index for f in got.values()})
        # a warm step on each card's stream, under the sync check
        nxt = parallel.shard_batch(batches[3], serve_mesh)
        for c in range(k):
            states[c], _ = of.step(states[c], nxt[c], cfg, True, recovery)
        synced = no_sync(lambda: [of.step(states[c], nxt[c], cfg, True, recovery)
                                  for c in range(k)])
        require(not synced, f"8p serving {label}: a warm step synchronised: {synced}")
        ms = wall_ms(lambda: [of.step(states[c], nxt[c], cfg, True, recovery) for c in range(k)],
                     REPS_8P * 2)
        eager_ms = wall_ms(lambda: [streaming._step(states[c], nxt[c], cfg, True, recovery)
                                    for c in range(k)], REPS_8P * 2)
        prof = profile_cards(lambda: [of.step(states[c], nxt[c], cfg, True, recovery)
                                      for c in range(k)], 3)
        # the same streams with every shard on one card
        (got1, states1), _ = run_path(f"8p captured serving one card {label}",
                                      lambda: loop(parallel.Mesh([dev] * k, ("batch",))), ())
        require(all(torch.equal(got1[key], want[key]) for key in want),
                f"8p serving {label}: the streams on one card differ from the eager steps")
        nxt1 = parallel.shard_batch(batches[3], parallel.Mesh([dev] * k, ("batch",)))
        ms1 = wall_ms(lambda: [of.step(states1[c], nxt1[c], cfg, True, recovery)
                               for c in range(k)], REPS_8P * 2)
        capture_s = sum(g.seconds for e in entries for g in e.graphs)
        out[f"serving {label}"] = {"ms": ms, "eager_ms": eager_ms, "ms_one_card": ms1,
                                   "busy_ms": prof["busy_ms"], "graphs": n_graphs,
                                   "capture_s": capture_s, "launches": counts}
        print(f"phase 8p serving {label} {k} streams x 8 frames 1080x1920 [{card}]: each "
              f"stream's steps on its card (cards {cards_used}) torch.equal to its eager steps "
              f"on card 0, across the cut; launches {counts} = eager after settle(); {replays} "
              f"replays for {steps} steps; {n_graphs} graphs captured; no sync in a warm step "
              f"of any card; one step on every stream {ms:.3f} ms captured vs {eager_ms:.3f} "
              f"eager, {ms1:.3f} captured with every stream on one card (host clock, median of "
              f"{REPS_8P * 2}); device busy per card "
              + ", ".join(f"{c}: {b:.3f}" for c, b in prof["busy_ms"].items())
              + f" ms per lockstep; capture {capture_s:.3f} s")
        del got, got1, want, states, states1, nxt, nxt1
    del batches
    capture.clear()

    # the two mesh examples on every card
    expect = example_launches(n_cards)
    for name, mod in (("sharded_batch", sharded_batch), ("spatial_tp", spatial_tp)):
        buf = io.StringIO()
        tmp = tempfile.mkdtemp(prefix="of2_8p_")
        try:
            with contextlib.redirect_stdout(buf):
                res, counts = run_path(f"8p example {name}",
                                       lambda: mod.main(device="cuda", out_dir=tmp), ())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        require(counts == expect[name], f"8p example {name} launches {counts}, predicted "
                                        f"{expect[name]} for {n_cards} card(s)")
        print(f"phase 8p example {name} [{card}]: launches {counts} (example_launches("
              f"{n_cards})); printed: " + " | ".join(x.strip() for x in buf.getvalue().splitlines()))
    capture.clear()

    # multihost: one NCCL process per card, each its slice of 8 PAPER_1080P pairs
    nproc = max(p for p in (1, 2, 4) if p <= n_cards)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="of2_8p_")
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--nccl-worker", str(rank),
             str(nproc), str(port), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(nproc)]
        try:
            outs = [proc.communicate(timeout=NCCL_TIMEOUT)[0] for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for rank, (proc, text) in enumerate(zip(procs, outs)):
            require(proc.returncode == 0 and "NCCL_OK" in text,
                    f"NCCL worker {rank} failed ({proc.returncode}):\n{text[-3000:]}")
        fr = synthetic_sequence(NCCL_PAIRS + 1, 1080, 1920, velocity=(2.0, 1.0), period=48)
        gp = torch.from_numpy(np.stack(fr[:-1]).astype(np.float32)).to(dev)
        gn = torch.from_numpy(np.stack(fr[1:]).astype(np.float32)).to(dev)
        want = parallel.sharded_flow(gp, gn, of.PAPER_1080P, parallel.make_mesh(devices=[dev]))
        recs = [json_records(text)[-1] for text in outs]
        sums = [float(want[r["offset"]:r["offset"] + r["pairs"]].double().sum().float())
                for r in recs]
        for rank, rec in enumerate(recs):
            got = torch.load(Path(tmp) / f"nccl{rank}.pt").to(dev)
            lo = rec["offset"]
            require(rec["backend"] == "nccl" and rec["card"] == rank,
                    f"NCCL rank {rank}: backend {rec['backend']}, card {rec['card']}")
            require(torch.equal(got, want[lo:lo + rec["pairs"]]),
                    f"NCCL rank {rank}: flow not bit-equal to one process's sharded_flow")
            require(rec["checksums"] == sums, f"NCCL rank {rank}: gathered checksums "
                                              f"{rec['checksums']}, expected {sums}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["multihost NCCL ms per pair"] = [r["ms_per_pair"] for r in recs]
    print(f"phase 8p multihost [{card}]: {nproc} NCCL process(es), one per card (cards "
          f"{[r['card'] for r in recs]}), {NCCL_PAIRS} PAPER_1080P pairs at 1080x1920, each "
          f"its {recs[0]['pairs']}: bit-equal to one process's sharded_flow, checksums gathered "
          f"over NCCL; ms per pair per process "
          + ", ".join(f"{r['ms_per_pair']:.3f}" for r in recs)
          + f"; {time.perf_counter() - t0:.1f} s")
    print(f"phase 8p [{card}]: {time.perf_counter() - t_phase:.1f} s; profiler: "
          f"{profiler_note()}")
    return out


# --- phase 8q: the coarse-to-fine handoff kernel -----------------------------

# PAPER_1080P's four handoffs at 1080x1920, coarse (h, w) -> fine (H, W): the
# levels floor-halve 1080 to 67 rows, so the first handoff has an odd target
HANDOFFS_1080P = [((67, 120), (135, 240)), ((135, 240), (270, 480)), ((270, 480), (540, 960)),
                  ((540, 960), (1080, 1920))]
HANDOFF_BATCHES = (1, 8, 54)  # one pair, a video batch, the camera streams' S
# ragged handoffs: odd sources and targets, an odd W (the float2-store path)
HANDOFFS_RAGGED = [(2, (239, 320), (479, 641)), (3, (120, 161), (240, 322)),
                   (1, (1, 1), (3, 3))]


def phase_8q(of, dev, card: str) -> dict:
    """The coarse-to-fine handoff kernel (``kernels/upsample_flow``):
    ``torch.equal`` (every bit: NaN, inf and -0.0) to ``upsample_flow_plain``
    at every ``PAPER_1080P`` handoff shape at batches 1, 8 and 54 and on
    ragged shapes; its launches per captured ``PAPER_1080P`` and
    ``TVL1Config()`` call and per warm serving step, and none on the plain
    path nor a plain octave on any family's kernel path; the captured
    ``PAPER_1080P`` replay's device ops; the kernel table's times.  Print one
    line per check; return the numbers for PERF.md."""
    import torch
    import torch.nn.functional as F

    from cuda_optical_flow_2_torch import capture
    from cuda_optical_flow_2_torch.kernels import upsample_flow as uk
    from cuda_optical_flow_2_torch.models import lucas_kanade, tvl1
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    gen = torch.Generator(device=dev).manual_seed(23)

    def flow(b, h, w):
        f = torch.randn((b, h, w, 2), generator=gen, device=dev) * 8.0
        k = min(3, f.numel())
        f.view(-1)[:k] = torch.tensor([math.nan, math.inf, -0.0])[:k]
        return f

    def bits(t):
        return t.view(torch.int32)

    cases = [(b, hw, HW) for b in HANDOFF_BATCHES for hw, HW in HANDOFFS_1080P] + HANDOFFS_RAGGED
    max_abs_err = 0.0  # at the finite values of the plain version
    for b, (h, w), (th, tw) in cases:
        f = flow(b, h, w)
        got = uk.upsample_flow(f, (th, tw))
        want = uk.upsample_flow_plain(f, (th, tw))
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(want)),
                f"8q upsample_flow {b}x{h}x{w} -> {th}x{tw}: not torch.equal to the plain version")
        d = (got - want)[torch.isfinite(want)].abs()
        if d.numel():  # 1x1 -> 3x3 holds only the NaN and the inf
            max_abs_err = max(max_abs_err, float(d.max()))
        del f, got, want, d
    # views: a strided flow is copied in, an 8-byte-aligned offset read as it is
    f = flow(2, 135, 241)
    for label, v in (("transposed", f.transpose(1, 2)), ("offset", f.view(-1)[2:].view(-1)[
            :2 * 134 * 241 * 2].view(2, 134, 241, 2))):
        want = uk.upsample_flow_plain(v, (2 * v.shape[1], 2 * v.shape[2] + 1))
        require(torch.equal(bits(uk.upsample_flow(v, tuple(want.shape[1:3]))), bits(want)),
                f"8q upsample_flow {label} view: not torch.equal to the plain version")
    torch.cuda.synchronize()
    print(f"phase 8q upsample_flow [{card}]: torch.equal (bits) to upsample_flow_plain at "
          f"PAPER_1080P's handoffs {[f'{h}x{w}->{H}x{W}' for (h, w), (H, W) in HANDOFFS_1080P]} "
          f"at batches {HANDOFF_BATCHES}, ragged {[(b, hw, HW) for b, hw, HW in HANDOFFS_RAGGED]}, "
          "a transposed and an offset view")

    # launches: 4 per captured PAPER_1080P / TVL1Config() call and warm step
    def launches(fn):
        capture.settle()
        n0 = uk.upsample_flow.launches
        out = fn()
        torch.cuda.synchronize()
        capture.settle()
        return uk.upsample_flow.launches - n0, out

    seq = synthetic_sequence(6, 1080, 1920, velocity=(2.0, 1.0), period=48)
    frames = [torch.as_tensor(a, device=dev).float() for a in seq]
    p, q = frames[0], frames[1]
    capture.clear()
    counts = {}
    for label, jit, cfg in (("PAPER_1080P", lucas_kanade.pyramidal_lk_jit, of.PAPER_1080P),
                            ("TVL1Config()", tvl1.pyramidal_tvl1_jit, of.TVL1Config())):
        n_first, want = launches(lambda: jit(p, q, cfg))
        n_replay, got = launches(lambda: jit(p, q, cfg))
        eager = jit.eager(p, q, cfg)
        require(n_first == n_replay == 4, f"8q {label}: upsample_flow launches {n_first} "
                                          f"(capturing call), {n_replay} (replay); predicted 4")
        require(torch.equal(got, want) and torch.equal(got, eager),
                f"8q {label}: the replay is not torch.equal to the eager call")
        counts[label] = n_replay
    lk_jit = lucas_kanade.pyramidal_lk_jit
    graph = lk_jit.cache.entries[lk_jit.key(p, q, of.PAPER_1080P)]
    nodes = device_names(graph.replay)
    n_plain, _ = launches(lambda: of.pyramidal_lk(
        p, q, dataclasses.replace(of.PAPER_1080P, use_pallas=False)))
    require(n_plain == 0, f"8q PAPER_1080P use_pallas=False launched upsample_flow {n_plain}x")
    # warm serving steps: 4 streams of PAPER_1080P with recovery, as the benchmark's
    rec = of.RecoveryConfig()
    batch = [torch.stack([fr.roll(40 * s, dims=-1) for s in range(4)]) for fr in frames]
    state = of.init_state(batch[0], of.PAPER_1080P, rec)
    step_counts = []
    for fr in batch[1:]:
        n, (state, _flow) = launches(lambda: of.step(state, fr, of.PAPER_1080P, True, rec))
        step_counts.append(n)
    require(step_counts[1:] == [4] * (len(step_counts) - 1),
            f"8q serving: upsample_flow launches per step {step_counts}; predicted 4 per warm "
            "step")
    # every family's kernel path: its octave handoffs all launch the kernel
    plain_octaves = []
    plain = uk.upsample_flow_plain

    def plain_spy(f, shape):
        if f.is_cuda and uk.is_octave(f.shape, shape):
            plain_octaves.append(tuple(f.shape))
        return plain(f, shape)

    family = {"pyramidal_hs HSConfig()": (of.pyramidal_hs, of.HSConfig(), 2),
              "pyramidal_farneback FBConfig()": (of.pyramidal_farneback, of.FBConfig(), 2),
              "pyramidal_dis DISConfig()": (of.pyramidal_dis, of.DISConfig(), 4),
              "pyramidal_tvl1 TVL1_REALTIME": (of.pyramidal_tvl1, of.TVL1_REALTIME, 3)}
    uk.upsample_flow_plain = plain_spy
    try:
        for label, (entry, cfg, n_want) in family.items():
            n, _ = launches(lambda: entry(p, q, cfg))
            require(n == n_want, f"8q {label}: upsample_flow launches {n}, predicted {n_want}")
            counts[label] = n
    finally:
        uk.upsample_flow_plain = plain
    require(not plain_octaves, f"8q: octave handoffs on a kernel path took the plain stencil: "
                               f"{plain_octaves}")
    print(f"phase 8q upsample_flow launches [{card}]: {counts} per call, warm serving steps "
          f"(4 streams, RecoveryConfig()) {step_counts}; PAPER_1080P use_pallas=False 0; no "
          f"octave handoff of a kernel path on the plain stencil; the captured PAPER_1080P "
          f"replay: {sum('of2_' in n for n in nodes)} of2 kernels of {len(nodes)} device ops")
    capture.clear()

    # the kernel table's row: one 540x960 -> 1080x1920 handoff and a pair's four
    fs = [torch.randn((1, *hw, 2), generator=gen, device=dev) * 8.0 for hw, _ in HANDOFFS_1080P]
    fs_nchw = [f.permute(0, 3, 1, 2).contiguous() for f in fs]
    (h, w), fine = HANDOFFS_1080P[-1]

    def all4(fn):
        return lambda: [fn(f, HW) for f, (_, HW) in zip(fs, HANDOFFS_1080P)]

    def interp(x, size):
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False) * 2.0

    # the library call computes the same function for an even target, in
    # another rounding (a yardstick only: the port never calls it)
    d = float((interp(fs_nchw[3], fine).permute(0, 2, 3, 1)
               - uk.upsample_flow(fs[3], fine)).abs().max())
    require(d <= 1e-4, f"F.interpolate is not upsample_flow's function: max |d| {d}")
    nbytes = [8 * (h * w + H * W) for (h, w), (H, W) in HANDOFFS_1080P]
    out = {}
    for label, kernel, plain_fn, lib, n in (
            (f"{h}x{w} -> {fine[0]}x{fine[1]}", lambda: uk.upsample_flow(fs[3], fine),
             lambda: uk.upsample_flow_plain(fs[3], fine),
             lambda: interp(fs_nchw[3], fine), nbytes[3]),
            ("a PAPER_1080P pair's 4 handoffs", all4(uk.upsample_flow),
             all4(uk.upsample_flow_plain),
             lambda: [interp(x, HW) for x, (_, HW) in zip(fs_nchw, HANDOFFS_1080P)], sum(nbytes))):
        row = {"ms": cuda_ms(kernel, 30, inner=10, device=True),
               "plain_ms": cuda_ms(plain_fn, 30, inner=3, device=True),
               "library_ms": cuda_ms(lib, 30, inner=10, device=True),
               "bound_ms": n / HBM_BYTES_PER_S * 1e3}
        out[label] = row
        print(f"phase 8q timing [{card}] upsample_flow {label}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, F.interpolate(bilinear) x 2 {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms by bytes ({100 * row['bound_ms'] / row['ms']:.1f}"
              " % of the kernel's time)")
    return {"launches": counts, "step_launches": step_counts, "replay_ops": len(nodes),
            "timing": out, "max_abs_err": max_abs_err}


# OpenCV's DISOpticalFlow PRESET_MEDIUM at 1080p
DIS_MEDIUM_FILE = ROOT / "flowbench" / "configs" / "dis_opencv_medium_1080p.json"
# one PRESET_MEDIUM call's launches: 6 pyr_down (the stacked pair, 7 levels); 1
# centered residual and 24 + 5 x 25 = 149 centered steps over the 6 solved
# levels; a warp and an hs_relax per solved level; 5 handoffs between them
# and 1 to the frame size
DIS_MEDIUM_LAUNCHES = {
    "pyr_down.pyr_down.launches": 6,
    "lk_fused.lk_residual.launches": 1, "lk_fused.lk_residual.launches_centered": 1,
    "lk_step_fused.lk_level_step.launches": 149,
    "lk_step_fused.lk_level_step.launches_centered": 149,
    "warp_select.warp_bilinear_select.launches": 6, "hs_sweep.hs_relax.launches": 6,
    "upsample_flow.upsample_flow.launches": 6,
}


def phase_8r(of, dev, card: str) -> dict:
    """OpenCV's DIS PRESET_MEDIUM through the captured entry on an 8-pair
    1080x1920 uint8 batch: the replays ``torch.equal`` to the eager calls,
    the launches of one call, ``capture.stats()``'s per-graph ``launches``,
    the spans, the replay's device ops and the times.  Print one line per
    check; return the numbers for PERF.md."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuda_optical_flow_2_torch import capture
    from cuda_optical_flow_2_torch.models import dis
    from cuda_optical_flow_2_torch.utils import profiling
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    cfg = dis.DISConfig(**json.loads(DIS_MEDIUM_FILE.read_text())["fields"])
    seq = torch.as_tensor(synthetic_sequence(10, 1080, 1920, velocity=(2.0, 1.0), period=48),
                          device=dev)
    batches = [(seq[0:8], seq[1:9]), (seq[1:9], seq[2:10])]
    capture.clear()
    eager, counts = [], []
    for p, q in batches:
        before = capture.snapshot()
        eager.append(dis.pyramidal_dis(p, q, cfg))
        torch.cuda.synchronize()
        counts.append(capture.delta(before, capture.snapshot()))
    require(counts[0] == counts[1] == DIS_MEDIUM_LAUNCHES,
            f"8r DIS_MEDIUM eager launches {counts[0]}, predicted {DIS_MEDIUM_LAUNCHES}")
    jit = dis.pyramidal_dis_jit
    start = capture.snapshot()
    outs = [jit(*batches[i], cfg) for i in (0, 1, 0, 1)]  # the first call captures
    moved = capture.delta(start, capture.snapshot())
    require(all(torch.equal(o, eager[i % 2]) for i, o in enumerate(outs)),
            "8r DIS_MEDIUM: a captured call is not torch.equal to the eager call")
    require(moved == {k: 4 * v for k, v in DIS_MEDIUM_LAUNCHES.items()},
            f"8r DIS_MEDIUM: 4 captured calls moved the counters by {moved}")
    (entry,) = [e for e in capture.stats()["entries"]
                if e["name"].endswith("models.dis.pyramidal_dis")]
    (graph,) = entry["graphs"]
    require(graph["launches"] == DIS_MEDIUM_LAUNCHES and graph["branch_launches"] == []
            and graph["replays"] == 4,
            f"8r DIS_MEDIUM: stats() graph launches {graph['launches']}, replays "
            f"{graph['replays']}")
    print(f"phase 8r DIS_MEDIUM [{card}]: 4 captured calls on 2 batches of 8 pairs torch.equal "
          f"to eager; launches per call {DIS_MEDIUM_LAUNCHES}, stats() launches equal")

    def dis_spans(fn):
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
            torch.cuda.synchronize()
        return sorted(((s.start_ns, s.name, s.attrs) for s in profiling.spans()
                       if s.name.startswith("dis.")), key=lambda t: t[0])

    traced_eager = [(n, a) for _, n, a in dis_spans(lambda: dis.pyramidal_dis(*batches[0], cfg))]
    want = [pair for k in range(6, 0, -1) for pair in (
        ("dis.search", {"level": k, "steps": 25}),
        ("dis.refine", {"level": k, "sweeps": 5, "penalty": "charbonnier"}))]
    require(traced_eager == want, f"8r DIS_MEDIUM eager spans {traced_eager}")
    in_replay = dis_spans(lambda: jit(*batches[0], cfg))
    require(not in_replay, f"8r DIS_MEDIUM: a replay recorded spans {in_replay}")
    profiling.clear_spans()
    key_graph = jit.cache.entries[jit.key(*batches[0], cfg)]
    nodes = device_names(key_graph.replay)
    captured_ms = back_to_back_ms(lambda: jit(*batches[0], cfg), 20) / 8
    eager_ms = back_to_back_ms(lambda: dis.pyramidal_dis(*batches[0], cfg), 3) / 8
    med = [round(float(x), 3) for x in inner_median(eager[0][0])]
    out = {"replay_ops": len(nodes), "of2_ops": sum("of2_" in n for n in nodes),
           "captured_ms_per_pair": captured_ms, "eager_ms_per_pair": eager_ms,
           "pool_mb": sum(graph["pool_bytes"].values()) / 2**20,
           "capture_s": graph["seconds"], "inner_median": med}
    print(f"phase 8r DIS_MEDIUM [{card}]: spans dis.search / dis.refine once per solved level "
          f"eagerly under the profiler, none in a replay; the replay {out['of2_ops']} of2 "
          f"kernels of {out['replay_ops']} device ops, pool {out['pool_mb']:.1f} MB, capture "
          f"{out['capture_s']:.2f} s; ms per pair captured {captured_ms:.4f}, eager "
          f"{eager_ms:.4f} (host clock, 8 pairs per call); inner median flow of pair 0 {med} "
          "(the texture moves (2, 1))")
    capture.clear()
    return out


# --- phase 8s: the LK kernel's geometry ---------------------------------------


def phase_8s(of, dev, card: str) -> dict:
    """The LK kernel: every instance ``torch.equal`` to itself at two forced
    blocks (walker segments, centered tile heights), a band bit-equal to the
    whole image, and the halo factor (``tile_geometry.lk_cells``).  Print one
    line per check; return the halo factors."""
    import torch

    from cuda_optical_flow_2_torch.kernels import _build, lk_fused, lk_step_fused
    from cuda_optical_flow_2_torch.kernels import tile_geometry as tg
    from cuda_optical_flow_2_torch.kernels.lk_fused import kernel_constants
    from cuda_optical_flow_2_torch.models.dis import _lk_like

    dis_lk = _lk_like(of.DISConfig())
    halo, parts = {}, []
    for b, h, w, cfg, centered in ((8, 1080, 1920, of.PAPER_1080P, False),
                                   (8, 540, 960, dis_lk, True)):
        p0, n0, f0 = (torch.as_tensor(a, device=dev) for a in textured_pair(h, w, seed=h + 3))
        p, n, f = (torch.stack([torch.roll(x, (k, 2 * k), (0, 1)) for k in range(b)])
                   for x in (p0, n0, f0))
        r, taps, masks = kernel_constants(cfg)
        rs, tw, seg0 = tg.lk_launch(b, h, w, r, centered)
        # forced blocks: the walker's segments of a step's rows and of the
        # whole image; the centered tile's heights 8 and 24
        geos = [(8, tw, 8), (24, tw, 24)] if centered else [(rs, tw, rs), (rs, tw, h)]
        mode = " centered" if centered else ""
        instances = {
            f"lk_residual{mode}": (lk_fused.lk_residual(p, n, cfg, centered), None),
            f"lk_level_step{mode}": (lk_step_fused.lk_level_step(p, n, f, cfg, centered), f),
            f"lk_band_step{mode}": (lk_step_fused.lk_band_step(p, n, f, 0, cfg, h, centered), f),
        }
        for name, (want, flow) in instances.items():
            for geo in geos:
                got = torch.empty_like(want)
                if flow is None:
                    _build.launch(dev, "of2_lk_residual", p.data_ptr(), n.data_ptr(),
                                  got.data_ptr(), b, h, w, r, *geo, taps.ctypes.data,
                                  masks.ctypes.data, float(cfg.det_eps), int(centered))
                else:
                    _build.launch(dev, "of2_lk_level_step", p.data_ptr(), n.data_ptr(),
                                  flow.data_ptr(), got.data_ptr(), b, h, w, 0, h, r, *geo,
                                  taps.ctypes.data, masks.ctypes.data, float(cfg.det_eps),
                                  float(cfg.max_displacement), int(centered))
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"8s {name} {b}x{h}x{w}: block {geo} not torch.equal to the wrapper's "
                        f"{(rs, tw, seg0)}")
        # a band over the middle half of the rows: rows at least the warp
        # halo from its edges
        margin = r + 2 + int(cfg.max_displacement) + 2
        lo, hi = h // 4 + 17, 3 * h // 4 - 7
        band = lk_step_fused.lk_band_step(p[:, lo:hi].contiguous(), n[:, lo:hi].contiguous(),
                                          f[:, lo:hi].contiguous(), lo, cfg, h, centered)
        torch.cuda.synchronize()
        require(torch.equal(band[:, margin:-margin], instances[f"lk_level_step{mode}"][0][
                    :, lo + margin:hi - margin]),
                f"8s lk_band_step{mode} rows {lo}-{hi} of {b}x{h}x{w}: not bit-equal to the "
                "whole image")
        staged, out = tg.lk_cells(b, h, w, r, centered)
        halo[f"{b}x{h}x{w}{mode}"] = staged / out
        parts.append(f"{b}x{h}x{w} r={r}{mode}: (rs, tw, seg) {(rs, tw, seg0)}, 3 instances "
                     f"torch.equal at {geos[0]} and {geos[1]}, band rows "
                     f"{lo + margin}-{hi - margin} bit-equal, halo factor {staged / out:.4f}")
    print(f"phase 8s LK kernel [{card}]: " + "; ".join(parts))
    return halo


TVL1_LEVELS_1080P = ((1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120))
TVL1_CLUSTERED_CALLS = {8: 10, 1: 5}  # of TVL1Config()'s 25 relaxations at 1080x1920


def phase_8t(of, dev, card: str) -> dict:
    """TV-L1's relaxation in thread-block clusters: the wrapper's launch and
    every compiled cluster shape ``torch.equal`` to the plain versions at
    the benchmark's level shapes, the ragged batch and three 4K bands; the
    counters over eager ``TVL1Config()`` calls; the occupancy and the level
    shapes' times.  Print one line per part; return the level times."""
    import torch

    from cuda_optical_flow_2_torch.kernels import tile_geometry as tg
    from cuda_optical_flow_2_torch.kernels import tvl1_sweep

    tv = of.TVL1Config()
    kw = dict(lambda_=tv.lambda_, theta=tv.theta, tau=tv.tau, eps=tv.epsilon)
    relax, band_relax = tvl1_sweep.tvl1_relax, tvl1_sweep.tvl1_relax_band
    sms = tvl1_sweep.sm_count(dev)
    occupancy = {f"{cx}x{cy}": tvl1_sweep.max_clusters(dev, (cx, cy))
                 for cx, cy in tg.TVL1_CLUSTERS}
    print(f"phase 8t TV-L1 clusters [{card}]: {sms} SMs, cudaOccupancyMaxActiveClusters "
          f"{occupancy}")

    def batch(h, w, b, seed):
        p0, n0, f0 = (torch.as_tensor(a, device=dev) for a in textured_pair(h, w, seed=seed))
        return [torch.stack([torch.roll(x, (k, 2 * k), (0, 1)) for k in range(b)])
                for x in (p0, n0, f0)]

    times, parts = {}, []
    for b, h, w in [(b, h, w) for b in (8, 1) for h, w in TVL1_LEVELS_1080P] + [(2, 479, 641)]:
        p, n, f = batch(h, w, b, seed=h + b)
        flow = f * 0.9
        want = tvl1_sweep.tvl1_relax_plain(p, n, f, flow, iterations=tv.iterations, **kw)
        picked = tg.tvl1_cluster(b, h, w, tvl1_sweep.launch_iterations(tv.iterations)[0], sms)
        before = (relax.launches, relax.launches_clustered)
        got = relax(p, n, f, flow, iterations=tv.iterations, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"8t tvl1_relax {b}x{h}x{w} cluster {picked}: not "
                                        "torch.equal to tvl1_relax_plain")
        require((relax.launches - before[0], relax.launches_clustered - before[1])
                == (1, int(picked != (1, 1))), f"8t tvl1_relax {b}x{h}x{w}: counters")
        for cluster in tg.TVL1_CLUSTERS:
            got = tvl1_sweep._launch(p, n, f, flow, None, 0, h, tv.iterations, cluster=cluster,
                                     **kw)[0]
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"8t tvl1_relax {b}x{h}x{w} forced cluster "
                                            f"{cluster}: not torch.equal to tvl1_relax_plain")
        if h != 479:
            run = {c: (lambda c=c: tvl1_sweep._launch(p, n, f, flow, None, 0, h, tv.iterations,
                                                      cluster=c, **kw)) for c in {(1, 1), picked}}
            times[f"{b}x{h}x{w}"] = {f"{c[0]}x{c[1]}": cuda_ms(fn, 10, device=True)
                                     for c, fn in sorted(run.items())}
        parts.append(f"{b}x{h}x{w} {picked[0]}x{picked[1]}")
    print(f"phase 8t tvl1_relax torch.equal to the plain version through the wrapper (cluster "
          f"named) and in each of {tg.TVL1_CLUSTERS}: " + ", ".join(parts))

    # the bands of a 3-shard split of 2160 x 3840, with the TP path's 10-row halo
    p8, n8, f8 = (x[0] for x in batch(2160, 3840, 1, seed=8))
    rng = np.random.default_rng(8)
    duals = [torch.as_tensor(rng.normal(0, 0.05, (2160, 3840)).astype(np.float32), device=dev)
             for _ in range(4)]
    for row0 in (-10, 710, 1430):  # 740 rows each: 720 and the halo on both sides
        rows = slice(max(row0, 0), min(row0 + 740, 2160))
        pad = (max(-row0, 0), max(row0 + 740 - 2160, 0))

        def cut(x, pad=pad, rows=rows):
            """Band rows, zero past the image's edges."""
            x = x[rows]
            return torch.cat([x.new_zeros((pad[0],) + x.shape[1:]), x,
                              x.new_zeros((pad[1],) + x.shape[1:])]).contiguous()

        args = (cut(p8), cut(n8), cut(f8),
                (cut(f8[..., 0] * 0.5), cut(f8[..., 1] * 0.5), *(cut(d) for d in duals)),
                row0, 2160)
        want = tvl1_sweep.tvl1_relax_band_plain(*args, iterations=8, **kw)
        hb = args[0].shape[0]
        picked = tg.tvl1_cluster(1, hb, 3840, 8, sms)
        before = band_relax.launches_clustered
        got = band_relax(*args, iterations=8, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got, want)),
                f"8t tvl1_relax_band rows {row0}-{row0 + hb}: not torch.equal to the plain band")
        require(band_relax.launches_clustered - before == int(picked != (1, 1)),
                f"8t tvl1_relax_band rows {row0}-{row0 + hb}: counter")
        flow, d = torch.stack(args[3][:2], dim=-1), torch.stack(args[3][2:], dim=-1)
        for cluster in tg.TVL1_CLUSTERS:
            out, dout, _ = tvl1_sweep._launch(*args[:3], flow, d, row0, 2160, 8,
                                              cluster=cluster, **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(a, c) for a, c in zip((*out.unbind(-1), *dout.unbind(-1)),
                                                           want)),
                    f"8t tvl1_relax_band rows {row0}-{row0 + hb} forced cluster {cluster}: "
                    "not torch.equal to the plain band")
    print(f"phase 8t tvl1_relax_band (8 iterations, carried duals) torch.equal to the plain "
          f"band on 3 bands of 2160x3840, cluster {picked}")

    # the counters over one eager TVL1Config() call
    for b, clustered in TVL1_CLUSTERED_CALLS.items():
        p, n, _ = batch(1080, 1920, b, seed=b)
        before = (relax.launches, relax.launches_clustered)
        of.pyramidal_tvl1(p, n, tv)
        torch.cuda.synchronize()
        counts = (relax.launches - before[0], relax.launches_clustered - before[1])
        require(counts == (25, clustered), f"8t TVL1Config() at {b}x1080x1920: tvl1_relax "
                                           f"launches, clustered {counts}, want (25, {clustered})")
        print(f"phase 8t TVL1Config() at {b}x1080x1920: {counts[0]} tvl1_relax calls, "
              f"{counts[1]} clustered")
    print(f"phase 8t device ms per call (30 iterations), plain and clustered: {times}")
    return times


def main(only: str | None = None) -> int:
    if not (ROOT / "cuda_optical_flow_2_torch" / "csrc").is_dir():
        print("chip_smoke: cuda_optical_flow_2_torch/ not found beside this script", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 2

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch import capture
    from cuda_optical_flow_2_torch.constants import BINOMIAL_1D
    from cuda_optical_flow_2_torch.kernels import (
        _build, bilateral_tap, fb_step_fused, hs_sweep, lk_fused, lk_step_fused, median_select,
        occlusion_fill, poly_exp_fused, pyr_down, tvl1_sweep, warp_select, win_solve,
    )
    from cuda_optical_flow_2_torch.kernels import upsample_flow as upsample_kernel
    from cuda_optical_flow_2_torch.models.dis import _lk_like as dis_lk_like
    from cuda_optical_flow_2_torch.models.farneback import fb_normal_eq_products
    from cuda_optical_flow_2_torch.ops.poly_exp import gaussian_1d, mixing_matrix
    from cuda_optical_flow_2_torch.ops.resize import upsample_flow
    from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

    mods = {"lk_fused": lk_fused, "lk_step_fused": lk_step_fused, "warp_select": warp_select,
            "pyr_down": pyr_down, "bilateral_tap": bilateral_tap, "hs_sweep": hs_sweep,
            "poly_exp_fused": poly_exp_fused, "win_solve": win_solve,
            "fb_step_fused": fb_step_fused, "tvl1_sweep": tvl1_sweep,
            "median_select": median_select, "occlusion_fill": occlusion_fill,
            "upsample_flow": upsample_kernel}
    wrappers = {name: getattr(mods[m], name) for name, m, *_ in KERNELS}
    plains = {name: getattr(mods[m], plain) for name, m, plain, *_ in KERNELS}

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 1 device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds():.1f} s, "
          "one process per source)")

    path_launches: dict[str, dict[str, int]] = {}

    def run_path(label: str, fn, needs: tuple[str, ...]):
        """Zero the counters, drive one path, read them: each kernel in
        ``needs`` must have launched."""
        capture.settle()  # replays before the path count before the zero
        for wrapper in wrappers.values():
            wrapper.launches = 0
        for name in CENTERED:
            wrappers[name].launches_centered = 0
        out = fn()
        torch.cuda.synchronize()
        capture.settle()  # the cond branches that replays ran count here
        counts = {name: wrapper.launches for name, wrapper in wrappers.items()}
        counts |= {f"{name} centered": wrappers[name].launches_centered for name in CENTERED}
        for name in needs:
            require(counts[name] > 0, f"path {label} did not launch {name}: {counts}")
        path_launches[label] = counts
        return out, {k: v for k, v in counts.items() if v}

    if only == "8q":
        # 8q alone: the handoff kernel against its plain version, its launches, its times
        phase_8q(of, dev, card)
        print(f"chip_smoke --phase 8q: {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if only == "8r":
        # 8r alone: OpenCV's DIS PRESET_MEDIUM through the captured entry
        phase_8r(of, dev, card)
        print(f"chip_smoke --phase 8r: {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if only == "8s":
        # 8s alone: the LK kernel's geometry
        phase_8s(of, dev, card)
        print(f"chip_smoke --phase 8s: {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if only == "8t":
        # 8t alone: TV-L1's relaxation in thread-block clusters
        phase_8t(of, dev, card)
        print(f"chip_smoke --phase 8t: {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if only == "8p":
        # 8p alone: every multi-device entry on the cards present
        phase_8p(of, dev, run_path, card)
        print(f"chip_smoke --phase 8p: {time.perf_counter() - t_start:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0


    def cuda(a):
        return torch.as_tensor(a, device=dev)

    # 3. kernels against their plain versions on the card
    max_err = {name: 0.0 for name, *_ in KERNELS} | {f"{n} centered": 0.0 for n in CENTERED}

    def check(name, got, want, h, w, label=""):
        torch.cuda.synchronize()
        what = f"{name} {h}x{w} {label}".strip()
        if name == "median_filter_kernel":
            # a selection returns one of its inputs: bit-equal, NaN where the
            # plain median is NaN (torch.equal treats -0.0 and +0.0 as equal)
            nan = want.isnan()
            require(torch.equal(got.isnan(), nan), f"{what}: NaN at other positions")
            require(torch.equal(got[~nan], want[~nan]), f"{what}: not torch.equal to the plain "
                                                       f"median, max |d| {float((got - want).abs().max())}")
            return f"{name} {label} torch.equal"
        e = err_stats(got, want)
        max_err[name] = max(max_err[name], e["max"])
        if name == "poly_expansion_kernel":
            d = (got - want).abs() - POLY_RTOL * want.abs()
            torch.cuda.synchronize()
            excess = float(d.max())
            require(excess <= POLY_ATOL, f"{what}: |d| - rtol |plain| {excess} > {POLY_ATOL}")
            return f"{name}{' ' + label if label else ''} max {e['max']:.3g}"
        image_limits = {"warp_bilinear_select": WARP_MAX_ERR, "pyr_down": PYR_MAX_ERR,
                        "bilateral_kernel": BILATERAL_MAX_ERR,
                        "warp_bilinear_select_band": WARP_MAX_ERR,
                        "bilateral_kernel_band": BILATERAL_MAX_ERR}
        if name in image_limits:
            limit = image_limits[name]
            require(e["max"] <= limit, f"{what}: max |d| {e['max']} > {limit}")
            return f"{name}{' ' + label if label else ''} max {e['max']:.3g}"
        median, p999 = {"lk_residual": (LK_MEDIAN_ERR, LK_P999_ERR),
                        "lk_level_step": (LK_MEDIAN_ERR, LK_P999_ERR),
                        "lk_residual centered": (CENTERED_MEDIAN_ERR, CENTERED_P999_ERR),
                        "lk_level_step centered": (CENTERED_MEDIAN_ERR, CENTERED_P999_ERR),
                        "lk_band_step": (LK_MEDIAN_ERR, LK_P999_ERR),
                        "lk_band_step centered": (CENTERED_MEDIAN_ERR, CENTERED_P999_ERR),
                        "hs_relax_band": (HS_MEDIAN_ERR, HS_P999_ERR),
                        "tvl1_relax": (TVL1_MEDIAN_ERR, TVL1_P999_ERR),
                        "tvl1_relax_band": (TVL1_MEDIAN_ERR, TVL1_P999_ERR),
                        "fb_band_step": (FB_STEP_MEDIAN_ERR, FB_STEP_P999_ERR),
                        "hs_relax": (HS_MEDIAN_ERR, HS_P999_ERR),
                        "fb_level_step": (FB_STEP_MEDIAN_ERR, FB_STEP_P999_ERR),
                        "window_solve": (WIN_SOLVE_MEDIAN_ERR, WIN_SOLVE_P999_ERR)}[name]
        require(e["median"] <= median and e["p999"] <= p999, f"{what}: {e}")
        return (f"{name}{' ' + label if label else ''} median {e['median']:.3g} "
                f"p99.9 {e['p999']:.3g} max {e['max']:.3g}")

    def as_bits(x):
        return x.contiguous().view(torch.int32)

    def check_fill(flow, occ, label, iterations=96, beta=1.0):
        """The occlusion fill kernel against its plain version on the same
        inputs: bitwise equal, NaN and -0.0 included, or the filled pixels
        within FILL_MAX_ERR; the matched pixels bitwise the input."""
        name = "fill_occluded_flow_kernel"
        got = occlusion_fill.fill_occluded_flow_kernel(flow, occ, iterations, beta)
        want = occlusion_fill.fill_occluded_flow_plain(flow, occ, iterations, beta)
        torch.cuda.synchronize()
        what = f"{name} {label} iterations {iterations} beta {beta}"
        require(torch.equal(as_bits(got[~occ]), as_bits(flow.float()[~occ])),
                f"{what}: a matched pixel is not bitwise the input")
        nan = want.isnan()
        require(torch.equal(got.isnan(), nan), f"{what}: NaN at other positions")
        if torch.equal(as_bits(got[~nan]), as_bits(want[~nan])):
            return f"{label} {iterations} sweeps beta {beta} bit-equal"
        d = float((got - want)[~nan].abs().max())
        max_err[name] = max(max_err[name], d)
        require(d <= FILL_MAX_ERR, f"{what}: max |d| {d} > {FILL_MAX_ERR}")
        return f"{label} {iterations} sweeps beta {beta} max |d| {d:.3g} (not bit-equal)"

    cases = [
        ((1080, 1920), of.PAPER_1080P),
        ((480, 640), of.LKConfig(levels=4, window=19)),
        ((480, 640), of.LKConfig(levels=4, window=19, window_weights="box")),
        ((480, 640), of.LKConfig(levels=4, window=19, window_weights="gauss")),
    ]
    for (h, w), cfg in cases:
        p, n, f = (cuda(a) for a in textured_pair(h, w, seed=h))
        parts = []
        for name, args in {
            "warp_bilinear_select": (p, f, cfg.max_displacement),
            "lk_residual": (p, n, cfg),
            "lk_level_step": (p, n, f, cfg),
        }.items():
            parts.append(check(name, wrappers[name](*args), plains[name](*args), h, w,
                               cfg.window_weights))
        print(f"phase 3 kernels {h}x{w} window {cfg.window} {cfg.window_weights}: "
              + "; ".join(parts))
    # TV-L1's relaxation, warm (next warped by the textured pair's flow,
    # linearized there), and the centered (DIS) LK modes at the DIS default
    # (9x9 box, dt3), at the TV-L1 and DIS paths' level-0 shape
    p, n, f = (cuda(a) for a in textured_pair(1080, 1920, seed=5))
    warped = warp_select.warp_bilinear_select_plain(n, f)
    tv = of.TVL1Config()
    tvl1_kw = dict(iterations=tvl1_sweep.MAX_ITERS, lambda_=tv.lambda_, theta=tv.theta,
                   tau=tv.tau, eps=tv.epsilon)
    dis_lk = dis_lk_like(of.DISConfig())
    parts = [
        check("tvl1_relax", tvl1_sweep.tvl1_relax(p, warped, f, f, **tvl1_kw),
              tvl1_sweep.tvl1_relax_plain(p, warped, f, f, **tvl1_kw), 1080, 1920,
              "warm 14 iterations"),
        check("tvl1_relax", tvl1_sweep.tvl1_relax(p, warped, f, f * 0.9, **dict(tvl1_kw, iterations=30)),
              tvl1_sweep.tvl1_relax_plain(p, warped, f, f * 0.9, **dict(tvl1_kw, iterations=30)),
              1080, 1920, "30 iterations from another flow"),
        check("lk_residual centered", lk_fused.lk_residual(p, n, dis_lk, centered=True),
              lk_fused.lk_residual_plain(p, n, dis_lk, centered=True), 1080, 1920, "9x9 box"),
        check("lk_level_step centered", lk_step_fused.lk_level_step(p, n, f, dis_lk, centered=True),
              lk_step_fused.lk_level_step_plain(p, n, f, dis_lk, centered=True), 1080, 1920,
              "9x9 box"),
    ]
    print("phase 3 kernels 1080x1920 TV-L1 and DIS: " + "; ".join(parts))
    # the time-tiled relaxations on a ragged batch (no tile or launch depth
    # divides the shape or the counts): TV-L1 bit-equal, HS within its limits;
    # the bands reach past both edges of the global image
    trip = [textured_pair(479, 641, seed=11 + i) for i in range(2)]
    rp, rn, rf = (cuda(np.stack([t[j] for t in trip])) for j in range(3))
    rw = warp_select.warp_bilinear_select_plain(rn, rf)
    rng_r = np.random.default_rng(12)
    rstate = (rf[..., 0] * 0.5, rf[..., 1] * 0.5,
              *(cuda(rng_r.normal(0, 0.05, (2, 479, 641)).astype(np.float32)) for _ in range(4)))
    roff = cuda(np.random.default_rng(13).normal(0, 5, (2, 479, 641)).astype(np.float32))
    rhs = dict(alpha=10.0, temporal_kernel="gauss3")
    ragged = [
        ("tvl1_relax", "13 iterations", (rp, rw, rf, rf * 0.9), dict(tvl1_kw, iterations=13)),
        ("tvl1_relax", "30 iterations", (rp, rw, rf, rf * 0.9), dict(tvl1_kw, iterations=30)),
        ("tvl1_relax_band", "rows -6-473 of 470, 13 iterations carried duals",
         (rp, rw, rf, rstate, -6, 470), dict(tvl1_kw, iterations=13)),
        ("hs_relax", "quadratic 100 sweeps", (rp, rn, None), dict(rhs, iterations=100)),
        ("hs_relax", "charbonnier it_offset 37 sweeps", (rp, rn, rf * 0.1),
         dict(rhs, iterations=37, robust=(3.0, 0.1), it_offset=roff)),
        ("hs_relax_band", "rows -6-473 of 470, charbonnier it_offset 11 sweeps",
         (rp, rn, rf * 0.1, -6, 470), dict(rhs, sweeps=11, robust=(3.0, 0.1), it_offset=roff)),
    ]
    parts = []
    for name, label, args, kw in ragged:
        got, want = wrappers[name](*args, **kw), plains[name](*args, **kw)
        if name == "tvl1_relax_band":  # the six state planes
            got, want = torch.stack(got), torch.stack(want)
        parts.append(check(name, got, want, 479, 641, f"batch 2 {label}"))
        if name.startswith("tvl1"):
            bits = float((got - want).abs().max())
            require(bits == 0.0, f"{name} 2x479x641 {label}: max |d| {bits}, expected bit-equal")
    print("phase 3 kernels ragged 2x479x641 time-tiled relaxations: " + "; ".join(parts))
    # lk_level_step flow_half: the coarser level's flow (half the textured
    # pair's, in its own pixel units), handed over by the upsample kernel,
    # must give the bits of the step on upsample_flow of it, and stay within
    # the step's limits of the plain version
    parts = []
    for (b, h, w), cfg, centered, label in (
        ((1, 1080, 1920), of.PAPER_1080P, False, "15x15 tri"),
        ((1, 1080, 1920), dis_lk, True, "9x9 box centered"),
        ((2, 540, 960), of.PAPER_1080P, False, "15x15 tri batch 2"),
    ):
        trip = [textured_pair(h, w, seed=h + 2 + i) for i in range(b)]
        p, n, half = (cuda(np.stack([t[j] if j < 2 else t[2][::2, ::2] * 0.5 for t in trip]))
                      for j in range(3))
        if b == 1:
            p, n, half = p[0], n[0], half[0]
        got = lk_step_fused.lk_level_step(p, n, half, cfg, centered, flow_half=True)
        full = lk_step_fused.lk_level_step(p, n, upsample_flow(half, (h, w)), cfg, centered)
        torch.cuda.synchronize()
        bits = float((got - full).abs().max())
        require(bits == 0.0, f"lk_level_step flow_half {label} {b}x{h}x{w}: max |d| {bits} from "
                             "the step on upsample_flow, expected bit-equal")
        plain = lk_step_fused.lk_level_step_plain(p, n, half, cfg, centered, flow_half=True)
        parts.append(check("lk_level_step centered" if centered else "lk_level_step", got, plain,
                           h, w, f"flow_half {label} {b}x{h}x{w}, bit-equal to upsample_flow + "
                           "step"))
    print("phase 3 kernels lk_level_step flow_half: " + "; ".join(parts))
    # the edges of the window kernels' tile geometry (kernels/tile_geometry.py
    # picks a tile per radius; FB's largest window and expansion are the
    # 33x33 poly_n=31 cases below): the largest LK window in both modes and
    # the 1x1 window on the ragged batch (no tile divides 2x479x641), FB's
    # default and 1x1 windows there, first and warm, and flow_half at a
    # ragged even size; each kernel's rows of a band bit-equal
    # to its whole-image rows at the 1x1 windows.  A 1x1 LK window's A is
    # rank one (det 0 in exact arithmetic, and in the rounded products of
    # both versions); a 1x1 FB window solves each pixel's own expansion,
    # whose det(A)^2 nears 0 at saddle points, where 1/det turns the
    # expansions' float order into any flow: det_eps = 1.0 (intensities
    # 0-255) leaves those pixels to the guard in both versions.
    parts = []
    for window, centered in ((65, False), (65, True), (1, False), (1, True)):
        cfg = of.LKConfig(levels=1, window=window, window_weights="box" if centered else "tri")
        mode = " centered" if centered else ""
        label = f"batch 2 window {window}"
        parts.append(check(f"lk_residual{mode}", lk_fused.lk_residual(rp, rn, cfg, centered),
                           lk_fused.lk_residual_plain(rp, rn, cfg, centered), 479, 641, label))
        parts.append(check(f"lk_level_step{mode}",
                           lk_step_fused.lk_level_step(rp, rn, rf, cfg, centered),
                           lk_step_fused.lk_level_step_plain(rp, rn, rf, cfg, centered), 479, 641,
                           label))
        if window == 1:
            whole = lk_step_fused.lk_level_step(rp, rn, rf, cfg, centered)
            band = lk_step_fused.lk_band_step(rp[:, 100:300], rn[:, 100:300], rf[:, 100:300], 100,
                                              cfg, 479, centered)
            torch.cuda.synchronize()
            bits = float((band[:, 40:-40] - whole[:, 140:260]).abs().max())
            require(bits == 0.0, f"lk_band_step{mode} window 1 rows 140-260 of 2x479x641: "
                                 f"max |d| {bits} from the whole image, expected bit-equal")
    for cfg in (of.FBConfig(), of.FBConfig(winsize=1, poly_n=5, poly_sigma=1.1, det_eps=1.0)):
        for first in (True, False):
            exp_c = poly_exp_fused.poly_expansion_plain(rp, cfg.poly_n, cfg.poly_sigma)
            parts.append(check(
                "fb_level_step", fb_step_fused.fb_level_step(rn, exp_c, rf, cfg, first),
                fb_step_fused.fb_level_step_plain(rn, exp_c, rf, cfg, first), 479, 641,
                f"batch 2 {cfg.winsize}x{cfg.winsize} poly_n={cfg.poly_n} "
                f"{'first' if first else 'warm'}"))
            if cfg.winsize == 1:
                whole = fb_step_fused.fb_level_step(rn, exp_c, rf, cfg, first)
                sl = slice(100, 300)
                band = fb_step_fused.fb_band_step(rn[:, sl], tuple(e[:, sl] for e in exp_c),
                                                  rf[:, sl], 100, cfg, 479, first)
                torch.cuda.synchronize()
                bits = float((band[:, 40:-40] - whole[:, 140:260]).abs().max())
                require(bits == 0.0, f"fb_band_step 1x1 rows 140-260 of 2x479x641: max |d| "
                                     f"{bits} from the whole image, expected bit-equal")
    for centered in (False, True):
        cfg = dis_lk if centered else of.PAPER_1080P
        h, w = 478, 642  # even, and no tile divides it
        trip = [textured_pair(h, w, seed=h + 7 + i) for i in range(2)]
        p, n, half = (cuda(np.stack([t[j] if j < 2 else t[2][::2, ::2] * 0.5 for t in trip]))
                      for j in range(3))
        got = lk_step_fused.lk_level_step(p, n, half, cfg, centered, flow_half=True)
        full = lk_step_fused.lk_level_step(p, n, upsample_flow(half, (h, w)), cfg, centered)
        torch.cuda.synchronize()
        bits = float((got - full).abs().max())
        require(bits == 0.0, f"lk_level_step flow_half 2x{h}x{w}: max |d| {bits} from the step "
                             "on upsample_flow, expected bit-equal")
        plain = lk_step_fused.lk_level_step_plain(p, n, half, cfg, centered, flow_half=True)
        parts.append(check("lk_level_step centered" if centered else "lk_level_step", got, plain,
                           h, w, "flow_half batch 2, bit-equal to upsample_flow + step"))
    print("phase 3 kernels tile edges (ragged batch 2x479x641: LK window 65 and 1, FB 15 and 1; "
          "flow_half 2x478x642): " + "; ".join(parts))
    # the bilateral's 32 x 32 and the expansion's 20 x 128 tiles on the
    # ragged batch (no tile divides it): the bilateral at window 9 (compiled
    # in) and 31 (generic) on the whole image and on bands past the top
    # (row0 < 0) and past the bottom (row0 + H > Hg), where taps outside the
    # global image must weigh nothing; the expansion at poly_n 5, 7 (compiled
    # in) and 31
    parts = []
    for window in (9, 31):
        inst = "compiled in" if bilateral_tap.compiled_in(window) else "generic"
        parts.append(check("bilateral_kernel", bilateral_tap.bilateral_kernel(rp, window),
                           bilateral_tap.bilateral_kernel_plain(rp, window), 479, 641,
                           f"batch 2 {window}x{window} ({inst})"))
        for row0, hg in ((-7, 600), (150, 500)):
            parts.append(check(
                "bilateral_kernel_band", bilateral_tap.bilateral_kernel_band(rp, row0, hg, window),
                bilateral_tap.bilateral_kernel_band_plain(rp, row0, hg, window), 479, 641,
                f"batch 2 rows {row0}-{row0 + 479} of {hg} {window}x{window} ({inst})"))
    for n_poly, sigma in ((5, 1.1), (7, 1.5), (31, 5.0)):
        inst = "compiled in" if poly_exp_fused.compiled_in(n_poly) else "generic"
        parts.append(check(
            "poly_expansion_kernel",
            torch.stack(poly_exp_fused.poly_expansion_kernel(rp, n_poly, sigma)),
            torch.stack(poly_exp_fused.poly_expansion_plain(rp, n_poly, sigma)), 479, 641,
            f"batch 2 poly_n={n_poly} ({inst})"))
    print("phase 3 kernels tile edges of the bilateral and the expansion (ragged batch "
          "2x479x641): " + "; ".join(parts))
    # TV-L1's median, a selection, torch.equal to the plain median at sizes 3
    # and 5: on the 1080x1920 flow view TV-L1 hands it (flow.movedim(-1, 0),
    # strides (1, 2W, 2); the output keeps the flow's layout), on contiguous
    # planes, on the ragged batch (no tile divides it), on the bands of a
    # 3-shard TP split with their edge-replicated halos (the TP path's
    # shard-local median), and with NaN and +-inf in some windows
    from cuda_optical_flow_2_torch.parallel.spatial import halo_exchange

    fm = cuda(textured_pair(1080, 1920, seed=9)[2])
    odd = fm.clone()
    odd[500, 700, 0], odd[3, 3, 1], odd[1079, 0, 0] = float("nan"), float("inf"), -float("inf")
    parts = []
    for size in median_select.SIZES:
        view = fm.movedim(-1, 0)
        got = median_select.median_filter_kernel(view, size)
        require(got.movedim(0, -1).is_contiguous(), "median of the flow view lost the flow layout")
        cases = [("1080x1920 flow view", view, got),
                 ("1080x1920 planes", view.contiguous(), None),
                 ("1080x1920 flow view NaN +-inf", odd.movedim(-1, 0), None),
                 ("ragged batch 2x479x641 images", rp, None),
                 ("ragged batch 2x2x479x641 flow planes", rf.movedim(-1, 1), None)]
        rm = size // 2
        for i, b in enumerate(halo_exchange(list(view.chunk(3, dim=-2)), rm, rm, boundary="edge")):
            cases.append((f"TP band {i} of 3 with {rm} edge rows", b, None))
        for label, x, out in cases:
            out = median_select.median_filter_kernel(x, size) if out is None else out
            parts.append(check("median_filter_kernel", out,
                               median_select.median_filter_plain(x, size), *x.shape[-2:],
                               f"{size}x{size} {label}"))
    print("phase 3 kernels median_filter_kernel: " + "; ".join(parts))
    # the occlusion fill on a ragged batch of random disks (no tile divides
    # it; a NaN and -0.0 under the mask, a NaN at a kept pixel) at sweep
    # counts that split into launches of 1, 7, 8, 5 + 4 and 12 x 8, and 0
    rflow, rocc = (cuda(a) for a in fill_scene(2, 479, 641, "blobs", 13))
    parts = [check_fill(rflow, rocc, "batch 2", n, beta)
             for beta in (0.0, 1.0) for n in (0, 1, 7, 8, 9, 96)]
    print("phase 3 kernels ragged 2x479x641 fill_occluded_flow_kernel: " + "; ".join(parts))
    # the window solve bit-equal on the ragged batch (no tile divides it) at
    # windows 1, 15 (compiled in) and 33; FB at winsize 33, poly_n 31 there
    # is off its float32 plain version by the expansion's conditioning
    # (median 3.7e-4 px, past FB_STEP_MEDIAN_ERR): in place of that median
    # limit both float32 versions are held against a float64 run of the
    # plain version, and the kernel's median distance from it may be no
    # larger than the float32 plain version's; FB_STEP_P999_ERR holds the
    # kernel against the float32 plain version as everywhere
    rprods = fb_normal_eq_products(poly_exp_fused.poly_expansion_plain(rp, 7, 1.5),
                                   poly_exp_fused.poly_expansion_plain(rn, 7, 1.5),
                                   rf[..., 0], rf[..., 1])
    parts = []
    for window in (1, 15, 33):
        got = win_solve.window_solve(*rprods, window=window)
        want = win_solve.window_solve_plain(*rprods, window=window)
        parts.append(check("window_solve", got, want, 479, 641, f"batch 2 {window}x{window}"))
        require(torch.equal(got, want), f"window_solve 2x479x641 {window}x{window}: not bit-equal")
    cfg = of.FBConfig(winsize=33, poly_n=31, poly_sigma=5.0)
    exp32 = poly_exp_fused.poly_expansion_plain(rp, cfg.poly_n, cfg.poly_sigma)
    exp64 = poly_exp_fused.poly_expansion_plain(rp.double(), cfg.poly_n, cfg.poly_sigma)
    for first in (True, False):
        ref = fb_step_fused.fb_level_step_plain(rn.double(), exp64, rf.double(), cfg, first,
                                                dtype=torch.float64)
        got = fb_step_fused.fb_level_step(rn, exp32, rf, cfg, first)
        plain = fb_step_fused.fb_level_step_plain(rn, exp32, rf, cfg, first)
        e_k, e_p, e_kp = err_stats(got, ref), err_stats(plain, ref), err_stats(got, plain)
        mode = "first" if first else "warm"
        require(e_k["median"] <= e_p["median"],
                f"fb_level_step 2x479x641 33x33 poly_n=31 {mode}: kernel {e_k} farther from the "
                f"float64 plain run than the float32 plain version {e_p}")
        require(e_kp["p999"] <= FB_STEP_P999_ERR,
                f"fb_level_step 2x479x641 33x33 poly_n=31 {mode}: kernel vs plain {e_kp}")
        max_err["fb_level_step"] = max(max_err["fb_level_step"], e_kp["max"])
        parts.append(f"fb_level_step batch 2 33x33 poly_n=31 {mode} from float64: kernel median "
                     f"{e_k['median']:.3g} p99.9 {e_k['p999']:.3g}, float32 plain median "
                     f"{e_p['median']:.3g} p99.9 {e_p['p999']:.3g}; kernel vs plain median "
                     f"{e_kp['median']:.3g} p99.9 {e_kp['p999']:.3g}")
    print("phase 3 kernels ragged 2x479x641 window solve and FB 33/31: " + "; ".join(parts))
    rng = np.random.default_rng(3)
    for h, w in ((1080, 1920), (480, 640)):
        p, n, f = (cuda(a) for a in textured_pair(h, w, seed=h + 1))
        pair = torch.stack([p, n])
        parts = [
            check("pyr_down", pyr_down.pyr_down(pair), pyr_down.pyr_down_plain(pair), h, w, "pair"),
            check("pyr_down", pyr_down.pyr_down(f[..., 0]),
                  pyr_down.pyr_down_plain(f[..., 0].contiguous()), h, w, "flow[..., 0] view"),
            check("bilateral_kernel", bilateral_tap.bilateral_kernel(pair, 9),
                  bilateral_tap.bilateral_kernel_plain(pair, 9), h, w, "9x9"),
        ]
        if h == 480:
            u8, guide = pair.to(torch.uint8), pair.flip(0)
            parts.append(check(
                "bilateral_kernel", bilateral_tap.bilateral_kernel(u8, 19, 3.0, 20.0, guide),
                bilateral_tap.bilateral_kernel_plain(u8, 19, 3.0, 20.0, guide), h, w,
                "19x19 uint8 guided"))
        off = cuda(rng.normal(0, 5, (h, w)).astype(np.float32))
        base = dict(iterations=100, alpha=10.0, temporal_kernel="gauss3")
        for label, init, kw in (
            ("quadratic", None, base),
            ("charbonnier it_offset", f * 0.1, dict(base, robust=(3.0, 0.1), it_offset=off)),
        ):
            parts.append(check("hs_relax", hs_sweep.hs_relax(p, n, init, **kw),
                               hs_sweep.hs_relax_plain(p, n, init, **kw), h, w, label))
        print(f"phase 3 kernels {h}x{w}: " + "; ".join(parts))
        # Farnebäck: the expansion of the pair, the window solve of the
        # products of the two expansions, the fused step first and warm
        parts = []
        for n_poly, sigma in ((7, 1.5), (5, 1.1)):
            parts.append(check(
                "poly_expansion_kernel",
                torch.stack(poly_exp_fused.poly_expansion_kernel(pair, n_poly, sigma)),
                torch.stack(poly_exp_fused.poly_expansion_plain(pair, n_poly, sigma)), h, w,
                f"poly_n={n_poly} pair"))
        exp1 = poly_exp_fused.poly_expansion_plain(p, 7, 1.5)
        exp2 = poly_exp_fused.poly_expansion_plain(n, 7, 1.5)
        prods = fb_normal_eq_products(exp1, exp2, f[..., 0], f[..., 1])
        for window, det_eps in ((1, 1e-6), (15, 1e-6), (33, 1e-6), (9, 0.0)):
            if det_eps <= 0:
                # the unguarded division's inf/NaN pixels agree by position
                got = win_solve.window_solve(*prods, window=window, det_eps=det_eps)
                want = win_solve.window_solve_plain(*prods, window=window, det_eps=det_eps)
                require(bool((torch.isfinite(got) == torch.isfinite(want)).all()),
                        f"window_solve {h}x{w} det_eps=0: non-finite pixels differ")
                if not bool(torch.isfinite(want).all()):
                    continue
            got = win_solve.window_solve(*prods, window=window, det_eps=det_eps)
            want = win_solve.window_solve_plain(*prods, window=window, det_eps=det_eps)
            parts.append(check("window_solve", got, want, h, w,
                               f"{window}x{window} det_eps={det_eps}"))
            require(torch.equal(got, want), f"window_solve {h}x{w} {window}x{window}: not "
                                            "bit-equal to its plain version")
        for cfg in (of.FBConfig(), of.FBConfig(winsize=33, poly_n=31, poly_sigma=5.0),
                    of.FBConfig(winsize=9, poly_n=5, poly_sigma=1.1, max_displacement=8)):
            for first in (True, False):
                parts.append(check(
                    "fb_level_step", fb_step_fused.fb_level_step(n, exp1, f, cfg, first),
                    fb_step_fused.fb_level_step_plain(n, exp1, f, cfg, first), h, w,
                    f"{cfg.winsize}x{cfg.winsize} poly_n={cfg.poly_n} "
                    f"{'first' if first else 'warm'}"))
        print(f"phase 3 kernels {h}x{w} Farnebäck: " + "; ".join(parts))

    # 4. path PAPER_1080P at 1080x1920
    # Period 48 px: 3 px at the fifth level.  The default 16 px is 1 px there,
    # aliases, and sends any 5-level LK (the JAX package's too) off (2, 1).
    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48)
    prev, nxt = cuda(fr[0]).float(), cuda(fr[1]).float()
    flow, counts = run_path("PAPER_1080P", lambda: of.pyramidal_lk(prev, nxt, of.PAPER_1080P),
                            ("lk_residual", "lk_level_step", "pyr_down", "upsample_flow"))
    plain_cfg = dataclasses.replace(of.PAPER_1080P, use_pallas=False)
    flow_plain = of.pyramidal_lk(prev, nxt, plain_cfg)
    require(tuple(flow.shape) == (1080, 1920, 2), f"flow shape {tuple(flow.shape)}")
    e = err_stats(flow, flow_plain)
    m = inner_median(flow)
    require(abs(m[0] - 2.0) <= TRANSLATION_TOL and abs(m[1] - 1.0) <= TRANSLATION_TOL,
            f"inner median flow {m}, expected (2, 1)")
    require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
            f"kernel path vs plain path: {e}")
    print(f"phase 4 pyramidal_lk PAPER_1080P 1080x1920: inner median flow ({m[0]:.4f}, "
          f"{m[1]:.4f}); vs plain path median {e['median']:.3g} p99 {e['p99']:.3g} "
          f"max {e['max']:.3g}; launches {counts}")

    # 5. path entry config
    p5 = cuda(rng.integers(0, 256, (480, 640)).astype(np.float32))
    n5 = cuda(rng.integers(0, 256, (480, 640)).astype(np.float32))
    f5, counts = run_path("entry", lambda: of.pyramidal_lk(p5, n5, of.LKConfig(levels=4, window=19)),
                          ("lk_residual", "lk_level_step", "pyr_down"))
    require(tuple(f5.shape) == (480, 640, 2), f"entry flow shape {tuple(f5.shape)}")
    require(bool(torch.isfinite(f5).all()), "entry flow not finite")
    print(f"phase 5 entry LKConfig(levels=4, window=19) 480x640: shape {tuple(f5.shape)}, "
          f"finite, mean |flow| {f5.abs().mean().item():.4f}; launches {counts}")

    # 6. path serving loop with warm start and scene-cut recovery
    frames = scene_frames(1080, 1920)
    serve_cfg = of.LKConfig(levels=1, window=15)
    recovery = of.RecoveryConfig(levels=3)
    flows, counts = run_path("serving", lambda: dict(of.process_sequence(
        (None if f is None else cuda(f) for f in frames), serve_cfg,
        warm_start=True, recovery=recovery,
    )), ("lk_level_step", "warp_bilinear_select", "pyr_down", "upsample_flow"))
    require(sorted(flows) == [1, 2, 3, 4, 5, 6], f"yielded frames {sorted(flows)}")
    require(all(bool(torch.isfinite(f).all()) for f in flows.values()), "serving flow not finite")
    cold = of.pyramidal_lk(cuda(frames[4]).float(), cuda(frames[5]).float(),
                           dataclasses.replace(serve_cfg, levels=recovery.levels))
    e_cut = err_stats(flows[5], cold)
    require(e_cut["median"] <= PATH_MEDIAN_ERR, f"flow at the cut vs cold levels=3: {e_cut}")
    m3 = inner_median(flows[3])
    print(f"phase 6 serving loop levels=1 warm + RecoveryConfig(levels=3), 8 frames 1080x1920: "
          f"yielded {sorted(flows)}; cut vs cold median {e_cut['median']:.3g}; warm median "
          f"flow at 3 ({m3[0]:.4f}, {m3[1]:.4f}); launches {counts}")

    # 7. path REFERENCE_GPU: bilateral prefilter, 4 levels, 19x19 box, raw gains
    ref = of.REFERENCE_GPU
    ref_plain = dataclasses.replace(ref, use_pallas=False)
    ref_pairs = {}
    for h, w in ((480, 640), (1080, 1920)):
        fr = synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=48)
        rp, rn = cuda(fr[0]).float(), cuda(fr[1]).float()
        ref_pairs[(h, w)] = (rp, rn)
        flow, counts = run_path(f"REFERENCE_GPU {h}x{w}", lambda: of.pyramidal_lk(rp, rn, ref),
                                ("bilateral_kernel", "pyr_down", "lk_residual", "lk_level_step"))
        require(tuple(flow.shape) == (h, w, 2), f"flow shape {tuple(flow.shape)}")
        e = err_stats(flow, of.pyramidal_lk(rp, rn, ref_plain))
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"REFERENCE_GPU {h}x{w} kernel path vs plain path: {e}")
        print(f"phase 7 pyramidal_lk REFERENCE_GPU {h}x{w}: vs plain path median "
              f"{e['median']:.3g} p99 {e['p99']:.3g} max {e['max']:.3g}; launches {counts}")
    seq = [f.astype(np.uint8) for f in synthetic_sequence(8, 480, 640, velocity=(2.0, 1.0),
                                                          period=48)]
    # numpy frames and no device argument: the loop runs on the card
    flows, counts = run_path("REFERENCE_GPU process_sequence",
                             lambda: dict(of.process_sequence(seq, ref)),
                             ("bilateral_kernel", "pyr_down", "lk_residual", "lk_level_step"))
    flows_plain = dict(of.process_sequence(seq, ref_plain))
    require(sorted(flows) == sorted(flows_plain) == list(range(1, 8)),
            f"yielded frames {sorted(flows)}")
    require(all(f.device.type == "cuda" for f in flows.values()), "process_sequence left the card")
    worst = max((err_stats(flows[i], flows_plain[i]) for i in flows), key=lambda s: s["p99"])
    require(worst["median"] <= PATH_MEDIAN_ERR and worst["p99"] <= PATH_P99_ERR,
            f"REFERENCE_GPU process_sequence kernel vs plain: {worst}")
    print(f"phase 7 process_sequence REFERENCE_GPU 8 numpy uint8 frames 480x640 (cold, on "
          f"{flows[1].device}): yielded {sorted(flows)}; worst pair vs plain median "
          f"{worst['median']:.3g} p99 {worst['p99']:.3g}; launches {counts}")
    pf_cfg = of.LKConfig(levels=4, window=19, prefilter=of.BilateralConfig())
    fr = synthetic_sequence(2, 480, 640, velocity=(2.0, 1.0), period=48)
    tp, tn = cuda(fr[0]).float(), cuda(fr[1]).float()
    flow, counts = run_path("prefiltered LK", lambda: of.pyramidal_lk(tp, tn, pf_cfg),
                            ("bilateral_kernel", "pyr_down"))
    m = inner_median(flow)
    require(abs(m[0] - 2.0) <= TRANSLATION_TOL and abs(m[1] - 1.0) <= TRANSLATION_TOL,
            f"prefiltered LK inner median flow {m}, expected (2, 1)")
    print(f"phase 7 LKConfig(levels=4, window=19, prefilter=BilateralConfig()) 480x640 period 48: "
          f"inner median flow ({m[0]:.4f}, {m[1]:.4f}); launches {counts}")

    # 8. path Horn-Schunck at 1080x1920
    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=24)
    hp, hn = cuda(fr[0]).float(), cuda(fr[1]).float()
    hs_cfgs = {"quadratic": of.HSConfig(), "charbonnier": of.HSConfig(penalty="charbonnier")}
    for label, cfg in hs_cfgs.items():
        flow, counts = run_path(f"HS {label}", lambda: of.pyramidal_hs(hp, hn, cfg),
                                ("hs_relax", "warp_bilinear_select", "pyr_down"))
        e = err_stats(flow, of.pyramidal_hs(hp, hn, dataclasses.replace(cfg, use_pallas=False)))
        m = inner_median(flow)
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"pyramidal_hs {label} kernel path vs plain path: {e}")
        require(abs(m[0] - 2.0) <= HS_TRANSLATION_TOL and abs(m[1] - 1.0) <= HS_TRANSLATION_TOL,
                f"pyramidal_hs {label} inner median flow {m}, expected (2, 1)")
        print(f"phase 8 pyramidal_hs {label} 1080x1920 period 24: inner median flow "
              f"({m[0]:.4f}, {m[1]:.4f}); vs plain path median {e['median']:.3g} p99 "
              f"{e['p99']:.3g} max {e['max']:.3g}; launches {counts}")
    single = of.HSConfig(levels=1)
    flow, counts = run_path("HS single scale", lambda: of.horn_schunck(hp, hn, single), ("hs_relax",))
    e = err_stats(flow, of.horn_schunck(hp, hn, dataclasses.replace(single, use_pallas=False)))
    require(e["median"] <= HS_MEDIAN_ERR and e["p999"] <= HS_P999_ERR,
            f"horn_schunck kernel vs plain: {e}")
    print(f"phase 8 horn_schunck levels=1 1080x1920: vs plain median {e['median']:.3g} p99.9 "
          f"{e['p999']:.3g} max {e['max']:.3g}; launches {counts}")

    # 8b. paths Farnebäck at 1080x1920: the image form (the flagship FB path)
    # and the coeff form, with the launch counts predicted in PERF.md
    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=24)
    fp, fq = cuda(fr[0]).float(), cuda(fr[1]).float()
    fb_cfgs = {"image": of.FBConfig(), "coeff": of.FBConfig(warp_planes="coeff")}
    fb_expect = {
        "image": {"pyr_down": 2, "poly_expansion_kernel": 3, "fb_level_step": 9,
                  "upsample_flow": 2},
        "coeff": {"pyr_down": 2, "poly_expansion_kernel": 6, "warp_bilinear_select": 8,
                  "window_solve": 9, "upsample_flow": 2},
    }
    for label, cfg in fb_cfgs.items():
        flow, counts = run_path(f"FB {label}", lambda: of.pyramidal_farneback(fp, fq, cfg),
                                tuple(fb_expect[label]))
        require(counts == fb_expect[label],
                f"FB {label} launches {counts}, predicted {fb_expect[label]}")
        require(tuple(flow.shape) == (1080, 1920, 2), f"FB {label} flow shape {tuple(flow.shape)}")
        plain = of.pyramidal_farneback(fp, fq, dataclasses.replace(cfg, use_pallas=False))
        e = err_stats(flow, plain)
        m = inner_median(flow)
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"pyramidal_farneback {label} kernel path vs plain path: {e}")
        require(abs(m[0] - 2.0) <= TRANSLATION_TOL and abs(m[1] - 1.0) <= TRANSLATION_TOL,
                f"pyramidal_farneback {label} inner median flow {m}, expected (2, 1)")
        print(f"phase 8b pyramidal_farneback {label} 1080x1920 period 24: inner median flow "
              f"({m[0]:.4f}, {m[1]:.4f}); vs plain path median {e['median']:.3g} p99 "
              f"{e['p99']:.3g} max {e['max']:.3g}; launches {counts} (as predicted)")
    # the FB serving loop: the frames of phase 6, one level, one iteration, warm
    fb_serve = of.FBConfig(levels=1, iterations=1)
    fb_serve_plain = dataclasses.replace(fb_serve, use_pallas=False)

    def serve(cfg):
        return dict(of.process_sequence((None if f is None else cuda(f) for f in frames), cfg,
                                        warm_start=True, recovery=recovery))

    flows, counts = run_path("FB serving", lambda: serve(fb_serve),
                             ("pyr_down", "poly_expansion_kernel", "fb_level_step",
                              "warp_bilinear_select"))
    flows_plain = serve(fb_serve_plain)
    require(sorted(flows) == sorted(flows_plain) == [1, 2, 3, 4, 5, 6],
            f"FB serving yielded frames {sorted(flows)}")
    worst = max((err_stats(flows[i], flows_plain[i]) for i in flows), key=lambda s: s["p99"])
    require(worst["median"] <= PATH_MEDIAN_ERR and worst["p99"] <= PATH_P99_ERR,
            f"FB serving loop kernel vs plain: {worst}")
    medians = {i: inner_median(flows[i]) for i in (1, 2, 3, 4, 6)}
    truth = {i: (2.0, 1.0) for i in (1, 2, 3, 4)} | {6: (-1.0, 1.5)}
    for i, m in medians.items():
        require(abs(m[0] - truth[i][0]) <= TRANSLATION_TOL
                and abs(m[1] - truth[i][1]) <= TRANSLATION_TOL,
                f"FB serving pair {i}: inner median flow {m}, expected {truth[i]}")
    print(f"phase 8b FB serving loop levels=1 iterations=1 warm + RecoveryConfig(levels=3), 8 "
          f"frames 1080x1920: yielded {sorted(flows)}; worst pair vs plain median "
          f"{worst['median']:.3g} p99 {worst['p99']:.3g}; inner median flow at 4 "
          f"({medians[4][0]:.4f}, {medians[4][1]:.4f}), after the cut at 6 ({medians[6][0]:.4f}, "
          f"{medians[6][1]:.4f}); launches {counts}")

    # 8c. paths model-generic entry points at 480x640
    fr = synthetic_sequence(5, 480, 640, velocity=(2.0, 1.0), period=24)
    gframes = [cuda(f).float() for f in fr]
    generic = {
        "LKConfig(levels=4, window=19)": (of.LKConfig(levels=4, window=19), of.pyramidal_lk,
                                          ("lk_residual", "lk_level_step", "pyr_down")),
        "HSConfig()": (of.HSConfig(), of.pyramidal_hs,
                       ("hs_relax", "warp_bilinear_select", "pyr_down")),
        "FBConfig()": (of.FBConfig(), of.pyramidal_farneback,
                       ("poly_expansion_kernel", "fb_level_step", "pyr_down")),
        # four levels: five alias this period-24 texture (3.13 px in JAX too)
        "TVL1_REALTIME": (of.TVL1_REALTIME, of.pyramidal_tvl1,
                          ("tvl1_relax", "warp_bilinear_select", "pyr_down",
                           "median_filter_kernel")),
        "DISConfig()": (of.DISConfig(), of.pyramidal_dis,
                        ("lk_residual centered", "lk_level_step centered", "hs_relax",
                         "warp_bilinear_select", "pyr_down")),
    }
    for label, (cfg, direct, needs) in generic.items():
        flow, counts = run_path(f"pyramidal_flow {label}",
                                lambda: of.pyramidal_flow(gframes[0], gframes[1], cfg), needs)
        e = err_stats(flow, direct(gframes[0], gframes[1], cfg))
        require(e["max"] <= 1e-6, f"pyramidal_flow {label} differs from {direct.__name__}: {e}")
        m = inner_median(flow)
        print(f"phase 8c pyramidal_flow {label} 480x640: as {direct.__name__} (max |d| "
              f"{e['max']:.3g}); inner median flow ({m[0]:.4f}, {m[1]:.4f}); launches {counts}")
    hs_serve = of.HSConfig(levels=1)
    flows, counts = run_path("HS serving", lambda: dict(of.process_sequence(
        gframes, hs_serve, warm_start=True, recovery=recovery)),
        ("hs_relax", "warp_bilinear_select", "pyr_down"))
    flows_plain = dict(of.process_sequence(gframes, dataclasses.replace(hs_serve, use_pallas=False),
                                           warm_start=True, recovery=recovery))
    require(sorted(flows) == sorted(flows_plain) == [1, 2, 3, 4],
            f"HS serving yielded {sorted(flows)}")
    worst = max((err_stats(flows[i], flows_plain[i]) for i in flows), key=lambda s: s["p99"])
    require(worst["median"] <= PATH_MEDIAN_ERR and worst["p99"] <= PATH_P99_ERR,
            f"HS serving loop kernel vs plain: {worst}")
    m = inner_median(flows[4])
    print(f"phase 8c HS serving loop levels=1 warm + RecoveryConfig(levels=3), 5 frames 480x640: "
          f"worst pair vs plain median {worst['median']:.3g} p99 {worst['p99']:.3g}; inner median "
          f"flow at 4 ({m[0]:.4f}, {m[1]:.4f}); launches {counts}")
    # warm TV-L1 and DIS streaming over the same frames, one tracking level
    streams = {
        "TV-L1 TVL1_REALTIME levels=1": (dataclasses.replace(of.TVL1_REALTIME, levels=1),
                                         ("tvl1_relax", "warp_bilinear_select", "pyr_down",
                                          "median_filter_kernel")),
        "DIS DISConfig(levels=1)": (of.DISConfig(levels=1),
                                    ("lk_level_step centered", "hs_relax", "warp_bilinear_select",
                                     "pyr_down")),
    }
    for label, (cfg, needs) in streams.items():
        flows, counts = run_path(f"{label} serving", lambda: dict(of.process_sequence(
            gframes, cfg, warm_start=True, recovery=recovery)), needs)
        flows_plain = dict(of.process_sequence(gframes, dataclasses.replace(cfg, use_pallas=False),
                                               warm_start=True, recovery=recovery))
        require(sorted(flows) == sorted(flows_plain) == [1, 2, 3, 4],
                f"{label} serving yielded {sorted(flows)}")
        worst = max((err_stats(flows[i], flows_plain[i]) for i in flows), key=lambda s: s["p99"])
        require(worst["median"] <= PATH_MEDIAN_ERR and worst["p99"] <= PATH_P99_ERR,
                f"{label} serving loop kernel vs plain: {worst}")
        m = inner_median(flows[4])
        print(f"phase 8c {label} serving loop warm + RecoveryConfig(levels=3), 5 frames 480x640: "
              f"worst pair vs plain median {worst['median']:.3g} p99 {worst['p99']:.3g}; inner "
              f"median flow at 4 ({m[0]:.4f}, {m[1]:.4f}); launches {counts}")

    # 8d. paths TV-L1 at 1080x1920, with the launch counts predicted in PERF.md
    fr = synthetic_sequence(2, 1080, 1920, velocity=(2.0, 1.0), period=48)
    tp, tn = cuda(fr[0]).float(), cuda(fr[1]).float()
    tvl1_cfgs = {"TVL1_REALTIME": of.TVL1_REALTIME, "TVL1Config()": of.TVL1Config()}
    tvl1_expect = {
        "TVL1_REALTIME": {"warp_bilinear_select": 16, "pyr_down": 3, "tvl1_relax": 16,
                          "median_filter_kernel": 16, "upsample_flow": 3},
        "TVL1Config()": {"warp_bilinear_select": 25, "pyr_down": 4, "tvl1_relax": 25,
                         "median_filter_kernel": 25, "upsample_flow": 4},
    }
    for label, cfg in tvl1_cfgs.items():
        flow, counts = run_path(f"TV-L1 {label}", lambda: of.pyramidal_tvl1(tp, tn, cfg),
                                tuple(tvl1_expect[label]))
        require(counts == tvl1_expect[label],
                f"TV-L1 {label} launches {counts}, predicted {tvl1_expect[label]}")
        require(tuple(flow.shape) == (1080, 1920, 2), f"TV-L1 {label} flow shape {tuple(flow.shape)}")
        # the plain path launches no kernel, the median's neither
        plain, plain_counts = run_path(f"TV-L1 {label} plain", lambda: of.pyramidal_tvl1(
            tp, tn, dataclasses.replace(cfg, use_pallas=False)), ())
        require(not plain_counts, f"TV-L1 {label} plain path launched {plain_counts}")
        e = err_stats(flow, plain)
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"pyramidal_tvl1 {label} kernel path vs plain path: {e}")
        m = inner_median(flow)
        epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
        if label == "TVL1Config()":
            require(epe < TVL1_EPE_TOL, f"pyramidal_tvl1 {label} inner EPE {epe}")
        require(abs(m[0] - 2.0) <= PRESET_TRANSLATION_TOL and abs(m[1] - 1.0) <= PRESET_TRANSLATION_TOL,
                f"pyramidal_tvl1 {label} inner median flow {m}, expected (2, 1)")
        print(f"phase 8d pyramidal_tvl1 {label} 1080x1920 period 48: inner EPE {epe:.4f}, median "
              f"flow ({m[0]:.4f}, {m[1]:.4f}); vs plain path median {e['median']:.3g} p99 "
              f"{e['p99']:.3g} max {e['max']:.3g}; launches {counts} (as predicted), plain path "
              "none")

    # 8e. paths DIS at 1080x1920, with the launch counts predicted in PERF.md
    dis_cfgs = {"DISConfig()": of.DISConfig(), "DIS_REALTIME": of.DIS_REALTIME,
                "charbonnier": of.DISConfig(refine_penalty="charbonnier", refine_alpha=40.0)}
    full = {"pyr_down": 4, "lk_residual": 1, "lk_level_step": 9, "warp_bilinear_select": 5,
            "hs_relax": 5, "lk_residual centered": 1, "lk_level_step centered": 9,
            "upsample_flow": 4}
    dis_expect = {"DISConfig()": full, "charbonnier": full,
                  "DIS_REALTIME": {"pyr_down": 4, "lk_residual": 1, "lk_level_step": 7,
                                   "warp_bilinear_select": 4, "hs_relax": 4,
                                   "lk_residual centered": 1, "lk_level_step centered": 7,
                                   "upsample_flow": 4}}
    for label, cfg in dis_cfgs.items():
        flow, counts = run_path(f"DIS {label}", lambda: of.pyramidal_dis(tp, tn, cfg),
                                tuple(dis_expect[label]))
        require(counts == dis_expect[label],
                f"DIS {label} launches {counts}, predicted {dis_expect[label]}")
        require(tuple(flow.shape) == (1080, 1920, 2), f"DIS {label} flow shape {tuple(flow.shape)}")
        e = err_stats(flow, of.pyramidal_dis(tp, tn, dataclasses.replace(cfg, use_pallas=False)))
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"pyramidal_dis {label} kernel path vs plain path: {e}")
        m = inner_median(flow)
        epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
        if label == "DIS_REALTIME":
            require(abs(m[0] - 2.0) <= PRESET_TRANSLATION_TOL
                    and abs(m[1] - 1.0) <= PRESET_TRANSLATION_TOL,
                    f"pyramidal_dis {label} inner median flow {m}, expected (2, 1)")
        else:
            require(epe < DIS_EPE_TOL, f"pyramidal_dis {label} inner EPE {epe}")
        print(f"phase 8e pyramidal_dis {label} 1080x1920 period 48: inner EPE {epe:.4f}, median "
              f"flow ({m[0]:.4f}, {m[1]:.4f}); vs plain path median {e['median']:.3g} p99 "
              f"{e['p99']:.3g} max {e['max']:.3g}; launches {counts} (as predicted)")

    # 8f. spatial TP at 2160x3840 (4K UHD): one pair's rows over meshes that
    # list the one card several times (real shards, real halos)
    from cuda_optical_flow_2_torch import parallel

    uh, uw = 2160, 3840
    band_rows = uh // 3
    mesh3 = parallel.make_mesh(axis_name="space", devices=[dev] * 3)
    mesh1 = parallel.make_mesh(axis_name="space", devices=[dev])

    def band(x, lo, halo):
        """Rows [lo - halo, lo + band_rows + halo) of x, zero beyond the
        image: a shard's band as the TP path cuts it."""
        out = x.new_zeros((band_rows + 2 * halo,) + tuple(x.shape[1:]))
        a, b = max(lo - halo, 0), min(lo + band_rows + halo, uh)
        out[a - (lo - halo) : b - (lo - halo)] = x[a:b]
        return out

    # each band kernel at its level-0 band shape on the top, an interior and
    # the bottom band; the halos are the TP path's (PAPER_1080P's r_img = 43,
    # HS's warp band 2 + 32 + 2 and sweep band 8 + 2, the bilateral's 4)
    p8, n8, f8 = (cuda(a) for a in textured_pair(uh, uw, seed=8))
    off8 = cuda(rng.normal(0, 5, (uh, uw)).astype(np.float32))
    hs_band_kw = dict(sweeps=8, alpha=10.0, temporal_kernel="gauss3")
    band_args = {}
    for lo in (0, band_rows, 2 * band_rows):
        parts = []
        h43, h36, h4, h10 = (lambda x, h=h: band(x, lo, h) for h in (43, 36, 4, 10))
        cases = [
            ("lk_band_step", "15x15 tri",
             (h43(p8), h43(n8), h43(f8), lo - 43, of.PAPER_1080P, uh), {}),
            ("lk_band_step centered", "9x9 box",
             (h43(p8), h43(n8), h43(f8), lo - 43, dis_lk, uh, True), {}),
            ("warp_bilinear_select_band", "", (h36(n8), h36(f8), lo - 36, uh, 32), {}),
            ("bilateral_kernel_band", "9x9 stacked pair",
             (torch.stack([h4(p8), h4(n8)]), lo - 4, uh, 9), {}),
            ("hs_relax_band", "quadratic 8 sweeps",
             (h10(p8), h10(n8), h10(f8) * 0.1, lo - 10, uh), hs_band_kw),
            ("hs_relax_band", "charbonnier it_offset 8 sweeps",
             (h10(p8), h10(n8), h10(f8) * 0.1, lo - 10, uh),
             dict(hs_band_kw, robust=(3.0, 0.1), it_offset=h10(off8))),
        ]
        for name, label, args, kw in cases:
            kernel = name.split()[0]
            parts.append(check(name, wrappers[kernel](*args, **kw), plains[kernel](*args, **kw),
                               args[0].shape[-2], uw, label))
            band_args.setdefault((name, label, lo), (args, kw))
        print(f"phase 8f band kernels, band rows {lo}-{lo + band_rows} of {uh}x{uw}: "
              + "; ".join(parts))

    fr = synthetic_sequence(2, uh, uw, velocity=(2.0, 1.0), period=48)
    up, un = cuda(fr[0]).float(), cuda(fr[1]).float()
    # predicted launches (PERF.md): every level's step on every shard; the
    # pair goes through the prefilter and the pyramid stacked, per shard
    tp_paths = {
        "PAPER_1080P": (of.PAPER_1080P, parallel.spatial_pyramidal_lk, of.pyramidal_lk,
                        TRANSLATION_TOL, (LK_MEDIAN_ERR, LK_P999_ERR),
                        {"lk_band_step": 15, "pyr_down": 12}),
        # REFERENCE_GPU misses a (2, 1) translation unsharded as well (the JAX
        # package gives (1.31, 0.65) at 1080x1920, period 48): no translation check
        "REFERENCE_GPU": (of.REFERENCE_GPU, parallel.spatial_pyramidal_lk, of.pyramidal_lk,
                          None, (LK_MEDIAN_ERR, LK_P999_ERR),
                          {"lk_band_step": 12, "bilateral_kernel_band": 3, "pyr_down": 9}),
        "HSConfig()": (of.HSConfig(), parallel.spatial_pyramidal_hs, of.pyramidal_hs,
                       HS_TRANSLATION_TOL, (HS_MEDIAN_ERR, HS_P999_ERR),
                       {"hs_relax_band": 117, "warp_bilinear_select_band": 6, "pyr_down": 6}),
    }
    unsharded_4k = {}

    def run_tp(phase, label, cfg, tp_fn, whole, tol, lims, expect):
        """A TP path on 3 shards against the plain TP path, the unsharded
        kernel path and the translation, and on 1 shard against the
        unsharded kernel path, each with its launches as predicted."""
        med_lim, p999_lim = lims
        flow, counts = run_path(f"TP {label} 3 shards", lambda: tp_fn(up, un, cfg, mesh3),
                                tuple(expect))
        require(counts == expect, f"TP {label} 3 shards launches {counts}, predicted {expect}")
        require(tuple(flow.shape) == (uh, uw, 2) and flow.device == dev,
                f"TP {label} flow {tuple(flow.shape)} on {flow.device}")
        e_plain = err_stats(flow, tp_fn.eager(up, un, dataclasses.replace(cfg, use_pallas=False),
                                              mesh3))
        unsharded_4k[label] = whole(up, un, cfg)
        e_whole = err_stats(flow, unsharded_4k[label])
        for what, e in (("plain TP path", e_plain), ("unsharded kernel path", e_whole)):
            require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                    f"TP {label} 3 shards vs {what}: {e}")
        m = inner_median(flow)
        m_whole = inner_median(unsharded_4k[label])
        if tol is not None:
            require(abs(m[0] - 2.0) <= tol and abs(m[1] - 1.0) <= tol,
                    f"TP {label} inner median flow {m}, expected (2, 1)")
        print(f"phase {phase} TP {label} {uh}x{uw} 3 shards on one card: inner median flow "
              f"({m[0]:.4f}, {m[1]:.4f}) (unsharded ({m_whole[0]:.4f}, {m_whole[1]:.4f})); vs "
              f"plain TP median {e_plain['median']:.3g} p99 {e_plain['p99']:.3g} p99.9 "
              f"{e_plain['p999']:.3g} max {e_plain['max']:.3g}; vs unsharded median "
              f"{e_whole['median']:.3g} p99 {e_whole['p99']:.3g} p99.9 {e_whole['p999']:.3g} max "
              f"{e_whole['max']:.3g}; launches {counts} (as predicted)")
        expect1 = {k: v // 3 for k, v in expect.items()}
        flow1, counts1 = run_path(f"TP {label} 1 shard", lambda: tp_fn(up, un, cfg, mesh1),
                                  tuple(expect1))
        require(counts1 == expect1, f"TP {label} 1 shard launches {counts1}, predicted {expect1}")
        e1 = err_stats(flow1, unsharded_4k[label])
        require(e1["median"] <= med_lim and e1["p999"] <= p999_lim,
                f"TP {label} 1 shard vs unsharded kernel path: {e1}")
        print(f"phase {phase} TP {label} {uh}x{uw} 1 shard: vs unsharded median "
              f"{e1['median']:.3g} p99.9 {e1['p999']:.3g} max {e1['max']:.3g}; launches {counts1} "
              "(as predicted)")

    for label, entry in tp_paths.items():
        run_tp("8f", label, *entry)
    mesh_grid = parallel.Mesh([[dev] * 3] * 2, ("batch", "space"))
    pb, nb = torch.stack([up, un]), torch.stack([un, up])
    expect = {"lk_band_step": 30, "pyr_down": 24}
    flows, counts = run_path("grid PAPER_1080P 2x3",
                             lambda: parallel.grid_pyramidal_lk(pb, nb, of.PAPER_1080P, mesh_grid),
                             tuple(expect))
    require(counts == expect, f"grid launches {counts}, predicted {expect}")
    require(tuple(flows.shape) == (2, uh, uw, 2), f"grid flow shape {tuple(flows.shape)}")
    e_grid = [err_stats(flows[0], unsharded_4k["PAPER_1080P"]),
              err_stats(flows[1], of.pyramidal_lk(un, up, of.PAPER_1080P))]
    for e in e_grid:
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"grid_pyramidal_lk vs unsharded kernel path: {e}")
    m0, m1 = inner_median(flows[0]), inner_median(flows[1])
    print(f"phase 8f grid_pyramidal_lk PAPER_1080P batch 2 over (2 batch x 3 space) on one card: "
          f"vs unsharded p99 {e_grid[0]['p99']:.3g}, {e_grid[1]['p99']:.3g}; inner median flows "
          f"({m0[0]:.4f}, {m0[1]:.4f}), ({m1[0]:.4f}, {m1[1]:.4f}); launches {counts} "
          "(as predicted)")

    # 8g. spatial TP for TV-L1 and Farnebäck on the same meshes: the two band
    # kernels at their level-0 band shapes (TV-L1's chunk band 8 + 2, with
    # nonzero carried duals; FB's fused halo band_margin + 32 + 2 = 46)
    fb_halo = fb_step_fused.band_margin(of.FBConfig()) + 32 + 2
    require(fb_halo == 46, f"FBConfig() fused halo {fb_halo}, expected 46")
    w8 = warp_select.warp_bilinear_select_plain(n8, f8)
    duals8 = [cuda(rng.normal(0, 0.05, (uh, uw)).astype(np.float32)) for _ in range(4)]
    exp8 = poly_exp_fused.poly_expansion_plain(p8, 7, 1.5)
    tvl1_band_kw = dict(tvl1_kw, iterations=8)
    for lo in (0, band_rows, 2 * band_rows):
        h10, h46 = (lambda x, h=h: band(x, lo, h) for h in (10, 46))
        state8 = tuple(h10(x) for x in (f8[..., 0] * 0.5, f8[..., 1] * 0.5, *duals8))
        fb_args = (h46(n8), tuple(h46(e) for e in exp8), h46(f8), lo - 46, of.FBConfig(), uh)
        cases = [
            ("tvl1_relax_band", "8 iterations carried duals",
             (h10(p8), h10(w8), h10(f8), state8, lo - 10, uh), tvl1_band_kw),
            ("fb_band_step", "FBConfig() first", fb_args + (True,), {}),
            ("fb_band_step", "FBConfig() warm", fb_args + (False,), {}),
        ]
        parts = []
        for name, label, args, kw in cases:
            got, want = wrappers[name](*args, **kw), plains[name](*args, **kw)
            if name == "tvl1_relax_band":  # the six state planes
                got, want = torch.stack(got), torch.stack(want)
            parts.append(check(name, got, want, args[0].shape[-2], uw, label))
            band_args.setdefault((name, label, lo), (args, kw))
        print(f"phase 8g band kernels, band rows {lo}-{lo + band_rows} of {uh}x{uw}: "
              + "; ".join(parts))
    tp_paths_8g = {
        "TVL1_REALTIME": (of.TVL1_REALTIME, parallel.spatial_pyramidal_tvl1, of.pyramidal_tvl1,
                          PRESET_TRANSLATION_TOL, (TVL1_MEDIAN_ERR, TVL1_P999_ERR),
                          {"tvl1_relax_band": 96, "warp_bilinear_select_band": 48, "pyr_down": 9,
                           "median_filter_kernel": 48}),
        "FBConfig()": (of.FBConfig(), parallel.spatial_pyramidal_fb, of.pyramidal_farneback,
                       TRANSLATION_TOL, (FB_STEP_MEDIAN_ERR, FB_STEP_P999_ERR),
                       {"fb_band_step": 27, "poly_expansion_kernel": 9, "pyr_down": 6}),
    }
    for label, entry in tp_paths_8g.items():
        run_tp("8g", label, *entry)
    # the non-fused FB level (Gaussian window: band warps and expansions) and
    # the default TV-L1 (its coarsest level holds 45 rows per shard against a
    # halo of 44), 3 shards against the unsharded kernel path
    tp_more = {
        "FBConfig(gaussian_window=True)": (
            of.FBConfig(gaussian_window=True), parallel.spatial_pyramidal_fb,
            of.pyramidal_farneback,
            {"warp_bilinear_select_band": 24, "poly_expansion_kernel": 36, "pyr_down": 6}),
        "TVL1Config()": (
            of.TVL1Config(), parallel.spatial_pyramidal_tvl1, of.pyramidal_tvl1,
            {"tvl1_relax_band": 300, "warp_bilinear_select_band": 75, "pyr_down": 12,
             "median_filter_kernel": 75}),
    }
    for label, (cfg, tp_fn, whole, expect) in tp_more.items():
        flow, counts = run_path(f"TP {label} 3 shards", lambda: tp_fn(up, un, cfg, mesh3),
                                tuple(expect))
        require(counts == expect, f"TP {label} 3 shards launches {counts}, predicted {expect}")
        e = err_stats(flow, whole(up, un, cfg))
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"TP {label} 3 shards vs unsharded kernel path: {e}")
        m = inner_median(flow)
        print(f"phase 8g TP {label} {uh}x{uw} 3 shards on one card: inner median flow "
              f"({m[0]:.4f}, {m[1]:.4f}); vs unsharded median {e['median']:.3g} p99 "
              f"{e['p99']:.3g} p99.9 {e['p999']:.3g} max {e['max']:.3g}; launches {counts} "
              "(as predicted)")

    # 8h. past the CUDA kernels' window limits (LK 65, bilateral 31) the path
    # takes the plain composition for that stage, decided from the config
    fr = synthetic_sequence(2, 480, 640, velocity=(2.0, 1.0), period=48)
    lp, ln = cuda(fr[0]).float(), cuda(fr[1]).float()
    limits = {
        "LKConfig(levels=3, window=67)": (
            of.LKConfig(levels=3, window=67), ("pyr_down",), ("lk_residual", "lk_level_step")),
        "LKConfig(prefilter=BilateralConfig(window=33))": (
            of.LKConfig(prefilter=of.BilateralConfig(window=33)),
            ("pyr_down", "lk_residual", "lk_level_step"), ("bilateral_kernel",)),
    }
    for label, (cfg, needs, never) in limits.items():
        flow, counts = run_path(f"window limit {label}", lambda: of.pyramidal_lk(lp, ln, cfg), needs)
        require(all(path_launches[f"window limit {label}"][k] == 0 for k in never),
                f"{label} launched a kernel past its window limit: {counts}")
        e = err_stats(flow, of.pyramidal_lk(lp, ln, dataclasses.replace(cfg, use_pallas=False)))
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"{label} kernel path vs plain path: {e}")
        print(f"phase 8h pyramidal_lk {label} 480x640: no {', '.join(never)} launch; vs plain "
              f"path median {e['median']:.3g} p99 {e['p99']:.3g} max {e['max']:.3g}; launches "
              f"{counts}")

    # 8i. fused_half_upsample=True at 1080x1920: accepted, and the route of
    # the flag off (a handoff launch per finer level, no other step), so the
    # same bits and the flag off's launches, as predicted in PERF.md
    half_paths = {
        "PAPER_1080P": (of.PAPER_1080P, of.pyramidal_lk, (prev, nxt),
                        {"pyr_down": 4, "lk_residual": 1, "lk_level_step": 4,
                         "upsample_flow": 4}),
        "DISConfig()": (of.DISConfig(), of.pyramidal_dis, (tp, tn), full),
    }
    for label, (cfg, entry, frames_, expect) in half_paths.items():
        on_cfg = dataclasses.replace(cfg, fused_half_upsample=True)
        flow, counts = run_path(f"{label} fused_half_upsample", lambda: entry(*frames_, on_cfg),
                                tuple(expect))
        require(counts == expect, f"{label} fused_half_upsample launches {counts}, predicted "
                                  f"{expect}")
        bits = float((flow - entry(*frames_, cfg)).abs().max())
        require(bits == 0.0, f"{label} fused_half_upsample: max |d| {bits} from the flag off")
        e = err_stats(flow, entry(*frames_, dataclasses.replace(cfg, use_pallas=False)))
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"{label} fused_half_upsample kernel path vs plain path: {e}")
        m = inner_median(flow)
        epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
        if entry is of.pyramidal_lk:
            require(abs(m[0] - 2.0) <= TRANSLATION_TOL and abs(m[1] - 1.0) <= TRANSLATION_TOL,
                    f"{label} fused_half_upsample inner median flow {m}, expected (2, 1)")
        else:
            require(epe < DIS_EPE_TOL, f"{label} fused_half_upsample inner EPE {epe}")
        print(f"phase 8i {entry.__name__} {label} fused_half_upsample=True 1080x1920 period 48: "
              f"bit-equal to the flag off; inner EPE {epe:.4f}, median flow ({m[0]:.4f}, "
              f"{m[1]:.4f}); vs plain path median {e['median']:.3g} p99 {e['p99']:.3g}; launches "
              f"{counts} (as predicted)")
    # the warm LK stream over phase 6's frames, three levels: the flag off's
    # launches and bits
    stream_cfg = of.LKConfig(levels=3, window=15)

    def stream(cfg):
        return dict(of.process_sequence((None if f is None else cuda(f) for f in frames), cfg,
                                        warm_start=True, recovery=recovery))

    flows, counts = run_path("LK serving levels=3 fused_half_upsample", lambda: stream(
        dataclasses.replace(stream_cfg, fused_half_upsample=True)),
        ("lk_level_step", "upsample_flow"))
    flows_off, counts_off = run_path("LK serving levels=3", lambda: stream(stream_cfg),
                                     ("lk_level_step", "upsample_flow"))
    require(sorted(flows) == sorted(flows_off) == [1, 2, 3, 4, 5, 6],
            f"fused_half_upsample stream yielded {sorted(flows)}")
    bits = max(float((flows[i] - flows_off[i]).abs().max()) for i in flows)
    require(bits == 0.0, f"fused_half_upsample stream: max |d| {bits} from the flag off")
    require(counts == counts_off,
            f"fused_half_upsample stream: launches {counts}, the flag off's {counts_off}")
    m3 = inner_median(flows[3])
    print(f"phase 8i LK serving loop levels=3 fused_half_upsample=True warm + "
          f"RecoveryConfig(levels=3), 8 frames 1080x1920: bit-equal to the flag off over "
          f"{sorted(flows)}; warm median flow at 3 ({m3[0]:.4f}, {m3[1]:.4f}); launches {counts}")

    # 8j. spatial TP for DIS at 2160x3840: DISConfig() needs 46 halo rows per
    # shard and its level 4 holds 45 on 3 shards, so 3 shards run four levels
    dis4 = of.DISConfig(levels=4)
    dis4_cb = of.DISConfig(levels=4, refine_penalty="charbonnier", refine_alpha=40.0)
    tp_dis = {
        "DISConfig(levels=4) 3 shards": (dis4, mesh3, {
            "pyr_down": 9, "lk_band_step": 24, "lk_band_step centered": 24,
            "warp_bilinear_select_band": 12, "hs_relax_band": 12}),
        "DISConfig(levels=4) charbonnier 3 shards": (dis4_cb, mesh3, {
            "pyr_down": 9, "lk_band_step": 24, "lk_band_step centered": 24,
            "warp_bilinear_select_band": 12, "hs_relax_band": 12}),
        "DISConfig() 1 shard": (of.DISConfig(), mesh1, {
            "pyr_down": 4, "lk_band_step": 10, "lk_band_step centered": 10,
            "warp_bilinear_select_band": 5, "hs_relax_band": 5}),
        "DIS_REALTIME 1 shard": (of.DIS_REALTIME, mesh1, {
            "pyr_down": 4, "lk_band_step": 8, "lk_band_step centered": 8,
            "warp_bilinear_select_band": 4, "hs_relax_band": 4}),
    }
    for label, (cfg, mesh, expect) in tp_dis.items():
        flow, counts = run_path(f"TP DIS {label}",
                                lambda: parallel.spatial_pyramidal_dis(up, un, cfg, mesh),
                                tuple(expect))
        require(counts == expect, f"TP DIS {label} launches {counts}, predicted {expect}")
        require(tuple(flow.shape) == (uh, uw, 2) and flow.device == dev,
                f"TP DIS {label} flow {tuple(flow.shape)} on {flow.device}")
        whole = of.pyramidal_dis(up, un, cfg)
        e = err_stats(flow, whole)
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"TP DIS {label} vs unsharded kernel path: {e}")
        m = inner_median(flow)
        epe = float((flow[64:-64, 64:-64] - flow.new_tensor([2.0, 1.0])).norm(dim=-1).mean())
        if cfg.finest_level:
            require(abs(m[0] - 2.0) <= PRESET_TRANSLATION_TOL
                    and abs(m[1] - 1.0) <= PRESET_TRANSLATION_TOL,
                    f"TP DIS {label} inner median flow {m}, expected (2, 1)")
        else:
            require(epe < DIS_EPE_TOL, f"TP DIS {label} inner EPE {epe}")
        print(f"phase 8j TP spatial_pyramidal_dis {label} {uh}x{uw} on one card: inner EPE "
              f"{epe:.4f}, median flow ({m[0]:.4f}, {m[1]:.4f}); vs unsharded median "
              f"{e['median']:.3g} p99 {e['p99']:.3g} p99.9 {e['p999']:.3g} max {e['max']:.3g}; "
              f"launches {counts} (as predicted)")

    # 8k. quality signals: forward-backward consistency on TV-L1, the
    # occlusion fill, good features and point tracking
    from cuda_optical_flow_2_torch.models import consistency
    from cuda_optical_flow_2_torch.utils import layered, metrics

    def detection(score, occ, truth):
        """tests/test_layered_motion.py's scoring over the interior: precision
        and recall of the mask, average precision of the swept score."""
        inner = np.zeros(truth.shape, bool)
        inner[LAYERED_MARGIN:-LAYERED_MARGIN, LAYERED_MARGIN:-LAYERED_MARGIN] = True
        s, t = score[inner], truth[inner]

        def pr(pred):
            tp = (pred & t).sum()
            return tp / max(pred.sum(), 1), tp / max(t.sum(), 1)

        prec, rec = np.array([pr(s > b) for b in np.concatenate(
            [np.linspace(-2, 0, 20), np.geomspace(0.01, 50, 50)])]).T
        o = np.argsort(rec)
        ap = float(np.sum(np.diff(rec[o]) * (prec[o][1:] + prec[o][:-1]) / 2))
        return (*pr(occ[inner]), ap)

    # consistent_flow runs the pair twice (forward, backward) and the cycle
    # warp once: #3 on both planes of the backward flow
    tv3 = of.TVL1Config(levels=3)
    cf_expect = {
        "TVL1Config(levels=3)": {"pyr_down": 4, "warp_bilinear_select": 31, "tvl1_relax": 30,
                                 "median_filter_kernel": 30, "upsample_flow": 4},
        "TVL1_REALTIME": {"pyr_down": 6, "warp_bilinear_select": 33, "tvl1_relax": 32,
                          "median_filter_kernel": 32, "upsample_flow": 6},
    }
    scenes = {
        "disk": layered.layered_scene(192, 256, bg_flow=(-2.0, 1.0), seed=3, layers=[
            layered.Layer("disk", (96.0, 128.0), 45.0, (3.0, 1.0))]),
        "bar": layered.layered_scene(192, 256, bg_flow=(-3.0, 0.0), seed=7, layers=[
            layered.Layer("rect", (96.0, 128.0), (120.0, 22.0), (4.0, 0.0))]),
    }
    # Kernel path vs plain path is held at the pixels the truth marks matched:
    # at occluded pixels TV-L1 has no data term, and the float-order
    # differences of the pyramid and warp kernels flip near-tied threshold
    # and median decisions there (the bar scene: p99 over all pixels 0.0114
    # px, max 0.55 px on an H100 80GB HBM3, 700 W); the all-pixel numbers
    # are printed beside
    for name, sc in scenes.items():
        sp, sn = cuda(sc.prev), cuda(sc.nxt)
        expect = cf_expect["TVL1Config(levels=3)"]
        (fw, occ), counts = run_path(f"consistent_flow {name} 192x256",
                                     lambda: of.consistent_flow(sp, sn, tv3), tuple(expect))
        require(counts == expect, f"consistent_flow {name} launches {counts}, predicted {expect}")
        (fw_p, occ_p), plain_counts = run_path(f"consistent_flow {name} 192x256 plain", lambda: (
            of.consistent_flow(sp, sn, dataclasses.replace(tv3, use_pallas=False))), ())
        require(not plain_counts, f"consistent_flow {name} plain path launched {plain_counts}")
        e_all = err_stats(fw, fw_p)
        matched = torch.as_tensor(~sc.occ, device=dev)
        e = err_stats(fw[matched], fw_p[matched])
        require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
                f"consistent_flow {name} kernel path vs plain path at matched pixels: {e}")
        differ = float((occ != occ_p).float().mean())
        score = consistency.occlusion_score(fw, of.pyramidal_tvl1(sn, sp, tv3)).cpu().numpy()
        prec, rec, ap = detection(score, occ.cpu().numpy(), sc.occ)
        if name == "disk":
            require(prec > 0.45 and rec > 0.50, f"disk detection P {prec} R {rec}")
        else:
            require(ap > 0.55, f"bar detection AP {ap}")
        ev = metrics.evaluate_flow(fw, sc.flow, margin=LAYERED_MARGIN, occ=sc.occ)
        print(f"phase 8k consistent_flow TVL1Config(levels=3) layered {name} 192x256: P {prec:.4f} "
              f"R {rec:.4f} AP {ap:.4f} (tests/test_layered_motion.py: disk P > 0.45, R > 0.50; "
              f"bar AP > 0.55); EPE matched {ev['epe_matched']:.4f} unmatched "
              f"{ev['epe_unmatched']:.4f}; vs plain path at matched pixels median "
              f"{e['median']:.3g} p99 {e['p99']:.3g} max {e['max']:.3g} (all pixels: median "
              f"{e_all['median']:.3g} p99 {e_all['p99']:.3g} p99.9 {e_all['p999']:.3g} max "
              f"{e_all['max']:.3g}), mask differs at {100 * differ:.4f} % of pixels; launches "
              f"{counts} (as predicted), plain path none")

    # the disk scene at 1080x1920: centre and radius scaled by 1080/192, the
    # motion (px per frame) kept
    big = layered.layered_scene(1080, 1920, bg_flow=(-2.0, 1.0), seed=3, layers=[
        layered.Layer("disk", (540.0, 960.0), 45.0 * 1080 / 192, (3.0, 1.0))])
    bp, bn = cuda(big.prev), cuda(big.nxt)
    rt_plain = dataclasses.replace(of.TVL1_REALTIME, use_pallas=False)
    expect = cf_expect["TVL1_REALTIME"]
    (fraw, occ_b), counts_raw = run_path("consistent_flow TVL1_REALTIME 1080x1920",
                                         lambda: of.consistent_flow(bp, bn, of.TVL1_REALTIME),
                                         tuple(expect))
    # the fill: one call of the occlusion fill kernel (its weights launch and
    # ceil(96 / 8) = 12 sweep launches of one C call)
    fill_expect = {"fill_occluded_flow_kernel": 1}
    (ffill, occ_f), counts_fill = run_path("consistent_flow TVL1_REALTIME fill 1080x1920", lambda: (
        of.consistent_flow(bp, bn, of.TVL1_REALTIME, fill=True)), tuple(expect | fill_expect))
    require(counts_raw == expect and counts_fill == expect | fill_expect,
            f"consistent_flow TVL1_REALTIME launches {counts_raw}, with the fill {counts_fill}, "
            f"predicted {expect} and with the fill also {fill_expect}")
    require(torch.equal(occ_f, occ_b) and torch.equal(ffill[~occ_b], fraw[~occ_b]),
            "fill=True changed the mask or a matched pixel")
    filled, counts = run_path("fill_occluded_flow 1080x1920",
                              lambda: consistency.fill_occluded_flow(fraw, occ_b),
                              tuple(fill_expect))
    require(counts == fill_expect and torch.equal(filled, ffill),
            f"the fill alone: launches {counts}, predicted {fill_expect}")
    # the kernel against its plain version on the path's own flow and mask
    fill_line = check_fill(fraw, occ_b, "the path's flow and mask")
    sweep_ring = occlusion_fill.ring(occlusion_fill.SWEEPS_PER_LAUNCH)
    active, tiles = fill_active_tiles(occ_b, 64 - 2 * occlusion_fill.WEIGHTS_RING,
                                      64 - 2 * sweep_ring)
    (fplain, occ_p), plain_counts = run_path("consistent_flow TVL1_REALTIME fill 1080x1920 plain",
                                             lambda: of.consistent_flow(bp, bn, rt_plain, fill=True),
                                             ())
    require(not plain_counts, f"consistent_flow plain path launched {plain_counts}")
    e_all = err_stats(ffill, fplain)
    matched = torch.as_tensor(~big.occ, device=dev)
    e = err_stats(ffill[matched], fplain[matched])
    require(e["median"] <= PATH_MEDIAN_ERR and e["p99"] <= PATH_P99_ERR,
            f"consistent_flow TVL1_REALTIME fill kernel path vs plain path at matched pixels: {e}")
    differ = float((occ_b != occ_p).float().mean())
    before = metrics.evaluate_flow(fraw, big.flow, margin=LAYERED_MARGIN, occ=big.occ)
    after = metrics.evaluate_flow(ffill, big.flow, margin=LAYERED_MARGIN, occ=big.occ)
    print(f"phase 8k consistent_flow TVL1_REALTIME layered disk 1080x1920 (radius 253.125): EPE "
          f"matched {before['epe_matched']:.4f} unmatched {before['epe_unmatched']:.4f}, with the "
          f"fill {after['epe_matched']:.4f} / {after['epe_unmatched']:.4f} (true occlusion "
          f"{100 * big.occ.mean():.3f} %, detected {100 * float(occ_b.float().mean()):.3f} %); "
          f"fill vs plain path at matched pixels median {e['median']:.3g} p99 {e['p99']:.3g} max "
          f"{e['max']:.3g} (all pixels: median {e_all['median']:.3g} p99 {e_all['p99']:.3g} "
          f"p99.9 {e_all['p999']:.3g} max {e_all['max']:.3g}), mask differs at "
          f"{100 * differ:.4f} % of pixels; launches {counts_fill} (as predicted; the fill "
          f"alone {counts}, the plain path none; matched pixels unchanged by the fill); "
          f"fill_occluded_flow_kernel vs its plain version on {fill_line}; {active} of "
          f"{tiles} sweep tiles hold an occluded pixel under their flags")
    # the cycle warp: #3 on both planes against the plain warp, and the residual
    bw_b = of.pyramidal_tvl1(bn, bp, of.TVL1_REALTIME)
    planes = bw_b.movedim(-1, -3)
    line = check("warp_bilinear_select", consistency._warp_by(planes, fraw, True),
                 consistency._warp_by(planes, fraw, False), 1080, 1920, "cycle warp 2 planes")
    e = err_stats(consistency.fb_consistency(fraw, bw_b),
                  consistency.fb_consistency(fraw, bw_b, use_pallas=False))
    require(e["max"] <= WARP_MAX_ERR, f"fb_consistency kernel vs plain warp: {e}")
    print(f"phase 8k fb_consistency 1080x1920: {line}; residual vs plain warp max {e['max']:.3g}")

    # good features and tracking: 8 frames of a period-48 texture at (2, 1)
    tr_frames = cuda(synthetic_sequence(8, 1080, 1920, velocity=(2.0, 1.0), period=48, noise=0.0))
    gf_frame = tr_frames[0].float()
    gf_cfg = of.LKConfig(window=15)
    (pts, scores), counts = run_path("good_features 1080x1920",
                                     lambda: of.good_features(gf_frame, gf_cfg, 500), ())
    require(not counts, f"good_features launched {counts}")
    cpu_pts, cpu_scores = of.good_features(gf_frame.cpu(), gf_cfg, 500)
    require(torch.equal(pts.cpu(), cpu_pts), "good_features points differ from the CPU run")
    rel = float(((scores.cpu() - cpu_scores).abs() / cpu_scores.abs()).max())
    require(rel <= GF_SCORE_RTOL, f"good_features scores vs the CPU run: max rel {rel}")
    require(bool((scores > 0).all()), "good_features found fewer than 500 points")
    track_expect = {"pyr_down": 88, "lk_level_step": 35, "upsample_flow": 28}
    (pos, alive), counts = run_path("track_sequence PAPER_1080P 8 frames 1080x1920", lambda: (
        of.track_sequence(tr_frames, pts, of.PAPER_1080P)), tuple(track_expect))
    require(counts == track_expect, f"track_sequence launches {counts}, predicted {track_expect}")
    truth = pts[None] + torch.arange(1, 8, device=dev)[:, None, None] * pts.new_tensor([2.0, 1.0])
    err = (pos - truth).norm(dim=-1)
    m = TRACK_MARGIN
    inner = ((truth[..., 0] >= m) & (truth[..., 0] <= 1919 - m) & (truth[..., 1] >= m)
             & (truth[..., 1] <= 1079 - m)).all(0)
    require(bool(alive[:, inner].all()), "an interior point died")
    inner_err = float(err[:, inner].max())
    require(inner_err <= TRACK_TOL, f"track_sequence interior points: max error {inner_err} px")
    edge = err[:, ~inner][alive[:, ~inner]]
    edge_err = float(edge.max()) if edge.numel() else 0.0
    tp_expect = {"pyr_down": 80, "lk_residual": 1, "lk_level_step": 34, "upsample_flow": 28}
    gen, counts_tp = run_path("track_points PAPER_1080P 8 frames 1080x1920", lambda: list(
        of.track_points(tr_frames, pts, of.PAPER_1080P)), tuple(tp_expect))
    require(counts_tp == tp_expect, f"track_points launches {counts_tp}, predicted {tp_expect}")
    require([i for i, _, _ in gen] == list(range(1, 8)), f"track_points yielded {[g[0] for g in gen]}")
    d_gen = max(float((gp - pos[t]).abs().max()) for t, (_, gp, _) in enumerate(gen))
    require(d_gen <= 1e-5 and all(torch.equal(ga, alive[t]) for t, (_, _, ga) in enumerate(gen)),
            f"track_points vs track_sequence: max |d| {d_gen}")
    print(f"phase 8k good_features 500 LKConfig(window=15) 1080x1920 period 48: points equal to "
          f"the CPU run, scores max rel {rel:.3g} (limit {GF_SCORE_RTOL}); track_sequence "
          f"PAPER_1080P warm over 8 frames at (2, 1): {int(inner.sum())} points {m} px or more "
          f"inside, max error {inner_err:.4f} px (limit {TRACK_TOL}), all alive; "
          f"{int((~inner).sum())} nearer the border: max error {edge_err:.4f} px, "
          f"{int((~alive[-1]).sum())} dead at the end; track_points max |d| {d_gen:.3g} and "
          f"liveness equal; launches {counts} and {counts_tp} (as predicted), good_features "
          "none")

    # 8l. the reference-exact profiles and the four command-line tools; the
    # graphs that the TP and tracking paths of 8f-8k captured go first: with
    # the benchmark's 64-pair captures of config 5 they overfilled the card
    capture.clear()
    torch.cuda.empty_cache()
    tools_8l = phase_8l(of, dev, run_path, big, card)

    # 8m. the examples, gradients through the plain path, multihost; the
    # captured graphs of the earlier phases go first (TV-L1's gradient
    # takes ~42 GiB)
    capture.clear()
    torch.cuda.empty_cache()
    phase_8m(of, dev, run_path, prev, nxt, card)

    # 8n. the captured entries against the eager calls
    phase_8n(of, dev, run_path, card)

    # 8o. the parallel/ entries, tracking and the evaluate tool's step, captured
    phase_8o(of, dev, run_path, card)

    # 8p. every multi-device entry over the cards present
    phase_8p(of, dev, run_path, card)

    # 8q. the coarse-to-fine handoff kernel
    max_err["upsample_flow"] = phase_8q(of, dev, card)["max_abs_err"]

    # 8r. OpenCV's DIS PRESET_MEDIUM through the captured entry
    phase_8r(of, dev, card)

    # 8s. the LK kernel's geometry
    phase_8s(of, dev, card)

    # 8t. TV-L1's relaxation in thread-block clusters
    phase_8t(of, dev, card)

    launches = {name: sum(c[name] for c in path_launches.values())
                for name in next(iter(path_launches.values()))}
    for name, n_launch in launches.items():
        require(n_launch > 0, f"{name} was not launched on any path")

    # 9. timing
    reps = 30
    paths = {
        "pyramidal_lk PAPER_1080P 1080x1920": (
            lambda: of.pyramidal_lk(prev, nxt, of.PAPER_1080P),
            lambda: of.pyramidal_lk(prev, nxt, plain_cfg), reps),
        **{f"pyramidal_lk REFERENCE_GPU {h}x{w}": (
            (lambda a=a: of.pyramidal_lk(*a, ref)),
            (lambda a=a: of.pyramidal_lk(*a, ref_plain)), 10) for (h, w), a in ref_pairs.items()},
        **{f"pyramidal_hs {label} 1080x1920": (
            (lambda c=c: of.pyramidal_hs(hp, hn, c)),
            (lambda c=c: of.pyramidal_hs(hp, hn, dataclasses.replace(c, use_pallas=False))), 10)
           for label, c in hs_cfgs.items()},
        **{f"pyramidal_farneback {label} 1080x1920": (
            (lambda c=c: of.pyramidal_farneback(fp, fq, c)),
            (lambda c=c: of.pyramidal_farneback(fp, fq, dataclasses.replace(c, use_pallas=False))),
            10) for label, c in fb_cfgs.items()},
        "FB serving step (captured) 1080x1920": (
            lambda: of.step(fb_state, fb_frame, fb_serve, True, recovery),
            lambda: of.step(fb_state, fb_frame, fb_serve_plain, True, recovery), 10),
        **{f"pyramidal_tvl1 {label} 1080x1920": (
            (lambda c=c: of.pyramidal_tvl1(tp, tn, c)),
            (lambda c=c: of.pyramidal_tvl1(tp, tn, dataclasses.replace(c, use_pallas=False))), 5)
           for label, c in tvl1_cfgs.items()},
        **{f"pyramidal_dis {label} 1080x1920": (
            (lambda c=c: of.pyramidal_dis(tp, tn, c)),
            (lambda c=c: of.pyramidal_dis(tp, tn, dataclasses.replace(c, use_pallas=False))), 10)
           for label, c in dis_cfgs.items()},
    }
    # the quality signals of phase 8k: one call is two flows and the cycle
    # test (and the fill); tracking is 7 pairs
    paths |= {
        "consistent_flow TVL1_REALTIME 1080x1920": (
            lambda: of.consistent_flow(bp, bn, of.TVL1_REALTIME),
            lambda: of.consistent_flow(bp, bn, rt_plain), 5),
        "consistent_flow TVL1_REALTIME fill 1080x1920": (
            lambda: of.consistent_flow(bp, bn, of.TVL1_REALTIME, fill=True),
            lambda: of.consistent_flow(bp, bn, rt_plain, fill=True), 5),
        "track_sequence PAPER_1080P 8 frames 1080x1920": (
            lambda: of.track_sequence(tr_frames, pts, of.PAPER_1080P),
            lambda: of.track_sequence.eager(tr_frames, pts, plain_cfg), 10),
    }
    # the TP paths at 4K, each beside its unsharded run
    for label, (c, tp_fn, whole, *_rest) in (tp_paths | tp_paths_8g).items():
        r = 5 if label == "TVL1_REALTIME" else 10
        paths[f"{whole.__name__} {label} {uh}x{uw}"] = (
            (lambda c=c, g=whole: g(up, un, c)),
            (lambda c=c, g=whole: g(up, un, dataclasses.replace(c, use_pallas=False))), r)
        paths[f"{tp_fn.__name__} {label} {uh}x{uw} 3 shards"] = (
            (lambda c=c, g=tp_fn: g(up, un, c, mesh3)),
            (lambda c=c, g=tp_fn.eager: g(up, un, dataclasses.replace(c, use_pallas=False),
                                          mesh3)), r)
    # DIS TP at 4K beside its unsharded runs
    for label, c, mesh, shards in (("DISConfig(levels=4)", dis4, mesh3, 3),
                                   ("DISConfig()", of.DISConfig(), mesh1, 1)):
        r = 10 if shards == 3 else 5
        paths[f"pyramidal_dis {label} {uh}x{uw}"] = (
            (lambda c=c: of.pyramidal_dis(up, un, c)),
            (lambda c=c: of.pyramidal_dis(up, un, dataclasses.replace(c, use_pallas=False))), r)
        paths[f"spatial_pyramidal_dis {label} {uh}x{uw} {shards} shard{'s' * (shards > 1)}"] = (
            (lambda c=c, m=mesh: parallel.spatial_pyramidal_dis(up, un, c, m)),
            (lambda c=c, m=mesh: parallel.spatial_pyramidal_dis.eager(
                up, un, dataclasses.replace(c, use_pallas=False), m)), r)
    # a warm FB serving state: the step times one tracked pair with the check
    fb_state = of.init_state(cuda(frames[0]), fb_serve, recovery)
    fb_state, _ = of.step(fb_state, cuda(frames[1]), fb_serve, True, recovery)
    fb_frame = cuda(frames[2])
    path_ms = {}
    for label, (fn, plain_fn, r) in paths.items():
        r_plain = max(3, r // 10)
        path_ms[label] = cuda_ms(fn, r)
        p_ms = cuda_ms(plain_fn, r_plain, warmup=1)
        print(f"phase 9 timing [{card}] {label}: kernel path {path_ms[label]:.3f} ms/pair, plain "
              f"path {p_ms:.3f} ms/pair (median of {r} and {r_plain})")
    label = "track_sequence PAPER_1080P 8 frames 1080x1920"
    print(f"phase 9 timing [{card}] {label}: {path_ms[label] / 7:.3f} ms per tracked frame")
    # the fill (the occlusion fill kernel) and good_features (plain torch)
    singles = {
        "fill_occluded_flow 1080x1920": lambda: consistency.fill_occluded_flow(fraw, occ_b),
        "good_features 500 LKConfig(window=15) 1080x1920": (
            lambda: of.good_features(gf_frame, gf_cfg, 500)),
    }
    for label, fn in singles.items():
        path_ms[label] = cuda_ms(fn, 10)
        print(f"phase 9 timing [{card}] {label}: {path_ms[label]:.3f} ms/call (median of 10)")
    # the benchmark tool's configs (phase 8l) as direct calls on its inputs
    from cuda_optical_flow_2_torch.cli import benchmark as cli_bench

    for idx, spec in cli_bench.CONFIGS.items():
        bench_fn, bench_args, frames_per_call = cli_bench.config_call(spec, dev)
        r = 3 if spec.get("batch") else reps
        ms = cuda_ms(lambda: bench_fn(*bench_args), r)
        print(f"phase 9 timing [{card}] benchmark config {idx} ({spec['name']}): {ms:.3f} "
              f"ms/call, {ms / frames_per_call:.3f} ms/frame (median of {r} calls); the tool's "
              f"device_time read {tools_8l[f'benchmark config {idx} lk']:.3f} ms/call in phase 8l")

    p0, n0, f0 = (cuda(a) for a in textured_pair(1080, 1920, seed=7))
    pair0 = torch.stack([p0, n0])
    exp0 = poly_exp_fused.poly_expansion_plain(p0, 7, 1.5)
    prods0 = fb_normal_eq_products(exp0, poly_exp_fused.poly_expansion_plain(n0, 7, 1.5),
                                   f0[..., 0], f0[..., 1])
    hs_kw = dict(iterations=100, alpha=10.0, temporal_kernel="gauss3")
    small = torch.stack([p0[:480, :640], n0[:480, :640]]).contiguous()
    w0 = warp_select.warp_bilinear_select_plain(n0, f0)
    half0 = (f0[::2, ::2] * 0.5).contiguous()  # a coarser level's flow
    # (name, label, args, keyword args); the first entry of each name is the
    # one in the kernels line
    timed = [
        ("lk_residual", "15x15 tri", (p0, n0, of.PAPER_1080P), {}),
        ("lk_level_step", "15x15 tri", (p0, n0, f0, of.PAPER_1080P), {}),
        ("warp_bilinear_select", "", (p0, f0, of.PAPER_1080P.max_displacement), {}),
        ("pyr_down", "stacked pair", (pair0,), {}),
        ("bilateral_kernel", "9x9", (pair0, 9), {}),
        ("bilateral_kernel", "9x9", (small, 9), {}),
        ("hs_relax", "quadratic 100 sweeps", (p0, n0, None), hs_kw),
        ("hs_relax", "charbonnier 100 sweeps", (p0, n0, None), dict(hs_kw, robust=(3.0, 0.1))),
        ("poly_expansion_kernel", "poly_n=7", (p0, 7, 1.5), {}),
        ("window_solve", "15x15", (*prods0, 15, 1e-6), {}),
        ("fb_level_step", "15x15 poly_n=7 warm", (n0, exp0, f0, of.FBConfig()), {}),
        ("tvl1_relax", "14 iterations warm", (p0, w0, f0, f0), tvl1_kw),
        ("median_filter_kernel", "5x5 flow view", (f0.movedim(-1, 0), 5), {}),
        ("upsample_flow", "540x960 -> 1080x1920", (half0, (1080, 1920)), {}),
        ("lk_residual", "9x9 box centered", (p0, n0, dis_lk), {"centered": True}),
        ("lk_level_step", "9x9 box centered", (p0, n0, f0, dis_lk), {"centered": True}),
    ]
    # the occlusion fill at 1080x1920: on phase 8k's disk flow and detected
    # mask (held to its plain version there; the tiles away from the disk's
    # occlusion band return at once), and on occluded stripes that leave no
    # tile idle
    sflow, socc = (cuda(a[0]) for a in fill_scene(1, 1080, 1920, "stripes", 17))
    print("phase 9 fill_occluded_flow_kernel vs plain: "
          + check_fill(sflow, socc, "stripes 1080x1920"))
    timed += [("fill_occluded_flow_kernel", "disk mask 96 sweeps", (fraw, occ_b), {}),
              ("fill_occluded_flow_kernel", "stripes 96 sweeps", (sflow, socc), {})]
    # the band kernels at their interior 4K band (rows 720-1440 and halos)
    for name, label in (("lk_band_step", "15x15 tri"), ("warp_bilinear_select_band", ""),
                        ("bilateral_kernel_band", "9x9 stacked pair"),
                        ("hs_relax_band", "quadratic 8 sweeps"),
                        ("tvl1_relax_band", "8 iterations carried duals"),
                        ("fb_band_step", "FBConfig() warm")):
        timed.append((name, label, *band_args[(name, label, band_rows)]))
    args, _kw = band_args[("lk_band_step centered", "9x9 box", band_rows)]
    timed.append(("lk_band_step", "9x9 box centered", args[:-1], {"centered": True}))
    # library yardstick: F.conv2d(stride=2) computes pyr_down's function
    k2 = torch.as_tensor(np.outer(BINOMIAL_1D, BINOMIAL_1D), device=dev)[None, None]

    def conv_pyr_down(x):
        return F.conv2d(x[:, None], k2, stride=2, padding=1)[:, 0]

    e = err_stats(conv_pyr_down(pair0), pyr_down.pyr_down(pair0))
    require(e["max"] <= PYR_MAX_ERR, f"F.conv2d(stride=2) is not pyr_down's function: {e}")
    # and one F.conv2d with five 7x7 filters, the separable taps' outer
    # products folded with the mixing rows, computes poly_expansion_kernel's
    g = gaussian_1d(7, 1.5)
    o = np.arange(7) - 3
    taps = (g, g * o, g * o * o)
    moments = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))  # (vertical, horizontal) taps
    mix = mixing_matrix(7, 1.5).copy()
    mix[4] *= 0.5
    k5 = np.stack([
        sum(mix[c, l] * np.outer(taps[vy], taps[vx]) for l, (vy, vx) in enumerate(moments))
        for c in range(5)
    ])
    k5 = torch.as_tensor(k5[:, None].astype(np.float32), device=dev)

    def conv_poly(x):
        return F.conv2d(x[None, None], k5, padding=3)[0]

    d = (conv_poly(p0) - torch.stack(poly_exp_fused.poly_expansion_kernel(p0, 7, 1.5))).abs()
    excess = float((d - POLY_RTOL * conv_poly(p0).abs()).max())
    require(excess <= POLY_ATOL, f"F.conv2d is not poly_expansion_kernel's function: {excess}")
    # and torch.median over the 25 shifted slices of the edge-padded flow
    # planes (the plain version's last call) computes median_filter_kernel's
    fpad = F.pad(f0.movedim(-1, 0)[None], (2, 2, 2, 2), mode="replicate")[0]
    stacked = torch.stack([fpad[:, dy:dy + 1080, dx:dx + 1920]
                           for dy in range(5) for dx in range(5)])
    require(torch.equal(stacked.median(dim=0).values,
                        median_select.median_filter_kernel(f0.movedim(-1, 0), 5)),
            "torch.median is not median_filter_kernel's function")
    # and F.interpolate (bilinear, x 2) on the (1, 2, h, w) flow computes
    # upsample_flow's for an even target, in another rounding (a yardstick
    # only: the port never calls it)
    half0_nchw = half0.permute(2, 0, 1)[None].contiguous()

    def interp_flow():
        return F.interpolate(half0_nchw, size=(1080, 1920), mode="bilinear",
                             align_corners=False) * 2.0

    d = float((interp_flow()[0].permute(1, 2, 0) - upsample_kernel.upsample_flow(
        half0, (1080, 1920))).abs().max())
    require(d <= 1e-4, f"F.interpolate is not upsample_flow's function: max |d| {d}")
    library = {"pyr_down": ("F.conv2d(stride=2)", lambda: conv_pyr_down(pair0)),
               "poly_expansion_kernel": ("F.conv2d 5x1x7x7", lambda: conv_poly(p0)),
               "median_filter_kernel": ("torch.median of 25 stacked slices",
                                        lambda: stacked.median(dim=0)),
               "upsample_flow": ("F.interpolate(bilinear) x 2", interp_flow)}
    timing = {}
    for name, label, args, kw in timed:
        slow = name in ("hs_relax", "tvl1_relax", "fill_occluded_flow_kernel")
        k_ms = cuda_ms(lambda: wrappers[name](*args, **kw), 10 if slow else reps, device=True,
                       inner=1 if slow else 10)
        p_ms = cuda_ms(lambda: plains[name](*args, **kw), 3 if slow else 10, warmup=1,
                       device=True)
        lib_name, lib_fn = library.get(name, (None, None))
        lib_ms = None if lib_fn is None else cuda_ms(lib_fn, reps, inner=10, device=True)
        b_ms, b_by = bound(name, args, kw)
        key = name + (" centered" if kw.get("centered") else "")
        timing.setdefault(key, (k_ms, p_ms, b_ms, b_by, lib_ms))
        shape = "x".join(map(str, args[0].shape))
        print(f"phase 9 timing [{card}] {name} {shape} {label}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms" + ("" if lib_ms is None else f", {lib_name} {lib_ms:.4f} ms")
              + f", bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / k_ms:.1f} % of the kernel's time)")

    # 10. profile: device busy share and device operations per pair
    profiled = {label: fn for label, (fn, _plain, _r) in paths.items()} | singles
    for label, fn in profiled.items():
        prof = profile_path(fn, 5)
        if not prof["ops_per_pair"]:
            print(f"phase 10 profile {label}: no device events in the trace; busy share not "
                  "measured")
            continue
        top = "; ".join(f"{n} {t:.3f} ms" for n, t in prof["top"])
        print(f"phase 10 profile [{card}] {label}: device busy {prof['device_ms']:.3f} ms/pair, "
              f"{prof['ops_per_pair']:.0f} device ops/pair, profiled wall {prof['wall_ms']:.3f} "
              f"ms/pair; busy share {100 * prof['device_ms'] / path_ms[label]:.1f} % of the "
              f"unprofiled {path_ms[label]:.3f} ms/pair; top: {top}")
    print(f"phase 10 profiler [{card}]: {profiler_note()}")

    entries = [(name, src, rep) for name, _m, _p, src, rep in KERNELS]
    entries += [(f"{name} centered", src, rep)
                for name, _m, _p, src, rep in KERNELS if name in CENTERED]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": timing[name][2], "bound_by": timing[name][3],
         "library_ms": timing[name][4]}
        for name, src, rep in entries
    ]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.exit(nccl_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:] not in ([], ["--phase", "8p"], ["--phase", "8q"], ["--phase", "8r"],
                            ["--phase", "8s"], ["--phase", "8t"]):
        print(f"usage: python3 {Path(__file__).name} [--phase 8p | --phase 8q | --phase 8r | "
              "--phase 8s | --phase 8t]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(only=sys.argv[2] if sys.argv[1:] else None))
