"""The port's command-line tools (``cuda_optical_flow_2_torch/cli``) against
the JAX package's, on the CPU.

Each tool runs in-process with ``--device cpu`` (the port's plain PyTorch
versions) beside the JAX tool with ``--no-pallas`` (its XLA twins), on the
same inputs: the JSON records carry the same keys, and their EPE agrees
within 1e-4 px (both tools print it rounded to 4 decimals, so the two
roundings may sit one step of 1e-4 apart), or within the family's own
parity bound where that is looser (TV-L1: 2e-4 px per pixel,
tests/test_torch_tvl1.py).  The datasets are built as tests/test_evaluate.py
builds them, with the JAX package's writers.  Without a CUDA device the
default ``--device cuda`` ends every tool with a message.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_optical_flow_2_tpu.cli import benchmark as jbench
from cuda_optical_flow_2_tpu.cli import demo as jdemo
from cuda_optical_flow_2_tpu.cli import evaluate as jeval
from cuda_optical_flow_2_tpu.utils import io as uio
from cuda_optical_flow_2_tpu.utils import viz
from cuda_optical_flow_2_tpu.utils.layered import Layer, layered_scene
from cuda_optical_flow_2_torch.cli import benchmark as tbench
from cuda_optical_flow_2_torch.cli import demo as tdemo
from cuda_optical_flow_2_torch.cli import diff as tdiff
from cuda_optical_flow_2_torch.cli import evaluate as teval

ROOT = Path(__file__).resolve().parent.parent
EPE_TOL = 1e-4 + 1e-9  # px; one rounding step of the printed 4 decimals
TVL1_EPE_TOL = 2e-4 + 1e-9  # px; the TV-L1 flow parity bound (tests/test_torch_tvl1.py)


def _records(capsys) -> list[dict]:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


# --- the device flag ----------------------------------------------------------


@pytest.mark.parametrize("tool", ["benchmark", "evaluate", "diff", "demo"])
def test_default_cuda_device_without_a_card_exits(tool, tmp_path, monkeypatch, capsys):
    """``--device cuda`` is the default, and without a card every tool ends
    with a message before it computes anything: it never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"benchmark": tbench, "evaluate": teval, "diff": tdiff, "demo": tdemo}[tool]
    argv = {"benchmark": ["--configs", "1"], "evaluate": ["--dataset", str(tmp_path)],
            "diff": ["--size", "32x32"], "demo": ["--synthetic", "2", "--size", "32x32"]}[tool]
    with pytest.raises(SystemExit) as exc:
        mod.main(argv)
    assert "no CUDA device" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_cuda_device_without_a_card_exits_nonzero_as_a_script():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_optical_flow_2_torch.cli.benchmark", "--configs", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cuda: no CUDA device" in proc.stderr


# --- benchmark ------------------------------------------------------------


SMALL = {1: (48, 48), 2: (64, 80)}


@pytest.mark.parametrize("model", ["lk", "hs", "fb", "tvl1", "dis"])
def test_benchmark_matches_jax(model, monkeypatch, capsys):
    """Configs 1-2 at a reduced shape on each family: the same keys and
    names, EPE within 1e-4 px of the JAX tool's.  Timing is not compared,
    so the JAX tool's chained timing programs are not compiled."""
    for mod in (jbench, tbench):
        for idx, shape in SMALL.items():
            monkeypatch.setitem(mod.CONFIGS, idx, dict(mod.CONFIGS[idx], shape=shape))
    monkeypatch.setattr(jbench, "device_time", lambda fn, *a, **k: 1.0)
    argv = ["--configs", "1", "2", "--iters", "2", "--model", model]
    jbench.main([*argv, "--no-pallas"])
    want = _records(capsys)
    tbench.main([*argv, "--device", "cpu"])
    got = _records(capsys)
    assert [r["config"] for r in got] == [1, 2]
    tol = TVL1_EPE_TOL if model == "tvl1" else EPE_TOL
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys() and g["name"] == w["name"]
        assert g["fps"] > 0 and g["ms_per_frame"] > 0
        assert abs(g["epe_vs_truth"] - w["epe_vs_truth"]) <= tol, (g, w)


def test_benchmark_batch_config_over_a_cpu_mesh(monkeypatch, capsys):
    """Config 5 (the 64-pair batch) through ``parallel.sharded_flow`` over
    the one-device mesh, at a reduced shape: the same EPE as config 4's
    single pair, since every pair of the batch is that pair."""
    for idx in (4, 5):
        monkeypatch.setitem(tbench.CONFIGS, idx, dict(tbench.CONFIGS[idx], shape=(32, 48)))
    calls = []
    monkeypatch.setattr(tbench, "device_time",
                        lambda fn, *a, **k: calls.append(a[0].shape) or 1.0)
    tbench.main(["--configs", "4", "5", "--device", "cpu"])
    single, batch = _records(capsys)
    assert calls == [(32, 48), (64, 32, 48)]
    assert batch["fps"] == 64.0 and single["fps"] == 1.0
    assert batch["epe_vs_truth"] == single["epe_vs_truth"]


# --- evaluate ------------------------------------------------------------


def _write_flat(root, n_frames=3, h=64, w=80, velocity=(2.0, 1.0)):
    frames = uio.synthetic_sequence(n_frames, h, w, velocity=velocity, period=24)
    truth = np.full((h, w, 2), velocity, np.float32)
    for t in range(n_frames):
        viz.write_png(str(root / f"frame_{t:04d}.png"), frames[t])
        if t < n_frames - 1:
            uio.write_flo(str(root / f"frame_{t:04d}.flo"), truth)


def _write_kitti(root, h=64, w=80, velocity=(2.0, 1.0)):
    (root / "image_2").mkdir()
    (root / "flow_occ").mkdir()
    frames = uio.synthetic_sequence(3, h, w, velocity=velocity, period=24)
    truth = np.full((h, w, 2), velocity, np.float32)
    valid = np.ones((h, w), bool)
    valid[: h // 4] = False
    for k in range(2):
        viz.write_png(str(root / "image_2" / f"{k:06d}_10.png"), frames[k])
        viz.write_png(str(root / "image_2" / f"{k:06d}_11.png"), frames[k + 1])
        uio.write_flow_png(str(root / "flow_occ" / f"{k:06d}_10.png"), truth, valid)


def _write_sintel(root, h=64, w=80, velocity=(2.0, 1.0)):
    """Two sequences of three frames; the second with an occ/ mask whose
    band carries wrong truth, so the matched/unmatched split shows."""
    frames = uio.synthetic_sequence(3, h, w, velocity=velocity, period=24)
    truth = np.full((h, w, 2), velocity, np.float32)
    occ = np.zeros((h, w), np.uint8)
    occ[:, : w // 4] = 255
    truth_occ = truth.copy()
    truth_occ[:, : w // 4] = (30.0, -30.0)
    for seq in ("alley_1", "bandage_2"):
        fdir, gdir = root / "final" / seq, root / "flow" / seq
        fdir.mkdir(parents=True)
        gdir.mkdir(parents=True)
        for t in range(3):
            viz.write_png(str(fdir / f"frame_{t + 1:04d}.png"), frames[t])
            if t < 2:
                uio.write_flo(str(gdir / f"frame_{t + 1:04d}.flo"),
                              truth_occ if seq == "bandage_2" else truth)
                if seq == "bandage_2":
                    (root / "occ" / seq).mkdir(parents=True, exist_ok=True)
                    viz.write_png(str(root / "occ" / seq / f"frame_{t + 1:04d}.png"), occ)


def _write_pair_dirs(root, velocity=(2.0, 1.0)):
    """Three pair directories of three shapes (two buckets of 64)."""
    for i, (h, w) in enumerate([(60, 76), (56, 62), (40, 44)]):
        sub = root / f"seq{i}"
        sub.mkdir()
        frames = uio.synthetic_sequence(2, h, w, velocity=velocity, period=24)
        viz.write_png(str(sub / "frame_0.png"), frames[0])
        viz.write_png(str(sub / "frame_1.png"), frames[1])
        uio.write_flo(str(sub / "frame_0.flo"), np.full((h, w, 2), velocity, np.float32))


def _eval_both(capsys, argv, tol=EPE_TOL):
    """Run both tools; return the port's records after holding them to JAX's."""
    jeval.main([*argv, "--no-pallas"])
    want = _records(capsys)
    teval.main([*argv, "--device", "cpu"])
    got = _records(capsys)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g, w)
        for key, val in w.items():
            if key.startswith(("epe", "cold_epe")) and isinstance(val, float):
                assert abs(g[key] - val) <= tol, (key, g, w)
            elif not isinstance(val, float):
                assert g[key] == val, (key, g, w)
    return got


LK = ["--levels", "2", "--window", "9", "--margin", "12"]


@pytest.mark.parametrize("layout", ["KITTI", "Sintel", "pair-directories", "flat-sequence"])
def test_evaluate_layouts_match_jax(layout, tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    writer = {"KITTI": _write_kitti, "Sintel": _write_sintel,
              "pair-directories": _write_pair_dirs, "flat-sequence": _write_flat}[layout]
    writer(data)
    out = tmp_path / "out"
    extra = ["--bucket", "64"] if layout == "pair-directories" else []
    extra += ["--out", str(out)] if layout == "flat-sequence" else []
    got = _eval_both(capsys, ["--dataset", str(data), *LK, *extra])
    agg = got[-1]
    assert agg["layout"] == layout and agg["pairs"] == agg["pairs_with_truth"] == len(got) - 1
    if layout == "pair-directories":
        assert agg["compiles"] == 2  # distinct padded shapes: the two buckets
    if layout == "Sintel":
        assert agg["epe_unmatched"] > 10.0 > 0.5 > agg["epe_matched"]
    if layout == "flat-sequence":
        flo = uio.read_flo(str(out / "frame_0000.flo"))
        assert flo.shape == (64, 80, 2) and abs(np.median(flo[..., 0]) - 2.0) < 0.5
        assert (out / "frame_0000_color.png").exists() and (out / "frame_0000_flow.png").exists()


def test_evaluate_bucket_pads_and_crops_like_jax(tmp_path, capsys):
    """--bucket: edge-replicated padding, the flow cropped back; the padded
    shapes and the per-pair flows match the JAX tool's with the same bucket."""
    data = tmp_path / "data"
    data.mkdir()
    _write_pair_dirs(data)
    argv = ["--dataset", str(data), *LK, "--bucket", "64"]
    jeval.main([*argv, "--no-pallas", "--out", str(tmp_path / "jax")])
    want = _records(capsys)
    teval.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port")])
    got = _records(capsys)
    assert [r.get("padded_shape") for r in got] == [r.get("padded_shape") for r in want]
    assert {tuple(r["padded_shape"]) for r in got[:-1]} == {(64, 128), (64, 64)}
    assert got[-1]["compiles"] == want[-1]["compiles"] == 2
    for i in range(3):
        a = uio.read_flo(str(tmp_path / "jax" / f"seq{i}.flo"))
        b = uio.read_flo(str(tmp_path / "port" / f"seq{i}.flo"))
        np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("mode", ["warm-recover", "dis-cold"])
def test_evaluate_streaming_matches_jax(mode, tmp_path, capsys):
    _write_flat(tmp_path, n_frames=5)
    if mode == "warm-recover":
        extra = ["--streaming", "--warm-start", "--compare-cold", "--levels", "1",
                 "--window", "15", "--recover-levels", "3"]
    else:
        extra = ["--streaming", "--model", "dis", "--levels", "2"]
    got = _eval_both(capsys, ["--dataset", str(tmp_path), "--margin", "12", *extra])
    agg = got[-1]
    assert agg["chains"] == 1 and agg["pairs"] == 4
    assert [r["t"] for r in got[:-1]] == [0, 1, 2, 3]
    if mode == "warm-recover":
        assert agg["mode"] == "streaming-warm" and agg["recover_levels"] == 3
        assert all("cold_epe_mean" in r for r in got[:-1])


def test_evaluate_preset_matches_jax(tmp_path, capsys):
    _write_flat(tmp_path, n_frames=2, h=96, w=128)
    got = _eval_both(capsys, ["--dataset", str(tmp_path), "--preset", "paper_1080p",
                              "--margin", "16"])
    assert got[-1]["model"] == "LKConfig" and got[-1]["preset"] == "paper_1080p"


def test_evaluate_fill_occlusions_matches_jax(tmp_path, capsys):
    """--fill-occlusions on a Sintel-layout layered scene (TV-L1, both
    directions, cycle check, fill): records within the TV-L1 bound of JAX's."""
    sc = layered_scene(64, 80, bg_flow=(0.5, 0.5), seed=5,
                       layers=[Layer("disk", (30.0, 36.0), 14.0, (2.5, -1.5))])
    fdir, gdir, odir = (tmp_path / d / "seq" for d in ("final", "flow", "occ"))
    for d in (fdir, gdir, odir):
        d.mkdir(parents=True)
    for t, frame in enumerate((sc.prev, sc.nxt), start=1):
        np.save(fdir / f"frame_{t:04d}.npy", frame.astype(np.float32))
    uio.write_flo(str(gdir / "frame_0001.flo"), sc.flow)
    viz.write_png(str(odir / "frame_0001.png"), (sc.occ * 255).astype(np.uint8))
    argv = ["--dataset", str(tmp_path), "--model", "tvl1", "--levels", "2",
            "--iterations", "10", "--margin", "8"]
    filled = _eval_both(capsys, [*argv, "--fill-occlusions"], TVL1_EPE_TOL)[-1]
    assert filled["fill_occlusions"] is True and filled["layout"] == "Sintel"
    assert np.isfinite(filled["epe_matched"]) and np.isfinite(filled["epe_unmatched"])


@pytest.mark.parametrize("argv", [
    ["--warm-start"],
    ["--compare-cold"],
    ["--streaming", "--recover-levels", "2"],
    ["--streaming", "--fill-occlusions"],
    ["--preset", "tvl1_realtime", "--levels", "2"],
    ["--preset", "tvl1_realtime", "--window", "9"],
    ["--preset", "dis_realtime", "--iterations", "3"],
    ["--preset", "paper_1080p", "--window-weights", "tri"],
    ["--preset", "reference_gpu", "--refine-penalty", "charbonnier"],
    ["--model", "lk", "--refine-alpha", "40"],
    ["--model", "hs", "--window-weights", "box"],
], ids=lambda a: " ".join(a))
def test_evaluate_flag_errors_as_in_jax(argv, tmp_path, capsys):
    """Each conflicting flag combination is a usage error (exit 2) with the
    JAX tool's message."""
    errs = []
    for mod, dev in ((jeval, []), (teval, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--dataset", str(tmp_path), *argv, *dev])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "error:" in errs[1]


# --- diff ------------------------------------------------------------------


@pytest.mark.parametrize("model,backends", [
    ("lk", ["banded", "oracle"]), ("fb", ["banded"]), ("tvl1", ["plain"]),
])
def test_diff_prints_a_report(model, backends, capsys):
    tdiff.main(["--model", model, "--size", "64x64", "--levels", "2", "--iterations", "1",
                "--backends", *backends, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{backends[0]} vs plain" in out
    rows = out.strip().splitlines()
    assert rows and all(" vs plain: max " in r for r in rows)
    if "banded" in backends:
        assert all(float(r.split("max ")[1].split()[0]) == 0.0
                   for r in rows if "banded" in r)


def test_diff_refuses_the_kernel_backend_on_the_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        tdiff.main(["--size", "32x32", "--device", "cpu"])
    assert exc.value.code == 2
    assert "kernel backend needs a CUDA device" in capsys.readouterr().err


# --- demo ------------------------------------------------------------------


def _epe_lines(text):
    return [line for line in text.splitlines() if "EPE" in line]


def test_demo_writes_artifacts_and_matches_jax(tmp_path, capsys):
    """The artifacts tests/test_cli.py checks for (flow, arrows, the
    showTest gradient maps), the occlusion masks, the track overlays and the
    .flo files, and the same EPE lines as the JAX demo."""
    base = ["--synthetic", "3", "--size", "64x80", "--levels", "2", "--window", "9"]
    jdemo.main([*base, "--no-pallas"])
    want = _epe_lines(capsys.readouterr().out)
    out = str(tmp_path / "flow")
    tdemo.main([*base, "--device", "cpu", "--out", out, "--debug-gradients",
                "--occlusion", "--track", "3", "--flo"])
    text = capsys.readouterr().out
    assert _epe_lines(text) == want and len(want) == 2
    assert "EPE vs (2.0, 1.0)" in text and "fps end-to-end" in text
    files = os.listdir(out)
    for prefix in ("flow", "arrows", "occ", "tracks"):
        assert sum(f.startswith(prefix) and f.endswith(".png") for f in files) == 2, prefix
    assert sum(f.endswith(".flo") for f in files) == 2
    assert sum("_I" in f for f in files) == 2 * 2 * 3  # 2 frames x 2 levels x (x, y, t)
    flo = uio.read_flo(os.path.join(out, "flow0001.flo"))
    assert flo.shape == (64, 80, 2)


def test_demo_out_video(tmp_path, capsys):
    path = str(tmp_path / "flow.y4m")
    tdemo.main(["--synthetic", "4", "--size", "48x64", "--levels", "2", "--window", "9",
                "--device", "cpu", "--out-video", path])
    capsys.readouterr()
    lumas = list(uio.read_y4m(path))
    assert len(lumas) == 3 and lumas[0].shape == (48, 64)


@pytest.mark.parametrize("model", ["hs", "fb", "tvl1", "dis"])
def test_demo_models(model, capsys):
    tdemo.main(["--synthetic", "3", "--size", "64x80", "--levels", "2", "--model", model,
                "--iterations", "10", "--device", "cpu"])
    epe = [float(line.rsplit(":", 1)[1]) for line in _epe_lines(capsys.readouterr().out)]
    assert len(epe) == 2 and all(e < 0.6 for e in epe)


def test_demo_warm_start_with_recovery_and_native_stream(capsys):
    tdemo.main(["--synthetic", "5", "--size", "64x80", "--levels", "1", "--window", "15",
                "--warm-start", "--recover-levels", "2", "--native-stream", "--bilateral",
                "--device", "cpu"])
    epe = [float(line.rsplit(":", 1)[1]) for line in _epe_lines(capsys.readouterr().out)]
    assert len(epe) == 4 and all(e < 0.6 for e in epe)


def test_demo_frames_from_files(tmp_path, capsys):
    frames = uio.synthetic_sequence(3, 48, 64, velocity=(1.0, 0.0), period=24)
    for t, f in enumerate(frames):
        viz.write_png(str(tmp_path / f"f{t}.png"), f)
    tdemo.main(["--frames", str(tmp_path / "f*.png"), "--levels", "2", "--window", "9",
                "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("|flow| median") == 2 and "EPE" not in text
