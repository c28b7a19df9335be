"""The port's numpy scoring, scenes, I/O, visualization and small ops against
the JAX package (CPU).

``utils.metrics``, ``utils.layered``, ``utils.io`` and the numpy half of
``utils.viz`` are copies of the JAX package's modules (the port cannot
import them without loading jax); ``ops.color``, ``ops.resize.upscale_nn``,
``ops.conv.stencil2d`` and ``viz.flow_to_color_device`` are torch.

Tolerances: exact (``np.array_equal``, equal file bytes) for the metrics,
``layered_scene`` and ``boundary_band`` at the same seed, the writers' bytes
and the readers' round trips through both packages, ``grayscale_u8``,
``upscale_nn``, ``stencil2d`` (the same taps summed in the same order) and
``flow_to_color``; ``flow_to_color_device`` within one intensity level of
``flow_to_color`` (float32 against float64 at floor boundaries), as the JAX
package holds its own device colorizer (tests/test_tracking.py).
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.ops import color as jcolor
from cuda_optical_flow_2_tpu.ops import conv as jconv
from cuda_optical_flow_2_tpu.ops import resize as jresize
from cuda_optical_flow_2_tpu.utils import io as jio
from cuda_optical_flow_2_tpu.utils import layered as jlayered
from cuda_optical_flow_2_tpu.utils import metrics as jmetrics
from cuda_optical_flow_2_tpu.utils import viz as jviz

from cuda_optical_flow_2_torch import ops as tops
from cuda_optical_flow_2_torch.models.horn_schunck import _DXC
from cuda_optical_flow_2_torch.utils import io as tio
from cuda_optical_flow_2_torch.utils import layered as tlayered
from cuda_optical_flow_2_torch.utils import metrics as tmetrics
from cuda_optical_flow_2_torch.utils import viz as tviz


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: small plain ops spread over every core contend
    under several pytest workers (see tests/test_torch_spatial.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flow_and_truth(seed=0, h=40, w=56):
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    truth = (flow + rng.normal(0, 2, (h, w, 2))).astype(np.float32)
    truth[3, 4] = (1e10, 0.0)  # Middlebury's unknown-truth sentinel
    truth[5, 6] = (np.nan, 1.0)
    occ = rng.random((h, w)) < 0.2
    return flow, truth, occ


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


METRIC_CASES = {
    "epe": lambda m, f, t, o: m.epe(f, t),
    "mean_epe": lambda m, f, t, o: m.mean_epe(f, t),
    "mean_epe_margin": lambda m, f, t, o: m.mean_epe(f, t, margin=4),
    "angular_error": lambda m, f, t, o: m.angular_error(f, t),
    "outlier_rate": lambda m, f, t, o: m.outlier_rate(f, t, abs_thresh=2.0),
    "evaluate_flow": lambda m, f, t, o: m.evaluate_flow(f, t, margin=3),
    "evaluate_flow_occ": lambda m, f, t, o: m.evaluate_flow(f, t, margin=3, occ=o),
    "evaluate_flow_all_occ": lambda m, f, t, o: m.evaluate_flow(f, t, occ=np.ones_like(o)),
    "flow_stats": lambda m, f, t, o: m.flow_stats(np.where(t > 1e9, np.inf, f)),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_match_jax(case):
    """Equal results from numpy inputs, and from tensors of the same data."""
    f, t, o = _flow_and_truth()
    fn = METRIC_CASES[case]
    want = fn(jmetrics, f, t, o)
    _assert_same(fn(tmetrics, f, t, o), want)
    _assert_same(fn(tmetrics, torch.from_numpy(f), torch.from_numpy(t), torch.from_numpy(o)), want)


SCENES = {
    "disk": dict(h=192, w=256, bg_flow=(-2.0, 1.0), seed=3,
                 layers=[("disk", (96.0, 128.0), 45.0, (3.0, 1.0))]),
    "bar": dict(h=192, w=256, bg_flow=(-3.0, 0.0), seed=7,
                layers=[("rect", (96.0, 128.0), (120.0, 22.0), (4.0, 0.0))]),
    "two_layers_soft_unclipped": dict(
        h=64, w=96, bg_flow=(0.5, -1.25), seed=11, edge=2.5, clip=False, bg_contrast=90.0,
        layers=[("disk", (30.0, 40.0), 14.0, (2.25, 0.5)),
                ("rect", (40.0, 60.0), (9.0, 16.0), (-1.5, 1.0))]),
}


def _scene(mod, spec):
    kw = dict(spec)
    h, w = kw.pop("h"), kw.pop("w")
    layers = [mod.Layer(kind, c, s, fl) for kind, c, s, fl in kw.pop("layers")]
    return mod.layered_scene(h, w, layers=layers, **kw)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_layered_scene_byte_identical(name):
    want = _scene(jlayered, SCENES[name])
    got = _scene(tlayered, SCENES[name])
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k in (0, 2, 6):
        band = tlayered.boundary_band(got.owner, k)
        np.testing.assert_array_equal(band, jlayered.boundary_band(want.owner, k))


def test_layer_validation_matches_jax():
    for mod in (jlayered, tlayered):
        with pytest.raises(ValueError, match="unknown layer kind"):
            mod.Layer("blob")
        with pytest.raises(ValueError, match="rect layers need"):
            mod.Layer("rect", size=4.0)


def _frames_u8(n=3, h=20, w=28, rgb=False, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3) if rgb else (n, h, w)).astype(np.uint8)


def _write_flow_png(mod, path):
    f, _t, _o = _flow_and_truth(seed=1, h=12, w=17)
    valid = np.ones(f.shape[:2], bool)
    valid[2, 3] = False
    f[4, 5] = np.nan  # invalid by default mask too
    mod.write_flow_png(path, f, valid & np.isfinite(f).all(-1))


WRITERS = {
    "flo": ("f.flo", lambda m, p: m.write_flo(p, _flow_and_truth(h=9, w=13)[0])),
    "flow_png": ("f.png", _write_flow_png),
    "ppm_rgb": ("i.ppm", lambda m, p: m.write_ppm(p, _frames_u8(1, rgb=True)[0])),
    "pgm": ("i.pgm", lambda m, p: m.write_ppm(p, _frames_u8(1)[0])),
    "y4m_gray": ("v.y4m", lambda m, p: m.write_y4m(p, _frames_u8(3))),
    "y4m_rgb": ("v.y4m", lambda m, p: m.write_y4m(p, _frames_u8(2, rgb=True), fps=(25, 2))),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writers_byte_identical(tmp_path, name):
    fname, write = WRITERS[name]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    write(jio, str(tmp_path / "j" / fname))
    write(tio, str(tmp_path / "t" / fname))
    assert (tmp_path / "t" / fname).read_bytes() == (tmp_path / "j" / fname).read_bytes()


READERS = {
    "flo": ("f.flo", lambda m, p: m.read_flo(p)),
    "flo_by_ext": ("f.flo", lambda m, p: m.read_flow(p)),
    "flow_png": ("f.png", lambda m, p: m.read_flow_png(p)),
    "flow_png_by_ext": ("f.png", lambda m, p: m.read_flow(p)),
    "ppm_rgb": ("i.ppm", lambda m, p: m.read_image(p)),
    "pgm": ("i.pgm", lambda m, p: m.read_ppm(p)),
    "y4m_gray": ("v.y4m", lambda m, p: np.stack(list(m.read_y4m(p)))),
    "y4m_rgb": ("v.y4m", lambda m, p: np.stack(list(m.read_y4m(p)))),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_round_trip_both_ways(tmp_path, name):
    """Each package's reader gives the same array from either package's file."""
    fname, read = READERS[name]
    write = WRITERS[name.replace("_by_ext", "")][1]
    for writer in (jio, tio):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}_{fname}")
        write(writer, path)
        np.testing.assert_array_equal(read(tio, path), read(jio, path))


def test_read_image_npy_and_unknown(tmp_path):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "a.npy", a)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "a.npy")), a)
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="unsupported image format"):
            mod.read_image(str(tmp_path / "a.bmp"))
        with pytest.raises(ValueError, match="unsupported flow format"):
            mod.read_flow(str(tmp_path / "a.bmp"))


def test_read_y4m_resync_matches_jax(tmp_path):
    """A corrupt frame marker yields None and the reader resyncs at the next
    FRAME; without resync both raise."""
    path = tmp_path / "v.y4m"
    jio.write_y4m(str(path), _frames_u8(4))
    data = path.read_bytes()
    second = data.index(b"FRAME", data.index(b"FRAME") + 1)
    path.write_bytes(data[:second] + b"FRAMX" + data[second + 5:])
    got = list(tio.read_y4m(str(path), resync=True))
    want = list(jio.read_y4m(str(path), resync=True))
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g, w)
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="frame marker"):
            list(mod.read_y4m(str(path)))


@pytest.mark.parametrize("depth", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3])
def test_pure_png_decoder_matches_libpng(tmp_path, depth, channels):
    """libpng (cv2.imwrite) writes adaptive sub/up/average/paeth rows: the
    port's pure decoder reconstructs them, as the JAX reader does."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(channels)
    h, w = 37, 53
    hi = 256 if depth == np.uint8 else 65536
    yy, xx = np.mgrid[:h, :w]
    img = (((yy * 7 + xx * 3) % hi + rng.integers(0, hi // 8, (h, w))) % hi).astype(depth)
    if channels == 3:
        i64 = img.astype(np.int64)
        img = np.stack([i64, i64 // 2, (i64 * 3) % hi], axis=-1).astype(depth)
    path = str(tmp_path / "t.png")
    assert cv2.imwrite(path, img if channels == 1 else img[..., ::-1])
    with open(path, "rb") as f:
        np.testing.assert_array_equal(tio._decode_png(f.read()), img)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


def test_png_header_gate_rejects_palette(tmp_path):
    """A palette PNG fails the header gate in both packages, whatever decoder
    the environment has."""
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    path = tmp_path / "p.png"
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0))
        + chunk(b"PLTE", b"\x00\x00\x00") + chunk(b"IDAT", zlib.compress(b"\x00\x00\x00" * 2))
        + chunk(b"IEND", b""))
    assert not tio._png_header_ok(str(path)) and not jio._png_header_ok(str(path))
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="only 8/16-bit"):
            mod.read_image(str(path))


def test_flow_png_saturation_warns(tmp_path):
    flow = np.zeros((4, 4, 2), np.float32)
    flow[0, 0, 0] = 600.0
    with pytest.warns(RuntimeWarning, match="KITTI PNG range"):
        tio.write_flow_png(str(tmp_path / "f.png"), flow)


def test_synthetic_sequence_matches_jax():
    np.testing.assert_array_equal(
        tio.synthetic_sequence(3, 24, 40, velocity=(1.5, -0.5), period=11, seed=4),
        jio.synthetic_sequence(3, 24, 40, velocity=(1.5, -0.5), period=11, seed=4),
    )


def test_grayscale_matches_jax():
    rgb = _frames_u8(2, rgb=True)
    np.testing.assert_array_equal(
        tops.grayscale_u8(torch.from_numpy(rgb)).numpy(), np.asarray(jcolor.grayscale_u8(rgb)))
    assert tops.grayscale_u8(torch.from_numpy(rgb)).dtype == torch.uint8
    np.testing.assert_array_equal(
        tops.grayscale(torch.from_numpy(rgb)).numpy(),
        np.asarray(jcolor.grayscale(jnp.asarray(rgb))))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_upscale_nn_matches_jax(n):
    img = _frames_u8(2, h=5, w=7)
    np.testing.assert_array_equal(
        tops.upscale_nn(torch.from_numpy(img), n).numpy(), np.asarray(jresize.upscale_nn(img, n)))


@pytest.mark.parametrize("mask", ["dxc", "dyc", "sparse5x4"])
def test_stencil2d_matches_jax(mask):
    m = {"dxc": _DXC, "dyc": _DXC.T,
         "sparse5x4": np.array([[0, 1, 0, 2], [0.5, 0, 0, 0], [0, 0, -3, 0], [0, 0, 0, 0.25],
                                [1, 0, 0, 0]], np.float32)}[mask]
    x = np.random.default_rng(2).normal(0, 10, (2, 13, 17)).astype(np.float32)
    got = tops.stencil2d(torch.from_numpy(x), m).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconv.stencil2d(jnp.asarray(x), m)))
    u8 = x.astype(np.uint8)
    np.testing.assert_array_equal(
        tops.stencil2d(torch.from_numpy(u8), m).numpy(),
        np.asarray(jconv.stencil2d(jnp.asarray(u8), m)))


def _color_flow():
    flow = np.random.default_rng(0).normal(0, 3, (48, 64, 2)).astype(np.float32)
    flow[5, 5] = (np.nan, 1.0)
    flow[10, 10] = (np.inf, -2.0)
    flow[11, 11] = (0.0, -np.inf)
    return flow


@pytest.mark.parametrize("max_flow", [None, 4.0])
def test_flow_to_color_matches_jax(max_flow):
    flow = _color_flow()
    want = jviz.flow_to_color(flow, max_flow=max_flow)
    np.testing.assert_array_equal(tviz.flow_to_color(flow, max_flow=max_flow), want)
    np.testing.assert_array_equal(tviz.flow_to_color(torch.from_numpy(flow), max_flow), want)


@pytest.mark.parametrize("max_flow", [None, 4.0])
def test_flow_to_color_device_within_one_level(max_flow):
    """The torch colorizer (arithmetic wheel) within one level of the numpy
    one, NaN and inf included, from a tensor and from an array on the CPU."""
    flow = _color_flow()
    want = jviz.flow_to_color(flow, max_flow=max_flow).astype(int)
    for got in (tviz.flow_to_color_device(torch.from_numpy(flow), max_flow),
                tviz.flow_to_color_device(flow, max_flow, device="cpu")):
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        assert np.abs(got.numpy().astype(int) - want).max() <= 1
    with pytest.raises(ValueError, match="max_flow"):
        tviz.flow_to_color_device(torch.from_numpy(flow), max_flow=-1.0)


def test_draw_and_cleanup_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 52)).astype(np.uint8)
    flow = rng.normal(0, 4, (40, 52, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    np.testing.assert_array_equal(
        tviz.draw_flow_arrows(img, flow, arrow_res=8),
        jviz.draw_flow_arrows(img, flow, arrow_res=8))
    np.testing.assert_array_equal(
        tviz.draw_flow_arrows(torch.from_numpy(img), torch.from_numpy(flow), arrow_res=8),
        jviz.draw_flow_arrows(img, flow, arrow_res=8))
    hist = [rng.uniform(-2, 54, (6, 2)).astype(np.float32) for _ in range(3)]
    hist[1][2] = np.nan
    alive = np.array([True, True, True, False, True, True])
    want = jviz.draw_tracks(img, hist, alive=alive)
    np.testing.assert_array_equal(tviz.draw_tracks(img, hist, alive=alive), want)
    np.testing.assert_array_equal(
        tviz.draw_tracks(img, [torch.from_numpy(h) for h in hist], torch.from_numpy(alive)), want)
    np.testing.assert_array_equal(tviz.draw_tracks(img, [])[..., 0], img)
    np.testing.assert_array_equal(tviz.cleanup_outliers(img), jviz.cleanup_outliers(img))


@pytest.mark.parametrize("rgb", [False, True])
def test_write_png_byte_identical(tmp_path, rgb):
    img = _frames_u8(1, rgb=rgb)[0]
    tviz.write_png(str(tmp_path / "t.png"), img)
    jviz.write_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    with pytest.raises(ValueError, match="uint8"):
        tviz.write_png(str(tmp_path / "x.png"), img.astype(np.float32))
