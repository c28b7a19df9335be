"""The bilateral at the edges of the global image and of a band, on the CPU.

The CUDA kernel (``csrc/bilateral.cu``) tests no tap against the image
bounds: it stages a position outside the global image with a ``+inf`` guide
and a zero image, whose range weight ``exp(-inf) = +0`` adds exactly nothing
to ``num`` and ``den``, as the plain version's masked weight does.  The
first two tests hold that rule, run under the plain version's arithmetic, to
``ops.bilateral.bilateral_filter_band`` bit for bit, and show that zeros in
place of the ``+inf`` would count the outside taps.  The card holds the
kernel itself to the plain version on such bands (``chip_smoke.py`` phase 3).

The rest run the port's band and whole-image wrappers, which take the plain
version for CPU tensors, against the JAX package's ``ops.bilateral`` at the
edges the kernel's staging must reproduce: bands past the top (``row0 < 0``),
past the bottom (``row0 + H > Hg``) and past both, bands shorter than the
kernel's 32-row tile or than the window, at r = 0; at the largest radius,
r = 15, the band is held to the port's whole image.  Tolerance 1e-4 on intensities 0-255, as
``tests/test_torch_spatial_kernels.py`` holds the band (exp differs by an ulp
between the two libraries), on the rows the JAX band function defines: those
whose taps leave the band only where they leave the global image (its other
rows read rolled-around values and are cropped by its callers).  Rows outside
the global image come out zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cuda_optical_flow_2_torch.kernels import bilateral_tap
from cuda_optical_flow_2_torch.ops.bilateral import bilateral_constants, bilateral_filter_band
from cuda_optical_flow_2_tpu.ops import bilateral as jbilateral

IMG_TOL = 1e-4


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) * 255


def staged_filter(img, row0, h_global, window, sigma_spatial=2.0, sigma_range=10.0,
                  outside=float("inf")):
    """The band filter with the kernel's staging rule in place of a mask:
    every tap counts, and a position outside the global image carries the
    guide ``outside`` and a zero image."""
    spatial, range_norm, inv_2s2 = bilateral_constants(window, sigma_spatial, sigma_range)
    r = window // 2
    h, w = img.shape[-2:]
    gy = torch.arange(-r, h + r)[:, None] + row0
    gx = torch.arange(-r, w + r)[None, :]
    in_image = (gy >= 0) & (gy < h_global) & (gx >= 0) & (gx < w)
    img_p = F.pad(img, (r, r, r, r))  # zero outside the band
    img_p = torch.where(in_image, img_p, torch.zeros(()))
    guide_p = torch.where(in_image, img_p, torch.full((), outside))
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for m in range(window):
        for n in range(window):
            g_s = guide_p[..., m : m + h, n : n + w]
            i_s = img_p[..., m : m + h, n : n + w]
            k = g_s - img
            wgt = float(range_norm) * torch.exp(-(k * k) * float(inv_2s2)) * float(spatial[m, n])
            num = num + i_s * wgt
            den = den + wgt
    ys = torch.arange(h)[:, None] + row0
    return torch.where((ys >= 0) & (ys < h_global), num / den, 0.0)


@pytest.mark.parametrize("window", [9, bilateral_tap.MAX_WINDOW])
def test_staged_infinity_masks_exactly(window):
    """A band past both edges of the global image, shorter than a tile."""
    img = torch.as_tensor(_image((2, 30, 33), window))
    want = bilateral_filter_band(img, -5, 18, window)
    got = staged_filter(img, -5, 18, window)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_zeros_in_place_of_infinity_would_count_the_outside_taps():
    img = torch.as_tensor(_image((1, 20, 45), 5))
    want = bilateral_filter_band(img, -6, 50, 9)
    zeros = staged_filter(img, -6, 50, 9, outside=0.0)
    assert not torch.equal(zeros, want)
    # pixels whose taps all lie inside the image
    assert torch.equal(zeros[:, 10:, 4:-4], want[:, 10:, 4:-4])


BANDS = [
    # (B, H, W, row0, Hg, window)
    (1, 20, 45, -6, 50, 9),  # past the top
    (1, 20, 45, 40, 55, 9),  # past the bottom
    (2, 30, 33, -5, 18, 9),  # past both, shorter than a tile
    (1, 6, 31, -1, 4, 9),  # a band shorter than the window, past both
    (1, 9, 12, -2, 6, 1),  # r = 0
    (1, 40, 20, 7, 100, 5),  # interior band
]


def _defined_rows(h, row0, hg, r):
    """(rows inside the global image, those of them whose taps past the
    band's top or bottom edge, if any, lie outside the image)."""
    y = np.arange(h)
    live = (y + row0 >= 0) & (y + row0 < hg)
    return live, live & ((y >= r) | (row0 <= 0)) & ((y < h - r) | (row0 + h >= hg))


@pytest.mark.parametrize("b, h, w, row0, hg, window", BANDS)
def test_band_matches_jax_at_the_edges(b, h, w, row0, hg, window):
    img = _image((b, h, w), h * w + window)
    got = bilateral_tap.bilateral_kernel_band(torch.from_numpy(img), row0, hg, window).numpy()
    want = np.asarray(jbilateral.bilateral_filter_band(jnp.asarray(img), row0, hg, window))
    live, defined = _defined_rows(h, row0, hg, window // 2)
    assert defined.any()
    np.testing.assert_allclose(got[:, defined], want[:, defined], rtol=IMG_TOL, atol=IMG_TOL)
    assert not got[:, ~live].any()


@pytest.mark.parametrize("row0, h, hg", [(-15, 48, 30), (20, 36, 80)],
                         ids=["past-both", "interior"])
def test_band_at_the_largest_window_is_the_whole_image(row0, h, hg):
    """r = 15 (the JAX filter takes minutes at 961 taps on the CPU): band rows
    are the whole image's rows, bit for bit, the band cut as spatial TP cuts
    it, zero outside the global image."""
    window = bilateral_tap.MAX_WINDOW
    img = _image((1, hg, 40), 15)
    whole = bilateral_tap.bilateral_kernel(torch.from_numpy(img), window).numpy()
    rows = np.arange(h) + row0
    band = np.where(((rows >= 0) & (rows < hg))[None, :, None],
                    img[:, np.clip(rows, 0, hg - 1)], 0.0).astype(np.float32)
    got = bilateral_tap.bilateral_kernel_band(torch.from_numpy(band), row0, hg, window).numpy()
    live, defined = _defined_rows(h, row0, hg, window // 2)
    assert defined.any()
    np.testing.assert_array_equal(got[:, defined], whole[:, rows[defined]])
    assert not got[:, ~live].any()


@pytest.mark.parametrize("window", [1, 5, 9])
def test_guided_whole_image_matches_jax(window):
    """The whole-image entry on a ragged batch no tile divides, guided by
    another image, past every edge."""
    img, guide = _image((2, 37, 45), window), _image((2, 37, 45), window + 1)
    got = bilateral_tap.bilateral_kernel(
        torch.from_numpy(img), window, guide=torch.from_numpy(guide)).numpy()
    want = np.asarray(jbilateral.bilateral_filter(jnp.asarray(img), jnp.asarray(guide), window))
    np.testing.assert_allclose(got, want, rtol=IMG_TOL, atol=IMG_TOL)
