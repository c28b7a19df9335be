"""Frame and flow I/O and synthetic sequences (numpy only).

A copy of ``cuda_optical_flow_2_tpu.utils.io``, which the port cannot import
without loading jax: Y4M video (``read_y4m`` with resync, ``Y4MWriter``,
``write_y4m``), PPM/PGM, PNG (8/16-bit gray or RGB: OpenCV decodes when it is
importable, a pure decoder otherwise, behind one header check so the accepted
files do not depend on the environment), Middlebury ``.flo`` and KITTI 16-bit
flow PNG, and ``synthetic_sequence``.  ``tests/test_torch_eval_utils.py``
holds the two packages' readers and writers equal.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = [
    "read_ppm",
    "write_ppm",
    "read_image",
    "read_flo",
    "write_flo",
    "read_flow",
    "read_flow_png",
    "write_flow_png",
    "read_y4m",
    "write_y4m",
    "Y4MWriter",
    "synthetic_sequence",
]


def read_y4m(path: str, resync: bool = False):
    """Yield the luma plane of each frame of a Y4M video as (H, W) uint8.

    Y4M (YUV4MPEG2) is the standard uncompressed video interchange format
    (``ffmpeg -i clip.mp4 out.y4m``); the luma (Y) plane IS the grayscale
    frame, so chroma planes are skipped unread.  Supports C420*/C422*/C444/
    Cmono colorspaces.  Pure-Python twin of the native Y4M FrameStream
    source (native/framesrc.cpp); the reference's video input is an OpenCV
    webcam capture (main.cu:181-184).

    With ``resync=True`` a corrupt frame yields ``None`` instead of raising
    and the reader RESYNCS: it scans forward for the next ``FRAME`` magic
    and continues decoding from there — one corrupt frame costs one
    failure, not the rest of the video (the FrameStream per-frame-failure
    contract; same recovery as the native reader).  A header error raises
    either way.
    """
    with open(path, "rb") as f:
        header = f.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError(f"not a Y4M stream: {path}")
        w = h = 0
        chroma = "420jpeg"
        for tok in header.split()[1:]:
            if tok[:1] == b"W":
                w = int(tok[1:])
            elif tok[:1] == b"H":
                h = int(tok[1:])
            elif tok[:1] == b"C":
                chroma = tok[1:].decode()
        if w <= 0 or h <= 0:
            raise ValueError(f"malformed Y4M header: {header!r}")
        # Only 8-bit colorspaces: bit-depth variants (C420p10, C444p16,
        # mono12, ...) carry 2-byte samples — reading w*h bytes would yield
        # a garbage half-frame.  The 4:2:0 suffixes are chroma SITING only.
        cw, ch2 = (w + 1) // 2, (h + 1) // 2
        if chroma in ("420", "420jpeg", "420paldv", "420mpeg2"):
            skip = 2 * cw * ch2
        elif chroma == "422":
            skip = 2 * cw * h
        elif chroma == "444":
            skip = 2 * w * h
        elif chroma == "mono":
            skip = 0
        else:
            raise ValueError(f"unsupported Y4M colorspace C{chroma}")
        while True:
            # Read exactly the 5 magic bytes (mirrors the native reader,
            # framesrc.cpp y4m_read_frame): a readline here would consume
            # through the next '\n' in the stream, which on a corrupt
            # marker can swallow the NEXT frame's real "FRAME\n" and lose
            # a good frame that the native twin recovers.
            magic = f.read(5)
            if not magic:
                return  # clean EOF at a frame boundary
            if magic != b"FRAME":
                if not resync:
                    raise ValueError(
                        f"malformed Y4M frame marker: {magic!r}"
                    )
                yield None
                if not _y4m_scan_to_frame(f):
                    return  # EOF while scanning: nothing left to decode
            f.readline()  # rest of the marker line (params + '\n')
            y = f.read(w * h)
            if len(y) != w * h:
                if not resync:
                    raise ValueError("truncated Y4M frame")
                yield None
                return  # short read == EOF: a truncated final frame
            if skip and len(f.read(skip)) != skip:
                if not resync:
                    raise ValueError("truncated Y4M chroma planes")
                yield None
                return
            yield np.frombuffer(y, np.uint8).reshape(h, w).copy()


def _y4m_scan_to_frame(f) -> bool:
    """Consume bytes up to and including the next ``FRAME`` magic.

    Frame payloads are raw bytes with no trailing newline, so the scan
    matches the bare 5-byte magic (a pixel run spelling FRAME is a ~256^-5
    per-position false positive; a wrong sync point just fails the next
    marker check and rescans).  Returns False at EOF.
    """
    pat = b"FRAME"
    carry = b""
    while True:
        chunk = f.read(1 << 16)
        if not chunk:
            return False
        buf = carry + chunk
        i = buf.find(pat)
        if i >= 0:
            # Rewind to just past the magic (buffered search reads ahead;
            # byte-at-a-time was a multi-second stall per corrupt 1080p
            # frame in the pure-Python fallback).
            f.seek(i + len(pat) - len(buf), 1)
            return True
        carry = buf[-(len(pat) - 1):]


def _rgb_to_yuv444(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BT.601 studio-range RGB -> (Y, Cb, Cr) uint8 planes (what players
    assume for Y4M without an XCOLORRANGE extension)."""
    r, g, b = (rgb[..., k].astype(np.float32) for k in range(3))
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    cb = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    cr = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    to8 = lambda p: np.clip(p + 0.5, 0, 255).astype(np.uint8)  # noqa: E731
    return to8(y), to8(cb), to8(cr)


class Y4MWriter:
    """Incremental Y4M writer: ``write()`` one frame at a time (bounded
    memory on unbounded streams), or use :func:`write_y4m` for an iterable.

    Gray (H, W) uint8 frames emit a Cmono stream; RGB (H, W, 3) uint8 frames
    (e.g. ``viz.flow_to_color`` output) emit C444 with BT.601 studio-range
    conversion — ``ffplay out.y4m`` is the headless twin of the reference's
    live ``cv::imshow`` windows (main.cu:264-268).  All frames must match
    the first frame's shape.  Context manager; ``close()`` is idempotent.
    """

    def __init__(self, path: str, fps: tuple[int, int] = (30, 1)):
        self._f = open(path, "wb")
        self._fps = fps
        self._shape: tuple[int, ...] | None = None

    def write(self, frame) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim not in (2, 3) or (
            frame.ndim == 3 and frame.shape[-1] != 3
        ):
            raise ValueError("Y4MWriter expects (H, W) or (H, W, 3) uint8")
        if self._shape is None:
            h, w = frame.shape[:2]
            cs = b"Cmono" if frame.ndim == 2 else b"C444"
            self._f.write(
                b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 %s\n"
                % (w, h, self._fps[0], self._fps[1], cs)
            )
            self._shape = frame.shape
        elif frame.shape != self._shape:
            raise ValueError(
                f"frame shape {frame.shape} != stream shape {self._shape}"
            )
        self._f.write(b"FRAME\n")
        if frame.ndim == 2:
            self._f.write(frame.tobytes())
        else:
            for plane in _rgb_to_yuv444(frame):
                self._f.write(plane.tobytes())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Y4MWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def write_y4m(path: str, frames, fps: tuple[int, int] = (30, 1)) -> None:
    """Write uint8 frames as a Y4M video: (H, W) luma -> Cmono,
    (H, W, 3) RGB -> C444 (see :class:`Y4MWriter`)."""
    with Y4MWriter(path, fps) as wr:
        for frame in frames:
            wr.write(frame)


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM / P5 PGM into (H, W, 3) / (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(data) and not data[i : i + 1].isspace():
            i += 1
        tokens.append(data[start:i])
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"only maxval 255 supported, got {maxval}")
    # Exactly ONE whitespace byte separates maxval from the raster (PNM
    # spec) — but tolerate a CRLF written by text-mode tools, which would
    # otherwise shift every pixel by one byte.
    i += 1
    if data[i - 1 : i] == b"\r" and data[i : i + 1] == b"\n":
        i += 1
    payload = data[i:]
    if magic == b"P6":
        return np.frombuffer(payload[: w * h * 3], np.uint8).reshape(h, w, 3).copy()
    if magic == b"P5":
        return np.frombuffer(payload[: w * h], np.uint8).reshape(h, w).copy()
    raise ValueError(f"unsupported magic {magic!r}")


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as P6 or (H, W) uint8 as P5."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_ppm expects uint8")
    h, w = img.shape[:2]
    magic = b"P6" if img.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _png_header_ok(path: str) -> bool:
    """True when the PNG's IHDR is in the supported domain (8/16-bit,
    color type 0 gray or 2 RGB, non-interlaced).  Checked BEFORE handing
    the file to cv2 so the accepted input domain does not vary with the
    environment: a palette/interlaced/alpha PNG is rejected
    identically whether or not OpenCV is importable."""
    try:
        with open(path, "rb") as f:
            head = f.read(33)
    except OSError:
        return False
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        return False
    _, _, bitdepth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return bitdepth in (8, 16) and ctype in (0, 2) and not interlace


def _read_png_cv2(path: str) -> np.ndarray | None:
    """Decode via OpenCV when importable (C-speed adaptive-filter inflate);
    None when cv2 is absent or declines the file.  Output matches the pure
    decoder: (H, W) gray or (H, W, 3) RGB, uint8/uint16 at native depth.
    Only called for headers the pure decoder also accepts (_png_header_ok),
    so behavior is environment-independent."""
    try:
        import cv2
    except ImportError:
        return None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None or img.dtype not in (np.uint8, np.uint16):
        return None
    if img.ndim == 3:
        if img.shape[-1] == 4:
            img = img[..., :3]
        img = img[..., ::-1].copy()  # BGR -> RGB
    return img


def _read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8/16-bit, color type 0 (gray) or 2 (RGB), no interlace.

    Returns uint8 for 8-bit files, uint16 (host-endian, decoded from the PNG's
    big-endian samples) for 16-bit files — the latter is how KITTI encodes
    flow ground truth (see :func:`read_flow_png`).

    Real libpng output (e.g. KITTI ground truth) uses adaptive per-row
    filtering whose left-predicting filters decode sequentially; when OpenCV
    is importable it decodes instead (two orders of magnitude faster on
    1242x375 KITTI frames), with this pure-Python path as the zero-dependency
    fallback (sub/up vectorized; average/paeth per-byte).
    """
    if _png_header_ok(path):
        fast = _read_png_cv2(path)
        if fast is not None:
            return fast
    with open(path, "rb") as f:
        return _decode_png(f.read())


def _decode_png(data: bytes) -> np.ndarray:
    """The pure-Python PNG decoder behind :func:`_read_png` (the path that
    works without OpenCV): the same formats and outputs."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    i = 8
    idat = b""
    w = h = bitdepth = ctype = None
    while i < len(data):
        (ln,) = struct.unpack(">I", data[i : i + 4])
        tag = data[i + 4 : i + 8]
        body = data[i + 8 : i + 8 + ln]
        if tag == b"IHDR":
            w, h, bitdepth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if bitdepth not in (8, 16) or ctype not in (0, 2) or interlace:
                raise ValueError(
                    "only 8/16-bit non-interlaced gray/RGB PNG supported"
                )
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        i += 12 + ln
    raw = zlib.decompress(idat)
    ch = 3 if ctype == 2 else 1
    # PNG filters operate byte-wise with a bytes-per-pixel offset, regardless
    # of sample depth (RFC 2083 section 6) — only `bpp` changes for 16-bit.
    bpp = ch * (bitdepth // 8)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(h):
        ft = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos : pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ft == 0:
            rec = line
        elif ft == 2:  # up
            rec = (line + prev) % 256
        elif ft == 1:  # sub
            # rec[j] = line[j] + rec[j-bpp]: a running sum per byte lane
            # (j mod bpp) — vectorized as a cumsum over the pixel axis.
            rec = (
                np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                .reshape(-1) % 256
            ).astype(np.int32)
        elif ft == 3:  # average
            rec = line.copy()
            for j in range(stride):
                left = rec[j - bpp] if j >= bpp else 0
                rec[j] = (rec[j] + (left + int(prev[j])) // 2) % 256
        elif ft == 4:  # paeth
            rec = line.copy()
            for j in range(stride):
                a = int(rec[j - bpp]) if j >= bpp else 0
                b = int(prev[j])
                c = int(prev[j - bpp]) if j >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[j] = (rec[j] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter {ft}")
        out[row] = rec.astype(np.uint8)
        prev = out[row].astype(np.uint8)
    if bitdepth == 16:
        img = out.reshape(h, w * ch, 2)
        img16 = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        img16 = img16.reshape(h, w, ch)
        return img16[..., 0] if ch == 1 else img16
    img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_image(path: str) -> np.ndarray:
    """Dispatch by extension: .ppm/.pgm, .png, .npy."""
    lower = path.lower()
    if lower.endswith((".ppm", ".pgm")):
        return read_ppm(path)
    if lower.endswith(".png"):
        return _read_png(path)
    if lower.endswith(".npy"):
        return np.load(path)
    raise ValueError(f"unsupported image format: {path}")


def synthetic_sequence(
    n_frames: int,
    h: int = 480,
    w: int = 640,
    velocity: tuple[float, float] = (2.0, 1.0),
    period: int = 16,
    seed: int = 0,
    noise: float = 1.0,
) -> np.ndarray:
    """(N, H, W) uint8 frames of a textured field translating at ``velocity``
    pixels per frame (the ground truth).  Deterministic given the seed."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = np.zeros((n_frames, h, w), np.uint8)
    vx, vy = velocity
    for t in range(n_frames):
        sx, sy = xs - vx * t, ys - vy * t
        img = (
            127.0
            + 55.0 * np.sin(2 * np.pi * sx / period) * np.sin(2 * np.pi * sy / period)
            + 35.0 * np.sin(2 * np.pi * (sx + sy) / (period * 2.7))
        )
        if noise:
            img = img + rng.normal(0, noise, img.shape)
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


_FLO_MAGIC = 202021.25  # Middlebury sanity constant ("PIEH")


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float32 flow field in Middlebury .flo format.

    The de-facto interchange format for dense optical flow (header: the
    float 202021.25, then int32 width/height, then row-major interleaved
    (u, v) float32).  The reference has no flow IO at all — its fields only
    ever exist as arrows on a debug window (main.cu:114-174).
    """
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file into an (H, W, 2) float32 array."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size != 1 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path} is not a .flo file (magic {magic})")
        w, h = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.float32, int(w) * int(h) * 2)
    if data.size != w * h * 2:
        raise ValueError(f"{path}: truncated payload")
    return data.reshape(int(h), int(w), 2)


def write_flow_png(
    path: str, flow: np.ndarray, valid: np.ndarray | None = None
) -> None:
    """Write (H, W, 2) flow as a KITTI-format 16-bit RGB PNG.

    KITTI 2012/2015 ground-truth encoding: R = u*64 + 2^15, G = v*64 + 2^15
    (uint16, saturating), B = 1 where the truth is valid, 0 elsewhere.
    ``valid`` defaults to the finite pixels of ``flow``; invalid pixels are
    written as literal (0, 0, 0) — byte-identical to the KITTI devkit, which
    zeroes all three channels at unknown pixels.  The format represents
    |u|,|v| <= (2^15 - 1)/64 ~ 511.98 px; values beyond that saturate, and a
    RuntimeWarning is emitted (KITTI's own range limit — use .flo for larger
    flows).  The reference has no flow IO at all.
    """
    flow = np.asarray(flow, np.float64)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"expected (H, W, 2) flow, got {flow.shape}")
    if valid is None:
        valid = np.isfinite(flow).all(axis=-1)
    valid = np.asarray(valid, bool)
    if valid.shape != flow.shape[:2]:
        raise ValueError(
            f"valid mask shape {valid.shape} != flow plane {flow.shape[:2]}"
        )
    h, w = flow.shape[:2]
    img = np.zeros((h, w, 3), np.uint16)
    fv = np.where(valid[..., None], flow, 0.0)
    limit = (65535.0 - 32768.0) / 64.0  # ~511.98 px
    if np.abs(fv).max(initial=0.0) > limit:
        import warnings

        warnings.warn(
            f"flow exceeds the KITTI PNG range (max |component| "
            f"{np.abs(fv).max():.1f} px > {limit:.2f}); values saturate — "
            f"use write_flo for an exact artifact",
            RuntimeWarning,
            stacklevel=2,
        )
    quant = np.clip(np.round(fv * 64.0 + 32768.0), 0, 65535).astype(np.uint16)
    quant *= valid[..., None].astype(np.uint16)  # devkit zeroes unknowns
    img[..., 0] = quant[..., 0]
    img[..., 1] = quant[..., 1]
    img[..., 2] = valid.astype(np.uint16)
    be = img.astype(">u2").view(np.uint8).reshape(h, w * 6)
    raw = b"".join(b"\x00" + be[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_flow_png(path: str) -> np.ndarray:
    """Read a KITTI-format 16-bit flow PNG into (H, W, 2) float32.

    Inverse of :func:`write_flow_png`: u = (R - 2^15)/64, v = (G - 2^15)/64;
    pixels with B == 0 (unknown truth) are returned as NaN so the metrics
    layer (`metrics._valid_truth_mask`) excludes them from scoring.
    """
    img = _read_png(path)
    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint16:
        raise ValueError(
            f"{path} is not a 16-bit RGB flow PNG (got "
            f"{img.dtype} shape {img.shape})"
        )
    flow = (img[..., :2].astype(np.float32) - 32768.0) / 64.0
    invalid = img[..., 2] == 0
    flow[invalid] = np.nan
    return flow


def read_flow(path: str) -> np.ndarray:
    """Read flow ground truth by extension: .flo (Middlebury) or .png (KITTI)."""
    lower = path.lower()
    if lower.endswith(".flo"):
        return read_flo(path)
    if lower.endswith(".png"):
        return read_flow_png(path)
    raise ValueError(f"unsupported flow format: {path}")
