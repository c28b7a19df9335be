"""ctypes bindings for the native frame-ingestion runtime (native/framesrc.cpp).

Counterpart of ``cuda_optical_flow_2_tpu.utils.native``, with one change:
the library is never loaded from ``native/``.  At first use this module
compiles ``native/framesrc.cpp`` with the flags of ``native/Makefile``
(``g++ -O3 -fPIC -std=c++17 -Wall -Wextra ... -shared -pthread``) into
``cuda_optical_flow_2_torch/_build/native-<hash>/``, keyed by a hash of the
source and the flags, and writes nothing into ``native/``.

The compute path is PyTorch on the device; the host-side frame pipeline
(grayscale conversion, synthetic generation, PPM / Y4M decode, V4L2
capture) is C++ for throughput, loaded here via ctypes with NumPy
fallbacks, so the tools work whether or not the library builds (no C++
compiler, or no source beside the package).  ``available()`` reports which
path runs; every wrapper returns identical results either way (the native
grayscale ops are bit-exact twins of the oracle).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "build",
    "library_path",
    "gray_f32",
    "gray_u8",
    "synthetic_frame",
    "v4l2_probe",
    "FrameStream",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "framesrc.cpp"
_BUILD_DIR = _PKG / "_build"
# native/Makefile: CXXFLAGS, then LDFLAGS
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-pthread"]
_LIB_NAME = "libof2native.so"

_lib: ctypes.CDLL | None = None
_load_attempted = False


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return _BUILD_DIR / f"native-{digest.hexdigest()[:16]}" / _LIB_NAME


def _compile(quiet: bool = True) -> Path | None:
    """The built library, compiling it first unless this exact source and
    flags were built before; None without a source or a C++ compiler, or
    when the compile fails (its output is in ``build.log`` beside it)."""
    if not SOURCE.exists():
        return None
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{_LIB_NAME}.{os.getpid()}")
    cmd = [cxx, *CXXFLAGS, str(SOURCE), *LDFLAGS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (path.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if not quiet:
        print(proc.stdout + proc.stderr, end="")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return path


def _try_load() -> ctypes.CDLL | None:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    so_path = _compile()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.of2_gray_f32.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p]
        lib.of2_gray_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.of2_u8_to_f32.argtypes = [u8p, ctypes.c_int64, f32p]
        lib.of2_synthetic_frame.argtypes = [
            ctypes.c_int64,  # 64-bit frame index: unbounded streams never wrap
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int,
            u8p,
        ]
        lib.of2_stream_open_synthetic.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.of2_stream_open_synthetic.restype = ctypes.c_void_p
        lib.of2_stream_open_ppm.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.of2_stream_open_ppm.restype = ctypes.c_void_p
        lib.of2_stream_open_y4m.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.of2_stream_open_y4m.restype = ctypes.c_void_p
        lib.of2_y4m_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.of2_y4m_probe.restype = ctypes.c_int
        lib.of2_v4l2_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.of2_v4l2_probe.restype = ctypes.c_int
        lib.of2_stream_open_v4l2.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.of2_stream_open_v4l2.restype = ctypes.c_void_p
        lib.of2_stream_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.of2_stream_next.argtypes = [ctypes.c_void_p, f32p]
        lib.of2_stream_next.restype = ctypes.c_int
        lib.of2_stream_next2.argtypes = [
            ctypes.c_void_p,
            f32p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.of2_stream_next2.restype = ctypes.c_int64
        lib.of2_stream_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.of2_stream_stats.restype = None
        lib.of2_stream_stop.argtypes = [ctypes.c_void_p]
        lib.of2_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError: a stale .so built before a symbol was added —
        # fall back to Python rather than crash (ctypes raises it, not OSError).
        _lib = None
    return _lib


def build(quiet: bool = True) -> bool:
    """Build (or find) the native library and load it; returns success."""
    global _load_attempted
    if _compile(quiet) is None:
        return False
    _load_attempted = False
    return _try_load() is not None


def available() -> bool:
    """True when the native library runs, False on the NumPy path."""
    return _try_load() is not None


def v4l2_probe(
    device: str = "/dev/video0", w: int = 640, h: int = 480
) -> tuple[int, int, int]:
    """Probe a V4L2 camera device without starting capture.

    The native probe stops after format negotiation (no buffer request or
    STREAMON is issued), so a camera held by another consumer is never
    disturbed.  Returns ``(rc, h, w)``: rc 0 with the size the device granted
    on success; -1 cannot open; -2 not a V4L2 streaming-capture device;
    -3 no YUYV/GREY format.  rc -1 also when the native library is
    unavailable (non-Linux builds always report -1).
    """
    lib = _try_load()
    if lib is None:
        return -1, 0, 0
    hh = ctypes.c_int(h)
    ww = ctypes.c_int(w)
    rc = lib.of2_v4l2_probe(device.encode(), ctypes.byref(hh), ctypes.byref(ww))
    return int(rc), hh.value, ww.value


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gray_f32(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) float32 channel mean (production ingestion)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    lib = _try_load()
    if lib is None:
        s = rgb.astype(np.float32)
        return (s[..., 0] + s[..., 1] + s[..., 2]) * np.float32(1.0 / 3.0)
    out = np.empty((h, w), np.float32)
    lib.of2_gray_f32(_u8p(rgb), h, w, _f32p(out))
    return out


def gray_u8(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8, exact integer (r+g+b)/3 (oracle twin)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    lib = _try_load()
    if lib is None:
        s = rgb.astype(np.int32)
        return ((s[..., 0] + s[..., 1] + s[..., 2]) // 3).astype(np.uint8)
    out = np.empty((h, w), np.uint8)
    lib.of2_gray_u8(_u8p(rgb), h, w, _u8p(out))
    return out


def synthetic_frame(
    t: int, h: int, w: int, vx: float, vy: float, period: int = 16
) -> np.ndarray:
    """Noise-free synthetic translating-texture frame (utils.io twin)."""
    lib = _try_load()
    if lib is None:
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        sx, sy = xs - vx * t, ys - vy * t
        img = (
            127.0
            + 55.0 * np.sin(2 * np.pi * sx / period) * np.sin(2 * np.pi * sy / period)
            + 35.0 * np.sin(2 * np.pi * (sx + sy) / (period * 2.7))
        )
        return np.clip(img, 0, 255).astype(np.uint8)
    out = np.empty((h, w), np.uint8)
    lib.of2_synthetic_frame(t, h, w, float(vx), float(vy), period, _u8p(out))
    return out


class FrameStream:
    """Prefetching planar-float32 frame stream (native worker + ring buffer).

    The data-loader of the streaming pipeline: where the reference's main
    loop serializes capture with compute (main.cu:222-275), here a C++
    worker thread decodes/generates/grayscales frames ahead of the consumer
    so host-side frame prep overlaps device compute.  Iterates (index, frame)
    pairs; frames are (H, W) float32.  Falls back to synchronous Python
    generation/decoding when the native library isn't built — identical
    frames either way.

        with FrameStream.synthetic(100, 1080, 1920, vx=2, vy=1) as src:
            for t, frame in src: ...

    Decode failures are per-frame, not fatal: the failed frame is yielded as
    ``(t, None)`` and the stream continues (the downstream consumer —
    models/streaming.process_stream — skips it and re-seeds its warm state).
    ``nframes=None`` opens an UNBOUNDED stream (the twin of the reference's
    live-capture while(true) loop, main.cu:222-275) with memory bounded by
    the prefetch ring; end it with ``close()`` / the context manager.
    """

    def __init__(self, handle, h, w, nframes, fallback=None):
        import threading

        self._handle = handle
        self.h, self.w, self.nframes = h, w, nframes
        self._fallback = fallback  # callable t -> np.ndarray, when no native
        self._t = 0
        self.decoded = 0  # frames yielded OK
        self.failed = 0   # frames yielded as (t, None) on decode failure
        # Serializes the native next2 call against close(): close() first
        # STOPS the stream (wakes a consumer blocked inside next2 — ctypes
        # releases the GIL, so that consumer holds this lock while blocked),
        # then takes the lock to retire the handle before freeing it.
        self._lock = threading.Lock()
        # Serializes CLOSERS against each other (and stats() against a
        # mid-close free).  A consumer never takes it, so a closer can hold
        # it across the stop-then-free sequence without deadlocking against
        # a consumer blocked inside next2 holding _lock.
        self._close_lock = threading.Lock()

    @classmethod
    def synthetic(
        cls, nframes: int | None, h: int, w: int, vx: float, vy: float,
        period: int = 16, prefetch: int = 4,
    ) -> "FrameStream":
        lib = _try_load()
        if lib is None:
            return cls(
                None, h, w, nframes,
                fallback=lambda t: synthetic_frame(t, h, w, vx, vy, period)
                .astype(np.float32),
            )
        handle = lib.of2_stream_open_synthetic(
            h, w, float(vx), float(vy), period,
            -1 if nframes is None else nframes, prefetch,
        )
        if not handle:
            raise ValueError(
                f"cannot open synthetic stream: bad dimensions {h}x{w} "
                "or ring allocation failed"
            )
        return cls(handle, h, w, nframes)

    @classmethod
    def from_ppm(cls, paths: list[str], prefetch: int = 4) -> "FrameStream":
        from cuda_optical_flow_2_torch.utils import io as _io

        lib = _try_load()
        if lib is None:
            first = _io.read_image(paths[0])
            h, w = first.shape[:2]

            def fb(t, _paths=list(paths)):
                img = _io.read_image(_paths[t])
                if img.ndim == 3:
                    return gray_f32(img)
                return img.astype(np.float32)

            return cls(None, h, w, len(paths), fallback=fb)
        joined = "\n".join(paths).encode()
        handle = lib.of2_stream_open_ppm(joined, prefetch)
        if not handle:
            raise ValueError(f"cannot open PPM stream starting at {paths[0]}")
        h = ctypes.c_int()
        w = ctypes.c_int()
        n = ctypes.c_int()
        lib.of2_stream_info(
            handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(n)
        )
        return cls(handle, h.value, w.value, n.value)

    @classmethod
    def from_y4m(cls, path: str, prefetch: int = 4) -> "FrameStream":
        """Stream the luma plane of a Y4M (YUV4MPEG2) video file.

        Y4M is the uncompressed video interchange format
        (``ffmpeg -i clip.mp4 out.y4m``) — the real-video twin of the
        reference's webcam capture.  Frame count is unknown until EOF
        (``nframes`` is None); the stream ends itself at end of file.

        FIFO/pipe caveat: frames are consumed with blocking reads, so
        ``close()`` on a mid-frame STALLED pipe (producer paused, no EOF)
        waits for the producer to resume or close its end — the worker
        cannot be interrupted inside a blocking ``fread``.  Regular files
        and drained/closed pipes close immediately.
        """
        lib = _try_load()
        if lib is None:
            from cuda_optical_flow_2_torch.utils import io as _io

            it = _io.read_y4m(path, resync=True)
            # Leading corrupt frames (None under resync) are per-frame
            # failures like anywhere else; the first REAL frame pins (h, w).
            frames = []
            first = None
            for frame in it:
                frames.append(frame)
                if frame is not None:
                    first = frame
                    break
            if first is None:
                raise ValueError(f"empty Y4M stream: {path}")
            h, w = first.shape

            def fb(t, _it=it, _frames=frames):
                # strictly sequential access (t == frames consumed so far)
                if t < len(_frames):
                    frame = _frames[t]
                else:
                    frame = next(_it)  # StopIteration ends us
                if frame is None:
                    raise ValueError("Y4M decode failure")
                return frame.astype(np.float32)

            return cls(None, h, w, None, fallback=fb)
        handle = lib.of2_stream_open_y4m(path.encode(), prefetch)
        if not handle:
            h = ctypes.c_int()
            w = ctypes.c_int()
            rc = lib.of2_y4m_probe(path.encode(), ctypes.byref(h), ctypes.byref(w))
            reason = {
                # rc 0: header parses fine, so the open failed at the ring —
                # dimensions beyond the 134 MP stream cap or allocation.
                0: "frame dimensions too large or ring allocation failed",
                -1: "cannot open",
                -2: "malformed header",
                -3: "not a YUV4MPEG2 stream",
                -4: "unsupported colorspace",
            }.get(rc, f"error {rc}")
            raise ValueError(f"cannot open Y4M stream {path}: {reason}")
        h = ctypes.c_int()
        w = ctypes.c_int()
        n = ctypes.c_int()
        lib.of2_stream_info(handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(n))
        return cls(handle, h.value, w.value, None)

    @classmethod
    def from_v4l2(
        cls, device: str = "/dev/video0", w: int = 640, h: int = 480,
        prefetch: int = 4,
    ) -> "FrameStream":
        """Stream luma frames from a live V4L2 camera device (Linux).

        The direct twin of the reference's ``cv::VideoCapture(0)`` webcam
        source (main.cu:181-184): unbounded capture (``nframes`` is None,
        close() ends it), YUYV or GREY negotiated with the device, which
        may adjust the requested ``w``/``h`` — the stream's ``.h``/``.w``
        report the actual size.  Capture glitches are per-frame failures
        the stream recovers from (same contract as the Y4M path).  There is
        no pure-Python fallback (camera IO is native-only); raises when the
        native library or the device is unavailable, with the probe's
        distinct failure reason.
        """
        lib = _try_load()
        if lib is None:
            raise RuntimeError(
                "V4L2 capture needs the native library (utils.native.build())"
            )
        handle = lib.of2_stream_open_v4l2(device.encode(), w, h, prefetch)
        if not handle:
            rc = v4l2_probe(device, w, h)[0]
            # The probe stops after format negotiation (probe_only), so a
            # clean probe (rc 0) after a failed open means the LATER setup
            # stages — MMAP buffer request, stream start, or the prefetch
            # ring allocation — failed; the probe cannot distinguish them.
            reason = {
                0: "buffer setup / stream start / ring allocation failed "
                   "(device negotiates but cannot start MMAP streaming)",
                -1: "cannot open device",
                -2: "not a V4L2 streaming-capture device",
                -3: "no supported pixel format (YUYV/GREY)",
            }.get(rc, f"error {rc}")
            raise ValueError(f"cannot open camera {device}: {reason}")
        hh = ctypes.c_int()
        ww = ctypes.c_int()
        n = ctypes.c_int()
        lib.of2_stream_info(handle, ctypes.byref(hh), ctypes.byref(ww), ctypes.byref(n))
        return cls(handle, hh.value, ww.value, None)

    def __iter__(self):
        return self

    def __next__(self):
        if self.nframes is not None and self._t >= self.nframes:
            raise StopIteration
        if self._handle is None and self._fallback is None:
            raise StopIteration  # closed
        if self._handle is None:
            t = self._t
            self._t += 1
            try:
                frame = self._fallback(t)
            except (IOError, OSError, ValueError):
                self.failed += 1
                return t, None
            self.decoded += 1
            return t, frame
        out = np.empty((self.h, self.w), np.float32)
        ok = ctypes.c_int()
        with self._lock:
            if self._handle is None:
                raise StopIteration  # closed between the check above and here
            t = _try_load().of2_stream_next2(
                self._handle, _f32p(out), ctypes.byref(ok)
            )
        if t < 0:
            raise StopIteration
        self._t += 1
        if not ok.value:
            self.failed += 1
            return t, None
        self.decoded += 1
        return t, out

    def stats(self) -> tuple[int, int]:
        """Lifetime (decoded_ok, failed) counters from the PRODUCER side.

        Sourced from the native worker's ledger (``of2_stream_stats``) when
        the library is active, so they may lead the consumer-side
        ``decoded``/``failed`` attributes by up to ``prefetch`` in-flight
        frames; after a finite stream is fully drained the two agree.  Falls
        back to the consumer counters when no native stream exists.
        """
        lib = _try_load()
        if lib is not None:
            # _close_lock (not _lock): a consumer blocked inside next2 holds
            # _lock for the whole blocking wait, but the native stats call
            # only needs the handle to stay unfreed — which closers guarantee
            # by holding _close_lock across stop+free.
            with self._close_lock:
                if self._handle is not None:
                    n_ok = ctypes.c_longlong()
                    n_failed = ctypes.c_longlong()
                    lib.of2_stream_stats(
                        self._handle, ctypes.byref(n_ok), ctypes.byref(n_failed)
                    )
                    return n_ok.value, n_failed.value
        return self.decoded, self.failed

    def close(self) -> None:
        """End the stream.  Safe to call from another thread while a consumer
        is blocked in ``next()`` — the consumer wakes and raises
        StopIteration."""
        # _close_lock serializes concurrent closers: the loser waits here,
        # then sees _handle is None and skips — without it, two closers
        # could both read the handle and the second would stop/free a
        # pointer the first already freed.
        with self._close_lock:
            if self._handle is not None:
                lib = _try_load()
                # Phase 1: stop (wakes any consumer blocked inside next2;
                # the handle stays valid).  Phase 2: retire the handle under
                # the iteration lock so no thread can call into it again,
                # then free.
                lib.of2_stream_stop(self._handle)
                with self._lock:
                    handle, self._handle = self._handle, None
                lib.of2_stream_close(handle)
        self._fallback = None
        self.nframes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
