"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources are ``cuda_optical_flow_2_torch/csrc/*.cu`` and ``*.cuh``.  At the
first CUDA launch they are compiled for Hopper (``sm_90a``), one nvcc process
per ``.cu`` file, all started together, and linked into one shared library
with a plain C interface, under ``cuda_optical_flow_2_torch/_build/`` in a
directory named by a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses the library.  Importing this module needs neither
nvcc nor a GPU.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, and returns ``cudaGetLastError()`` after its
launch; :func:`launch` passes the stream and raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "library", "launch", "require_cuda", "build_seconds", "build_commands", "SOURCES_DIR",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCES_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libof2kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# name -> argtypes; every launch returns a cudaError_t as int, every
# ``*_compiled`` query 1 when a radius runs a kernel compiled for it, else 0.
_SIGNATURES = {
    "of2_lk_residual": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _F, _I, _P],
    "of2_lk_level_step": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _F, _F, _I, _I, _P,
    ],
    "of2_warp_select": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "of2_pyr_down": [_P, _P, _I, _I, _I, _L, _L, _L, _P],
    "of2_bilateral": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _F, _P],
    "of2_bilateral_compiled": [_I],
    "of2_hs_relax": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _I, _F, _F, _F, _F, _P,
    ],
    "of2_poly_exp": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "of2_poly_exp_compiled": [_I],
    "of2_window_solve": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "of2_fb_step": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _F, _F, _I,
        _P,
    ],
    "of2_median": [_P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P],
    "of2_tvl1_relax": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F, _F, _F, _F, _P,
    ],
}

_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(list(SOURCES_DIR.glob("*.cu")) + list(SOURCES_DIR.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the kernels")


def build_commands(nvcc: str, out_dir: Path, tmp: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per ``.cu`` source, the link command into ``tmp``)."""
    compiles, objects = [], []
    for src in sorted(SOURCES_DIR.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
        objects.append(str(obj))
    return compiles, [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objects]


def _build() -> Path:
    """Compile the sources unless a library for this exact tree exists."""
    global _build_seconds
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        _build_seconds = 0.0
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    compiles, link = build_commands(_nvcc(), out_dir, tmp)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in compiles
    ]
    results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
    if all(rc == 0 for *_, rc in results):
        proc = subprocess.run(link, capture_output=True, text=True)
        results.append((link, proc.stdout + proc.stderr, proc.returncode))
    _build_seconds = time.perf_counter() - t0
    # ptxas -v: registers, shared memory and spills per kernel
    (out_dir / "build.log").write_text(
        "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
    )
    for cmd in compiles:
        Path(cmd[-1]).unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_seconds() -> float | None:
    """Seconds the last build in this process took (0.0: cached library)."""
    return _build_seconds


def launch(device: torch.device, name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` plus the current stream of
    ``device``, with that device current; raise if the launch failed."""
    with torch.cuda.device(device):
        status = getattr(library(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """Raise unless all tensors lie on one CUDA device; return it.

    Raise too when autograd records and a tensor requires grad: a kernel's
    output is written through a raw pointer and carries no gradient, so a
    launch would hand back a detached result."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA kernels carry no gradient, as the JAX package's Pallas kernels carry "
            "none: differentiate the plain path (use_pallas=False), or run the kernels "
            "under torch.no_grad()"
        )
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    return dev
