"""Command-line tools of the port: ``benchmark``, ``evaluate``, ``diff`` and
``demo`` (console scripts ``of2-torch-benchmark``, ``of2-torch-eval``,
``of2-torch-diff``, ``of2-torch-demo``).

Counterpart of ``cuda_optical_flow_2_tpu.cli``.  Every tool takes
``--device`` (default ``cuda``): the tools create their own tensors, and
they run where the flag says or not at all.
"""

from __future__ import annotations

import argparse

import torch

__all__ = ["add_device_argument", "device_from_flag"]


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    """The ``--device`` flag every tool takes."""
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the kernels' "
        "plain PyTorch versions)",
    )


def device_from_flag(name: str) -> torch.device:
    """``--device`` -> ``torch.device``.

    A CUDA device that this machine does not have ends the tool with a
    message (``SystemExit``): it never carries on on the CPU.
    """
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}") from None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"--device {name}: no CUDA device here (torch.cuda.is_available() is "
                "False); pass --device cpu to run the plain PyTorch versions on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise SystemExit(
                f"--device {name}: only {torch.cuda.device_count()} CUDA device(s) here"
            )
    return dev
