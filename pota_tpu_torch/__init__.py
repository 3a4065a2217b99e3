"""pota_tpu_torch — the PyTorch / CUDA port of pota_tpu for NVIDIA Hopper.

The package mirrors :mod:`pota_tpu` module for module, so each function has
its counterpart under the same name.  Plain tensor code is PyTorch; the hot
per-ray and per-slot programs are CUDA kernels written by hand for
``sm_90a`` (``csrc/``), built with nvcc at first use and bound with ctypes
(``ops/_build.py``).  Every kernel wrapper keeps a plain PyTorch version of
the same function beside it: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel.

The package imports nothing of :mod:`pota_tpu` and never imports JAX: the
configuration classes are its own copy (:mod:`pota_tpu_torch.config`).
Constructors of scenes, lenses, bokeh tables and camera matrices build on
:func:`default_device`, the card, unless the caller passes ``device``
(``device="cpu"`` for a CPU run).
"""
import torch

from .config import (
    CameraConfig,
    CameraType,
    ChromaticType,
    RenderConfig,
    UnitModel,
    config_from_fields,
)

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device a constructor builds on when given none: ``cuda:0``.
    Raises ``RuntimeError`` without a CUDA device; there is no silent CPU
    fallback (pass ``device="cpu"`` to run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pota_tpu_torch: no CUDA device (torch.cuda.is_available() is "
            "false); pass device='cpu' to build on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, or :func:`default_device` when
    it is None."""
    return default_device() if device is None else torch.device(device)


__all__ = [
    "CameraConfig",
    "RenderConfig",
    "CameraType",
    "UnitModel",
    "ChromaticType",
    "config_from_fields",
    "default_device",
    "resolve_device",
]
