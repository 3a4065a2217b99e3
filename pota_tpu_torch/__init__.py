"""pota_tpu_torch — the PyTorch / CUDA port of pota_tpu for NVIDIA Hopper.

The package mirrors :mod:`pota_tpu` module for module, so each function has
its counterpart under the same name.  Plain tensor code is PyTorch; the hot
per-ray and per-slot programs are CUDA kernels written by hand for
``sm_90a`` (``csrc/``), built with nvcc at first use and bound with ctypes
(``ops/_build.py``).  Every kernel wrapper keeps a plain PyTorch version of
the same function beside it: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel.

The configuration classes are shared with :mod:`pota_tpu` (its
``config`` module imports no framework).  This package never imports JAX.
"""

from pota_tpu.config import (
    CameraConfig,
    CameraType,
    ChromaticType,
    RenderConfig,
    UnitModel,
)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig",
    "RenderConfig",
    "CameraType",
    "UnitModel",
    "ChromaticType",
]
