"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (its modules under the same names, with the kernels' plain
versions in place of the kernels).

It imports nothing of the program.  Every kernel set it runs is plain
PyTorch (:data:`reference.ops.KERNELS`), on whatever device its tensors
lie; :mod:`reference.ops._build` builds nothing and refuses a launch.  The
benchmark hands it the same inputs it hands the program (the fit's file,
the scene, the camera, the seeds and the perturbation of the coefficients)
and it works out again everything the program derives from them.
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


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("reference: no CUDA device; pass device='cpu'")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)
