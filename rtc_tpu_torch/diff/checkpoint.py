"""Parameter checkpoints for optimisation loops (counterpart of
rtc_tpu/diff/checkpoint.py).

rtc_tpu writes orbax checkpoints where orbax is installed and a NumPy .npz
otherwise. The port writes the .npz layout alone: one array per parameter
under its name, and the step under "__step__" when one is given, so a
port-written file is read by rtc_tpu.diff.checkpoint.restore and an
rtc_tpu .npz by restore here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..scene.compile import params_from_numpy


def save(path: str, params: Dict[str, torch.Tensor], step: Optional[int] = None) -> str:
    """Write a parameter dict to path (".npz" appended where missing).
    Returns the path written."""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = {k: v.detach().cpu().numpy() for k, v in params.items()}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)
    return path


def restore(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """Read a parameter dict written by save (or by rtc_tpu's .npz
    fallback) as leaf tensors on device (params_from_numpy)."""
    path = os.path.abspath(path)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files if k != "__step__"},
                                 device)
