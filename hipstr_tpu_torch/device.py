"""Device and dtype resolution for the port.

`cuda` is the default device.  Asking for `cuda` where no card is visible
raises: the port never carries on silently on the CPU.  float64 is allowed
on the card (the JAX package had to force the CPU for it).
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device for `cuda` or `cpu`; raises if `cuda` is unavailable."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r} (expected cuda or cpu)")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        # float32 products and convolutions stay full float32: the golden
        # drift bands assume it, and TF32 keeps ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def resolve_dtype(name: str = "float32") -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r} (expected one of "
                         f"{sorted(DTYPES)})")
    return DTYPES[name]


def resolve(device: str = "cuda", dtype: str = "float32"):
    """(torch.device, torch.dtype) for the CLI's --device / --dtype."""
    return resolve_device(device), resolve_dtype(dtype)
