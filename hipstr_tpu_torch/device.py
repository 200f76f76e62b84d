"""Device and dtype resolution for the port.

`cuda` is the default device.  Asking for `cuda` where no card is visible
raises: the port never carries on silently on the CPU.  float64 is allowed
on the card (the JAX package had to force the CPU for it).  `local_devices`
lists the cards a batched dispatch is sharded over.  Each function
imports torch when it runs: the CLI imports this module, and the pool's
host workers, which import the CLI again where it is the main module,
never load torch.
"""

from __future__ import annotations

from typing import List

DTYPES = ("float32", "float64")     # torch's dtypes of these names


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device for `cuda` or `cpu`; raises if `cuda` is unavailable."""
    import torch
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


def local_devices(device) -> List[torch.device]:
    """The devices a batched dispatch is sharded over, as
    `jax.local_devices()` is to the JAX executor: for `cuda` every visible
    card, cuda:0 .. cuda:n-1 (a `--workers` child sees one card through
    CUDA_VISIBLE_DEVICES); for a card named by index (a `--distributed`
    rank's, parallel/distributed.place) that card alone; for `cpu` [cpu].
    `cuda` without a visible card raises."""
    import torch
    device = torch.device(device)
    if device.type == "cpu":
        return [device]
    if device.type != "cuda":
        raise ValueError(f"unknown device {device} (expected cuda or cpu)")
    if device.index is not None:
        return [device]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_dtype(name: str = "float32") -> torch.dtype:
    import torch
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r} (expected one of "
                         f"{sorted(DTYPES)})")
    return getattr(torch, name)


def resolve(device: str = "cuda", dtype: str = "float32"):
    """(torch.device, torch.dtype) for the CLI's --device / --dtype."""
    return resolve_device(device), resolve_dtype(dtype)
