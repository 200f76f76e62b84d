"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes.  The library name carries a hash of the source and the flags,
so a stale build is never loaded.  Builds happen at first use, into
`build/hipstr_tpu_torch/` at the repository root (listed in .gitignore).
A missing nvcc or a failed build raises; nothing falls back.

`LAUNCHES` counts kernel launches by name.  Only the wrappers that launch
a kernel add to it, right after the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
             / "hipstr_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# one thread per read lane: kMaxLanes, the __launch_bounds__ of csrc/*.cu
MAX_LANES = 512

LAUNCHES: Dict[str, int] = {"emission": 0, "segment": 0}
# name -> {"seconds": build time, "ptxas": compiler resource report}
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

# argument signatures of the extern "C" launchers (pointers and the stream
# as c_void_p so 64-bit addresses are never truncated)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "emission": [_P] * 7 + [_I] * 5 + [_P],
    "segment": [_P] * 16 + [_I] * 8 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        cand = home / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels of hipstr_tpu_torch")
    return nvcc


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{key}.so"
    if not so.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0,
                                ptxas=proc.stderr)
    else:
        BUILD_INFO.setdefault(name, dict(seconds=0.0, ptxas="(cached)"))
    lib = ctypes.CDLL(str(so))
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"{name}_{dt}")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def launcher(name: str, dtype: torch.dtype):
    return getattr(library(name),
                   f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero cudaGetLastError() from a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device) -> None:
    """Validate one kernel argument: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
