"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes.  The library name carries a hash of the source, of every
shared header `csrc/*.cuh` and of the flags, so a stale build is never
loaded.  Builds happen at first use, into
`build/hipstr_tpu_torch/` at the repository root (listed in .gitignore).
A missing nvcc or a failed build raises; nothing falls back.

`LAUNCHES` counts kernel launches by name, and `SHAPES` holds beside it
the histogram of each kernel's launch shapes: (G, O, P, L, Bmax) for
emission (K1), (G, H, P, L, R, O) for segment (K2), (P, H, L, n_rows) for
flank_scan (K4), (P, H, L, R, O) for segment_scan (K3) and (G, R, Sm, C)
for sample_sum (the fused posteriors' ordered per-sample sum).  Only the
wrappers that launch a kernel add to them, right after the launch.
`launch` runs a kernel on the card its tensors lie on, which need not be
the runtime's current device: one process may dispatch to several cards
(parallel/executor.py).  `DeviceError` marks a failure of device work (a
build, a launch, a transfer) that must end a run rather than fail one
locus.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
             / "hipstr_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The read lanes L each kernel takes.  K1 (csrc/emission.cu) runs one or two
# threads per lane in one block: any whole number of warps up to MAX_LANES
# (its kMaxLanes).  K2, K3 and K4 (csrc/segment.cu, segment_scan.cu,
# flank_scan.cu) run one warp per chain with V = L/32 lanes a thread and have
# an instance for each L bucket of prepare_locus only: WARP_LANES, which
# their launch geometries (ops/hmm2.segment_geometry,
# ops/hmm_scan.scan_geometry) hold every launch to.
MAX_LANES = 512
WARP_LANES = (64, 128, 192, 256, 384, 512)

LAUNCHES: Dict[str, int] = {"emission": 0, "segment": 0, "flank_scan": 0,
                            "segment_scan": 0, "sample_sum": 0}
SHAPES: Dict[str, Counter] = {k: Counter() for k in LAUNCHES}
# name -> {"seconds": build time, "ptxas": compiler resource report}
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

# argument signatures of the extern "C" launchers (pointers and the stream
# as c_void_p so 64-bit addresses are never truncated)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "emission": [_P] * 7 + [_I] * 5 + [_P],
    "segment": [_P] * 16 + [_I] * 10 + [_P],
    "flank_scan": [_P] * 18 + [_I] * 8 + [_P],
    "segment_scan": [_P] * 16 + [_I] * 9 + [_P],
    "sample_sum": [_P] * 5 + [_I] * 4 + [_P],
}


class DeviceError(RuntimeError):
    """Device work failed: a kernel build or launch, a transfer, or the
    device computation of one locus.  Runs end on it; it is never counted
    as a failed locus."""


def reset_launches() -> None:
    """Set every launch count to 0 and empty every shape histogram."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()


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


def library_path(name: str) -> Path:
    """Where library `name` is built: keyed by its source, every shared
    header and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    so = library_path(name)
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


def build_all() -> None:
    """Build every kernel library at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(LAUNCHES)) as pool:
        list(pool.map(library, LAUNCHES))


def launcher(name: str, dtype: torch.dtype):
    return getattr(library(name),
                   f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


def check_launch(name: str, rc: int, shape: tuple) -> None:
    """Raise on a non-zero cudaGetLastError() from a launcher; count the
    launch and its shape."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    SHAPES[name][shape] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """The current stream of `device`, the card the kernel's tensors lie
    on (not that of the runtime's current device)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name: str, dtype: torch.dtype, device: torch.device, shape: tuple,
           *args) -> None:
    """Launch kernel `name` on `device`, the card its tensors lie on: on
    that card's current stream, with the card made the runtime's current
    device for the call (the launch and the kernels' cudaFuncSetAttribute
    act on the current device).  Raises on a failed launch; counts it."""
    fn = launcher(name, dtype)
    with torch.cuda.device(device):
        rc = fn(*args, stream(device))
    check_launch(name, rc, shape)


def check_lanes(name: str, dtype: torch.dtype, L: int) -> None:
    """Raise unless K1 takes `dtype` and L lanes: whole warps, at most
    MAX_LANES.  (The warp-per-chain kernels take WARP_LANES only, and their
    geometries check it.)"""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: dtype {dtype}")
    if L % 32 or L > MAX_LANES:
        raise ValueError(f"{name}: L={L} must be a multiple of 32 and at "
                         f"most {MAX_LANES}")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device,
                      contiguous: bool = True) -> None:
    """Validate one kernel argument: device, dtype, shape and, unless the
    kernel takes its strides, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless `t` starts on a 16-byte boundary: the warp kernels move
    a thread's lanes in 8- and 16-byte pieces, and a misaligned vector
    access is a fault that ends the CUDA context."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
