#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hipstr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. environment: torch/CUDA/nvcc versions, triton, the card's name and
     power limit, whether the native host library loaded;
  2. build: the four CUDA kernels (K1 emission, K2 segment, K4 flank scan,
     K3 fused segment) from hipstr_tpu_torch/csrc, one nvcc each, all at
     once;
  3. each kernel against its plain PyTorch version on the card, float32
     and float64, at the main-path shape and a deep shape, with times, and
     K1 and K2 at L = 384 and 512;
  4. the batched slice: `hipstr_tpu_torch.cli` in-process on 60 simulated
     30x trio loci (float32, --batch-loci 32); 60/60 genotyped, K1 and K2
     launched at least twice per dispatch, K3 and K4 never, JAX never
     imported;
  5. the sequential slice: the same run with --batch-loci 0; 60/60
     genotyped, per aligner call two K1 and four K4 launches, no K2 or K3;
  6. the two per-locus modes on the 60 real loci: the first-round
     alignment of each in float64, flank mode (K4) against fused mode
     (K3), LL within 1e-8;
  7. the sequential run without a stutter model (host EM) on 8 loci;
  8. float64 cross-check: the port's VCF on the dataset behind
     tests/data/torch_port_ref_f64.vcf, batched and sequential, against
     that file;
  9. real shapes: each kernel at the two launch shapes its path used most
     (K1 and K2 from phase 4's histogram, K4 from phase 5's, K3 from the
     fused mode over the slice's loci), on the arguments that path really
     passed (captured in a second run), float32 and float64: against its
     plain version, CUDA-event times over 20 launches with L2 warm and with
     L2 flushed (64 MiB written before each launch), and the bound the
     card allows for that work (`bound`).

After every phase no module of JAX or of the JAX package may be loaded.
Prints the kernel summary as one JSON line (per kernel its real-shape
time, bound and share of the bound), then as the last line {"ok": true,
"device": {...}}.  Needs one visible CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_VCF = os.path.join(ROOT, "tests", "data", "torch_port_ref_f64.vcf")
SLICE_LOCI = 60
SLICE_READS = 170
# (rtol, atol) of kernel vs plain version.  float64: the kernels replay the
# plain arithmetic in another order (serial sums and an online log-sum-exp
# where the plain version uses prefix sums and a two-pass max), so only
# rounding differs.  float32: the same reassociation over sums of up to
# Bmax (K1) or ~R rows x L lanes (K2) terms of magnitude up to ~1e3
# accumulates ~n * 2^-24 relative error, ~1e-4 at these depths.
# K4 and K3 follow the rows of the plain version in the same order (f64
# 1e-9 and 1e-8, the tolerances of tests/test_pallas_hmm.py), and share
# K2's float32 bound.
TOL = {("emission", "float64"): (1e-10, 1e-10),
       ("segment", "float64"): (1e-8, 1e-8),
       ("flank_scan", "float64"): (1e-9, 1e-9),
       ("segment_scan", "float64"): (1e-8, 1e-8),
       ("emission", "float32"): (1e-4, 1e-3),
       ("segment", "float32"): (1e-4, 1e-3),
       ("flank_scan", "float32"): (1e-4, 1e-3),
       ("segment_scan", "float32"): (1e-4, 1e-3)}
MAIN = dict(G=32, O=8, P=64, L=128, Bmax=64, H=8)
DEEP = dict(MAIN, P=256)
# K1/K2 past 8 lanes a thread: other kernel instances (K2 keeps float64
# lane constants in shared memory, K1 one thread per lane in float64)
WIDE = (dict(MAIN, G=8, P=16, L=384), dict(MAIN, G=8, P=16, L=512))
SCAN_DEEP_P = 1024   # K3/K4 deep shape: the largest pool bucket
MODES_TOL = 1e-8     # flank vs fused LL, float64 (rtol and atol)
EM_LOCI = 8
# kernel -> (source, the TPU kernel it replaces); each is checked in phase 3
# and timed at its path's real launch shapes, beside its bound, in phase 9
SOURCES = {
    "emission": ("hipstr_tpu_torch/csrc/emission.cu",
                 "hipstr_tpu/ops/pallas_emission.py:62"),
    "segment": ("hipstr_tpu_torch/csrc/segment.cu",
                "hipstr_tpu/ops/pallas_hmm2.py:69"),
    "flank_scan": ("hipstr_tpu_torch/csrc/flank_scan.cu",
                   "hipstr_tpu/ops/pallas_hmm.py:55"),
    "segment_scan": ("hipstr_tpu_torch/csrc/segment_scan.cu",
                     "hipstr_tpu/ops/pallas_hmm.py:130"),
}
SENTINEL = -1.0e20   # values at or below are NEG-derived padding
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# float32 and float64 outside the tensor cores, and device memory
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
REAL_REPS = 20                  # launches per real-shape timing
FLUSH_BYTES = 64 << 20          # written before each L2-flushed launch
TOP_SHAPES = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def log_shapes(label: str, shapes: dict) -> None:
    """The launch-shape histogram of each kernel, most frequent first."""
    for name, hist in shapes.items():
        log(f"{label}: {name} shapes " + ", ".join(
            f"{s}x{n}" for s, n in hist.most_common()))


def check_no_jax() -> None:
    """Fail if JAX or any module of the JAX package is loaded."""
    loaded = [m for m, mod in sys.modules.items() if mod is not None and (
        m == "jax" or m.startswith("jax.") or m == "hipstr_tpu"
        or m.startswith("hipstr_tpu."))]
    if loaded:
        raise AssertionError(f"loaded: {sorted(loaded)[:10]}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_env():
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from hipstr_tpu_torch import kernels
    nvcc = kernels.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1]
    log(f"nvcc {nvcc}: {ver}")
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as exc:
        log(f"triton does not import: {exc}")
    card = nvidia_smi_line()
    log(card)
    from hipstr_tpu_torch import native
    log(f"native host library loaded: {native._load() is not None}")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build():
    from hipstr_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"built {len(kernels.LAUNCHES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in kernels.LAUNCHES:
        info = kernels.BUILD_INFO[name]
        log(f"built {name}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, ref, dtype_name: str) -> float:
    """Check got against ref within TOL; returns the max abs error over the
    log-likelihood-scale entries (ref > -1e6)."""
    import torch
    rtol, atol = TOL[(name, dtype_name)]
    real = ref > SENTINEL
    if not torch.equal(real, got > SENTINEL):
        raise AssertionError(f"{name} {dtype_name}: NEG sentinels differ")
    if not bool(torch.isfinite(got[real]).all()):
        raise AssertionError(f"{name} {dtype_name}: non-finite values")
    err = (got - ref).abs()
    bad = real & (err > atol + rtol * ref.abs())
    if bool(bad.any()):
        raise AssertionError(
            f"{name} {dtype_name}: {int(bad.sum())} entries beyond "
            f"rtol={rtol} atol={atol}; max err {float(err[real].max())}")
    scale = ref > -1.0e6
    return float(err[scale].max()) if bool(scale.any()) else 0.0


def reads(rng, G, P, L, device, period):
    """Random reads: codes (1% N), raw quality bytes, last columns that keep
    the stutter row's 6*period lanes of headroom."""
    import numpy as np
    import torch
    codes = rng.integers(0, 4, (G, P, L)).astype(np.int8)
    codes[rng.random((G, P, L)) < 0.01] = 4
    quals = rng.integers(35, 75, (G, P, L)).astype(np.uint8)
    last = rng.integers(L // 4, L - 6 * period, (G, P)).astype(np.int32)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(quals).to(device),
            torch.from_numpy(last).to(device))


def to_device(x, device, dt):
    import numpy as np
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t.to(dt) if t.is_floating_point() else t


def check_emission(shape, dtype_name, device, rng):
    import numpy as np
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm import expand_quals
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    G, O, P, L, B = (shape[k] for k in ("G", "O", "P", "L", "Bmax"))
    dt = resolve_dtype(dtype_name)
    codes, quals, _ = reads(rng, G, P, L, device, 4)
    blw, blc = expand_quals(quals, dt)
    codes = codes.int()
    brev = torch.from_numpy(rng.integers(0, 4, (G, O, B)).astype(np.int32)
                            ).to(device)
    blen_np = rng.integers(1, B + 1, (G, O)).astype(np.int32)
    blen_np[:, -1] = 0                      # a padded option in every locus
    blen = torch.from_numpy(blen_np).to(device)
    periods = torch.from_numpy(rng.integers(1, 5, G).astype(np.int32)
                               ).to(device)
    args = (codes, blw, blc, brev, blen, periods)
    got = stutter_emissions(*args)
    ref = stutter_emissions_plain(*args)
    torch.cuda.synchronize()
    err = compare("emission", got, ref, dtype_name)
    ms = cuda_ms(lambda: stutter_emissions(*args), 5)
    plain_ms = cuda_ms(lambda: stutter_emissions_plain(*args), 2)
    return err, ms, plain_ms, bound_emission(args, {}, dtype_name)["bound_ms"]


def real_locus(tmp):
    """One real locus of the slice's dataset, packed through the main
    path's host code and prepare_locus: (arrays, statics)."""
    from hipstr_tpu_torch.io.regions import read_regions
    from hipstr_tpu_torch.models.stutter import StutterModel
    from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline,
                                                     Logger, PipelineOptions)
    from hipstr_tpu_torch.pipeline.hap_aligner import prepare_locus
    opts = PipelineOptions(
        min_reads=15, use_unpaired=True, dtype="float32",
        def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
    p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa", opts,
                          Logger(quiet=True))
    region = read_regions(f"{tmp}/regions.bed", 1)[0]
    g = p.prepare_locus_genotyper(region, p.fasta.get_sequence(region.chrom))
    seqs, quals, seeds = g.pool_inputs()
    return prepare_locus(g.align_haplotype(), seqs, quals, seeds, "float32")


def check_segment(shape, dtype_name, device, rng, fw, statics):
    """K2 at `shape` with the row structure (R, stutter row, active rows,
    transitions, repeat options) of a real prepared locus, random reads."""
    import numpy as np
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm import expand_quals
    from hipstr_tpu_torch.ops.hmm2 import (segment_args, segment_forward_plain,
                                           segment_kernel)
    from hipstr_tpu_torch.pipeline.hap_aligner import stack_arrays
    G, O, P, L, B, H = (shape[k] for k in ("G", "O", "P", "L", "Bmax", "H"))
    R, sr, period, H_real = statics[0], statics[2], statics[4], statics[6]
    dt = resolve_dtype(dtype_name)
    hi = np.arange(H) % fw.row_char.shape[0]
    o_n = min(O, fw.rep_rev_codes.shape[0])
    b_n = min(B, fw.rep_rev_codes.shape[1])
    rep = np.zeros((O, B), np.int32)
    rep[:o_n, :b_n] = fw.rep_rev_codes[:o_n, :b_n]
    rep_len = np.zeros(O, np.int32)
    rep_len[:o_n] = np.minimum(fw.rep_len[:o_n], B)
    lpmf = np.zeros((O, fw.lpmf.shape[1]))
    lpmf[:o_n] = fw.lpmf[:o_n]
    meta = type(fw)(row_char=fw.row_char[hi], row_m2m=fw.row_m2m[hi],
                    row_m2i=fw.row_m2i[hi], row_m2d=fw.row_m2d[hi],
                    rep_rev_codes=rep, rep_len=rep_len, lpmf=lpmf,
                    hap_opt=fw.hap_opt[hi] % o_n, row_active=fw.row_active)
    tmeta = type(fw)(*[to_device(x, device, dt)
                       for x in stack_arrays([meta] * G)])
    codes, quals, last = reads(rng, G, P, L, device, period)
    h_real_np = np.where(np.arange(G) % 2 == 0, min(H_real, H), H)
    h_real = torch.from_numpy(h_real_np.astype(np.int32)).to(device)
    periods = torch.full((G,), period, dtype=torch.int32, device=device)
    blw, blc = expand_quals(quals, dt)
    E = stutter_emissions(codes.int().contiguous(), blw, blc,
                          tmeta.rep_rev_codes.int().contiguous(),
                          tmeta.rep_len.int().contiguous(), periods)
    args, _ = segment_args(codes, quals, last, tmeta, E, R, sr, h_real,
                           periods, dt)
    got = segment_kernel(*args, R=R, sr=sr)
    ref = segment_forward_plain(*args, R=R, sr=sr)
    torch.cuda.synchronize()
    err = compare("segment", got, ref, dtype_name)
    ms = cuda_ms(lambda: segment_kernel(*args, R=R, sr=sr), 5)
    plain_ms = cuda_ms(lambda: segment_forward_plain(*args, R=R, sr=sr), 2)
    b = bound_segment(args, dict(R=R, sr=sr), dtype_name)["bound_ms"]
    return err, ms, plain_ms, b, R


def scan_inputs(P, dtype_name, device, rng, arrays, statics):
    """K4/K3 inputs with the forward row structure, H, L and repeat options
    of a real locus and P random reads."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    from hipstr_tpu_torch.ops.hmm import HapMeta, expand_quals, shift_right
    dt = resolve_dtype(dtype_name)
    R, sr, period = statics[0], statics[2], statics[4]
    L = arrays[0].codes.shape[1]
    codes, quals, last = (x[0] for x in reads(rng, 1, P, L, device, period))
    blw, blc = expand_quals(quals, dt)
    C = torch.cumsum(blc, dim=-1)
    meta = HapMeta(*[to_device(x, device, dt) for x in arrays[2]])
    return ((codes.int().contiguous(), blw, blc, C, shift_right(C, 0.0),
             last.int().contiguous()), meta, R, sr, period)


def check_flank_scan(P, dtype_name, device, rng, arrays, statics):
    """K4 over the phase-1 rows of a real locus from its row-0 state."""
    from hipstr_tpu_torch.ops.hmm import IMPOSSIBLE, emit_locus
    from hipstr_tpu_torch.ops.hmm_scan import (flank_scan_kernel,
                                               flank_scan_plain)
    import torch
    rd, meta, R, sr, _ = scan_inputs(P, dtype_name, device, rng, arrays,
                                     statics)
    codes, blw, blc, C, Csh, _ = rd
    M = emit_locus(codes, meta.row_char[:, 0], blc, blw) + Csh[:, None]
    state = (M, C[:, None].expand(M.shape).contiguous(),
             torch.full_like(M, IMPOSSIBLE))
    rows = [x[:, 1:sr].T.contiguous() for x in (
        meta.row_char, meta.row_m2m, meta.row_m2i, meta.row_m2d)]
    args = (*rd, *rows, meta.row_active[1:sr], *state)
    got = flank_scan_kernel(*args)
    ref = flank_scan_plain(*args)
    torch.cuda.synchronize()
    err = max(compare("flank_scan", g, r, dtype_name)
              for g, r in zip(got, ref))
    ms = cuda_ms(lambda: flank_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: flank_scan_plain(*args), 2)
    return err, ms, plain_ms, bound_flank_scan(args, {}, dtype_name)["bound_ms"]


def check_segment_scan(P, dtype_name, device, rng, arrays, statics):
    """K3 over the forward orientation of a real locus (E from K1)."""
    import torch
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.hmm_scan import (segment_scan_kernel,
                                               segment_scan_plain)
    rd, meta, R, sr, period = scan_inputs(P, dtype_name, device, rng,
                                          arrays, statics)
    codes, blw, blc = rd[:3]
    periods = torch.full((1,), period, dtype=torch.int32, device=device)
    E = stutter_emissions(codes[None], blw[None], blc[None],
                          meta.rep_rev_codes.int()[None],
                          meta.rep_len.int()[None], periods)[0]
    args = (*rd, meta, E, R, sr, period)
    got = segment_scan_kernel(*args)
    ref = segment_scan_plain(*args)
    torch.cuda.synchronize()
    err = compare("segment_scan", got, ref, dtype_name)
    ms = cuda_ms(lambda: segment_scan_kernel(*args), 5)
    plain_ms = cuda_ms(lambda: segment_scan_plain(*args), 2)
    return err, ms, plain_ms, bound_segment_scan(args, {}, dtype_name)[
        "bound_ms"]


def timed(r) -> str:
    """(err, kernel ms, plain ms, bound ms) as one line's part."""
    err, ms, plain, b = r
    return (f"err {err:.3e} kernel {ms:.3f} ms plain {plain:.3f} ms bound "
            f"{b:.4f} ms ({100 * b / ms:.1f} %)")


def phase_kernels(device, tmp):
    import numpy as np
    arrays, statics = real_locus(tmp)
    P_real, L = arrays[0].codes.shape
    H, R = arrays[2].row_char.shape
    O = arrays[2].rep_len.shape[0]
    results = {}
    for label, shape, P in (("main", MAIN, P_real),
                            ("deep", DEEP, SCAN_DEEP_P)):
        for dtype_name in ("float32", "float64"):
            rng = np.random.default_rng(7)
            e = check_emission(shape, dtype_name, device, rng)
            *s, R2 = check_segment(shape, dtype_name, device, rng,
                                   arrays[2], statics)
            f = check_flank_scan(P, dtype_name, device, rng, arrays, statics)
            k3 = check_segment_scan(P, dtype_name, device, rng, arrays,
                                    statics)
            results[(label, dtype_name)] = dict(
                emission=e, segment=tuple(s), flank_scan=f, segment_scan=k3)
            log(f"{label} {dtype_name} G={shape['G']} O={shape['O']} "
                f"P={shape['P']} L={shape['L']} Bmax={shape['Bmax']} "
                f"H={shape['H']} R={R2}: emission {timed(e)} | segment "
                f"{timed(s)}")
            log(f"{label} {dtype_name} one locus P={P} H={H} L={L} O={O} "
                f"R={R} sr={statics[2]} period={statics[4]}: "
                f"flank_scan {timed(f)} | segment_scan {timed(k3)}")
    for shape in WIDE:
        for dtype_name in ("float32", "float64"):
            rng = np.random.default_rng(11)
            e = check_emission(shape, dtype_name, device, rng)
            s = check_segment(shape, dtype_name, device, rng, arrays[2],
                              statics)
            log(f"wide {dtype_name} G={shape['G']} P={shape['P']} "
                f"L={shape['L']}: emission err {e[0]:.3e} kernel "
                f"{e[1]:.3f} ms | segment err {s[0]:.3e} kernel "
                f"{s[1]:.3f} ms")
    return results


# ---------------------------------------------------------------- phase 4
def phase_slice(tmp, device_name="cuda"):
    import torch
    from hipstr_tpu_torch import cli, kernels
    args = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--batch-loci", "32",
            "--dtype", "float32", "--device", device_name, "--silent"]
    # warm the CUDA context and allocator on a few loci (not counted)
    cli.run(args + ["--str-vcf", f"{tmp}/warm.vcf", "--max-regions", "4"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipeline, counters = cli.run(args + ["--str-vcf", f"{tmp}/slice.vcf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: kernels.SHAPES[k].copy() for k in ("emission", "segment")}
    log_shapes("slice", shapes)
    dispatches = pipeline.last_run_stats["dispatches"]
    device_wait = pipeline.timer.totals.get("Device fetch", 0.0)
    log(f"slice: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} dispatches={dispatches} "
        f"launches={launches}")
    log(f"slice: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s, "
        f"host {wall - device_wait:.3f} s, device wait {device_wait:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("slice did not genotype every locus")
    for name in ("emission", "segment"):
        if launches[name] < 2 * dispatches:
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 f"for {dispatches} dispatches")
    for name in ("flank_scan", "segment_scan"):   # per-locus kernels only
        if launches[name]:
            raise AssertionError(f"kernel {name} launched on the batched "
                                 "path")
    check_no_jax()
    recs = vcf_body(f"{tmp}/slice.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"slice VCF has {len(recs)} records")
    return launches, shapes, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                                  host_s=wall - device_wait,
                                  device_wait_s=device_wait)


# ---------------------------------------------------------------- phase 5
def phase_sequential(tmp, device_name="cuda"):
    """The sequential run (--batch-loci 0) on the slice's loci."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.pipeline import hap_aligner
    args = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--batch-loci", "0",
            "--dtype", "float32", "--device", device_name, "--silent"]
    cli.run(args + ["--str-vcf", f"{tmp}/seq_warm.vcf", "--max-regions",
                    "4"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    calls0 = hap_aligner.CALLS
    t0 = time.perf_counter()
    pipeline, counters = cli.run(args + ["--str-vcf", f"{tmp}/seq.vcf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: kernels.SHAPES[k].copy() for k in ("emission", "flank_scan")}
    log_shapes("sequential", shapes)
    n = hap_aligner.CALLS - calls0
    log(f"sequential: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} aligner calls={n} "
        f"launches={launches}")
    log(f"sequential: {SLICE_LOCI / wall:.3f} loci/s, wall {wall:.3f} s")
    log(pipeline.timer.summary())
    if counters.genotype_success != SLICE_LOCI or counters.genotype_fail:
        raise AssertionError("sequential run did not genotype every locus")
    want = dict(emission=2 * n, flank_scan=4 * n, segment=0, segment_scan=0)
    if n < SLICE_LOCI or launches != want:
        raise AssertionError(f"sequential: {n} aligner calls, launches "
                             f"{launches}, expected {want}")
    check_no_jax()
    recs = vcf_body(f"{tmp}/seq.vcf")
    if len(recs) != SLICE_LOCI:
        raise AssertionError(f"sequential VCF has {len(recs)} records")
    return launches, shapes, dict(loci_per_s=SLICE_LOCI / wall, wall_s=wall,
                                  aligner_calls=n)


# ---------------------------------------------------------------- phase 6
def phase_modes(tmp, device):
    """Flank mode (K4) against fused mode (K3) on the first-round
    alignment of every locus of the slice, float64."""
    import numpy as np
    import torch
    from hipstr_tpu_torch import kernels
    from hipstr_tpu_torch.io.regions import read_regions
    from hipstr_tpu_torch.models.stutter import StutterModel
    from hipstr_tpu_torch.pipeline.processor import (GenotyperPipeline,
                                                     Logger, PipelineOptions)
    from hipstr_tpu_torch.pipeline.hap_aligner import \
        compute_hap_log_likelihoods
    opts = PipelineOptions(
        min_reads=15, use_unpaired=True, dtype="float64",
        def_stutter_model=StutterModel(0.95, 0.05, 0.05, 0.95, 0.01, 0.01, 2))
    p = GenotyperPipeline([f"{tmp}/sim.bam"], f"{tmp}/sim.fa", opts,
                          Logger(quiet=True))
    loci = []
    for region in read_regions(f"{tmp}/regions.bed", SLICE_LOCI):
        g = p.prepare_locus_genotyper(region,
                                      p.fasta.get_sequence(region.chrom))
        if g is None:
            raise AssertionError(f"modes: no genotyper for {region}")
        loci.append((region, (g.align_haplotype(), *g.pool_inputs())))
    modes = ("flank", "fused")
    for mode in modes:      # warm-up, not counted
        compute_hap_log_likelihoods(*loci[0][1], dtype="float64",
                                    device=device, mode=mode)
    kernels.reset_launches()
    seconds = dict.fromkeys(modes, 0.0)
    worst = 0.0
    for region, locus in loci:
        ll = {}
        for mode in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # ends in a copy to the host, which waits for the device
            ll[mode] = compute_hap_log_likelihoods(
                *locus, dtype="float64", device=device, mode=mode)
            seconds[mode] += time.perf_counter() - t0
        diff = np.abs(ll["flank"] - ll["fused"])
        if not np.all(diff <= MODES_TOL + MODES_TOL * np.abs(ll["flank"])):
            raise AssertionError(f"modes differ by {diff.max()} at "
                                 f"{region}")
        worst = max(worst, float(diff.max()))
    launches = dict(kernels.LAUNCHES)
    n = len(loci)
    want = dict(emission=4 * n, flank_scan=4 * n, segment=0,
                segment_scan=2 * n)
    if launches != want:
        raise AssertionError(f"modes: launches {launches}, expected {want}")
    check_no_jax()
    ms = {m: 1e3 * seconds[m] / n for m in modes}
    log(f"modes: {n} loci, max |LL flank - LL fused| {worst:.3e}; "
        f"ms per call flank {ms['flank']:.3f} fused {ms['fused']:.3f}; "
        f"launches={launches}")
    loci_inputs = [locus for _, locus in loci]
    return launches, loci_inputs, dict(loci=n, max_abs_diff=worst,
                                       flank_ms=ms["flank"],
                                       fused_ms=ms["fused"])


# ---------------------------------------------------------------- phase 7
def phase_em(tmp, device_name="cuda"):
    """The sequential run without a stutter model: the host EM."""
    from hipstr_tpu_torch import cli
    pipeline, counters = cli.run(
        ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
         "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
         "--use-unpaired", "--batch-loci", "0", "--max-regions",
         str(EM_LOCI), "--dtype", "float32", "--device", device_name,
         "--silent", "--str-vcf", f"{tmp}/em.vcf"])
    recs = vcf_body(f"{tmp}/em.vcf")
    log(f"sequential EM: success={counters.genotype_success} "
        f"fail={counters.genotype_fail} em_fail={counters.em_fail} "
        f"records={len(recs)}")
    if counters.genotype_fail or len(recs) != counters.genotype_success \
            or not recs:
        raise AssertionError("sequential EM run failed")
    check_no_jax()


# ---------------------------------------------------------------- phase 8
def vcf_body(path):
    return [l for l in open(path) if not l.startswith("#")]


def within_drift_bands(a: str, b: str) -> bool:
    """Genotype and integer fields equal, float fields within the golden
    suites' drift bands (0.5 for GLDIFF, 0.2 otherwise)."""
    fa, fb = a.rstrip("\n").split("\t"), b.rstrip("\n").split("\t")
    if fa[:9] != fb[:9] or len(fa) != len(fb):
        return False
    fmt = fa[8].split(":")
    for sa, sb in zip(fa[9:], fb[9:]):
        pa, pb = sa.split(":"), sb.split(":")
        if len(pa) != len(pb):
            return False
        for name, va, vb in zip(fmt, pa, pb):
            if va == vb:
                continue
            try:
                xs = [(float(x), float(y)) for x, y in
                      zip(va.split("|"), vb.split("|"))]
            except ValueError:
                return False
            if name == "GT" or any(x.is_integer() and y.is_integer()
                                   for x, y in xs):
                return False
            band = 0.5 if name == "GLDIFF" else 0.2
            if any(abs(x - y) > band for x, y in xs):
                return False
    return True


def phase_reference(tmp, device_name="cuda"):
    """The float64 VCF of the reference dataset, batched and sequential,
    against tests/data/torch_port_ref_f64.vcf."""
    from hipstr_tpu_torch import cli
    from hipstr_tpu_torch.utils.simdata import (REFERENCE_ARGS,
                                                reference_loci, write_sim)
    write_sim(tmp, reference_loci())
    want = vcf_body(REF_VCF)
    for label, extra in (("batched", []), ("sequential", ["--batch-loci",
                                                          "0"])):
        out = f"{tmp}/ref64_{label}.vcf"
        cli.run(["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
                 "--regions", f"{tmp}/regions.bed", "--str-vcf", out,
                 "--dtype", "float64", "--device", device_name, "--silent"]
                + REFERENCE_ARGS + extra)
        got = vcf_body(out)
        if len(got) != len(want):
            raise AssertionError(f"f64 {label} VCF: {len(got)} records, "
                                 f"reference {len(want)}")
        diffs = [(a, b) for a, b in zip(got, want) if a != b]
        for a, b in diffs:
            log(f"f64 {label} differs from the reference:\n  port "
                f"{a.strip()}\n  ref  {b.strip()}")
            if not within_drift_bands(a, b):
                raise AssertionError(f"f64 {label} VCF outside the golden "
                                     "drift bands")
        log(f"f64 cross-check ({label}): {len(got)} records, "
            f"{len(got) - len(diffs)} byte-identical to the reference")

# ---------------------------------------------------------------- phase 9
# The least time the card could take for a kernel's work on these inputs:
# the larger of its operations over the peak rate of its type (an exp or a
# log counted as one operation, and also reported on its own) and its
# bytes over the memory rate (each input read once, each output written
# once).  Only the work these inputs need is counted: the real block
# lengths (K1), the active rows (K2, K3, K4), the emission planes of the
# options real haplotypes use (K2, K3).
#
#   per DP cell (lane x row) of a flank row: 16 operations (em select, the
#     insert chain's 5, M's 6, D's 3, 1 for the max-scan)
#   row 0 and the forced-match row: 2 per lane; the stutter row: 13 terms
#     of 8 operations (2 of them exp) and one log per lane
#   K1, per lane of a real option (blen > 0) and block step (blen + 1 of
#     them): 7 prefix updates of 2 operations, 12 log-sum-exp terms of 4
#     (one exp), 6 insertion-shift updates of 5; per lane 6*period
#     insertion-prefix steps of 2 operations and 13 outputs (a log each)
FLANK_OPS, EDGE_OPS, STUTTER_OPS = 16, 2, 13 * 8 + 1
K1_STEP_OPS, K1_STEP_EXP = 7 * 2 + 12 * 4 + 6 * 5, 12


def bound(ops, nbytes, exp_log, dtype_name):
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(ops=ops, bytes=nbytes, exp_log=exp_log,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def used_planes(hap_opt, h_real):
    """Emission planes (locus, option) that real haplotypes read."""
    return sum(len(set(ho[:hr].tolist())) for ho, hr in zip(hap_opt, h_real))


def bound_emission(args, kwargs, dtype_name):
    codes, blw, blc, brev, blen, periods = (x.cpu() for x in args)
    G, P, L = codes.shape
    O, B = brev.shape[1:]
    sz = blc.element_size()
    steps = (blen + 1) * (blen > 0)                          # [G, O]
    lanes_real = int((blen > 0).sum()) * P * L
    per = periods.long()[:, None].expand(G, O)[blen > 0]
    ops = P * L * (K1_STEP_OPS * int(steps.sum()) + 12 * int(per.sum())) \
        + lanes_real * 13
    exp_log = P * L * K1_STEP_EXP * int(steps.sum()) + lanes_real * 13
    nbytes = G * P * L * (4 + 2 * sz) + G * O * (B + 1) * 4 + G * 4 \
        + G * O * 13 * P * L * sz
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_segment(args, kwargs, dtype_name):
    R, sr = kwargs["R"], kwargs["sr"]
    codes, blc = args[0], args[2]
    hap_opt, bounds = args[11].cpu(), args[14].cpu()
    G, P, L = codes.shape
    H, O = args[6].shape[1], args[10].shape[1]
    sz = blc.element_size()
    start1, end3, h_real = (bounds[:, k].long() for k in range(3))
    flank = (sr - start1) + (end3 - sr - 2)                  # [G]
    per_lane = FLANK_OPS * flank + 2 * EDGE_OPS + STUTTER_OPS
    lanes = h_real * P * L
    ops = int((lanes * per_lane).sum())
    exp_log = int(lanes.sum()) * (2 * 13 + 1)
    nbytes = G * P * L * (4 + 4 * sz) + G * P * 4 + G * H * R * (4 + 3 * sz) \
        + used_planes(hap_opt, h_real.tolist()) * 13 * P * L * sz \
        + G * H * (8 + 13 * sz) + G * 16 + G * H * R * P * sz
    return bound(ops, nbytes, exp_log, dtype_name)


def bound_flank_scan(args, kwargs, dtype_name):
    codes, blc, active = args[0], args[2], args[10].cpu()
    P, L = codes.shape
    n_rows, H = args[6].shape
    sz = blc.element_size()
    ops = FLANK_OPS * int(active.bool().sum()) * P * H * L
    nbytes = P * L * (4 + 4 * sz) + P * 4 + n_rows * H * (4 + 3 * sz) \
        + n_rows * 4 + 6 * P * H * L * sz + n_rows * P * H * sz
    return bound(ops, nbytes, 0, dtype_name)


def bound_segment_scan(args, kwargs, dtype_name):
    codes, blc, meta, R, sr = args[0], args[2], args[6], args[8], args[9]
    P, L = codes.shape
    H = meta.row_char.shape[0]
    sz = blc.element_size()
    active = meta.row_active.cpu().bool()
    flank = int(active[1:sr].sum()) + int(active[sr + 2:].sum())
    lanes = P * H * L
    ops = lanes * (FLANK_OPS * flank + 2 * EDGE_OPS + STUTTER_OPS)
    planes = len(set(meta.hap_opt.cpu().tolist()))
    nbytes = P * L * (4 + 4 * sz) + P * 4 + H * R * (4 + 3 * sz) + R * 4 \
        + planes * 13 * P * L * sz + H * (8 + 13 * sz) + R * P * H * sz
    return bound(ops, nbytes, lanes * (2 * 13 + 1), dtype_name)


class Capture:
    """While active, calls to `module.attr` (a kernel wrapper) go through,
    and the arguments of the first call of each wanted shape (any shape
    when `wanted` is None) are kept, cloned."""

    def __init__(self, module, attr, shape_of, wanted=None):
        self.module, self.attr = module, attr
        self.shape_of, self.wanted = shape_of, wanted
        self.args = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)

        def wrapper(*args, **kwargs):
            s = self.shape_of(*args)
            if (self.wanted is None or s in self.wanted) \
                    and s not in self.args:
                self.args[s] = (clone(args), dict(kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        parts = [clone(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def as_dtype(x, dt):
    """x with every floating tensor converted to dt."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dt).contiguous() if x.is_floating_point() else x
    if isinstance(x, tuple):
        parts = [as_dtype(v, dt) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def event_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one `fn()` over `reps` launches, CUDA events
    around each launch, after one warm-up.  The launches are queued behind
    a device sleep, so the host's wrapper time does not show as device
    idle.  With `flush` (a tensor of FLUSH_BYTES) the tensor is written
    before every launch, so each launch finds L2 cold."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def top(hist, n=TOP_SHAPES):
    return [s for s, _ in hist.most_common(n)]


def shape_emission(codes, blw, blc, brev, *rest):
    return (codes.shape[0], brev.shape[1], codes.shape[1], codes.shape[2],
            brev.shape[2])


def shape_segment(*args):
    codes, row_char, E = args[0], args[6], args[10]
    return (codes.shape[0], row_char.shape[1], codes.shape[1],
            codes.shape[2], row_char.shape[2], E.shape[1])


def shape_flank_scan(*args):
    P, L = args[0].shape
    n_rows, H = args[6].shape
    return (P, H, L, n_rows)


def shape_segment_scan(*args):
    P, L = args[0].shape
    meta = args[6]
    return (P, meta.row_char.shape[0], L, args[8], meta.lpmf.shape[0])


def time_real(name, kernel, plain, bound_fn, args, kwargs, shape, count,
              flush):
    """One kernel at one captured shape, float32 and float64: error
    against the plain version, warm and flushed times, plain time, bound."""
    import torch
    from hipstr_tpu_torch.device import resolve_dtype
    rows = []
    for dtype_name in ("float32", "float64"):
        a = as_dtype(args, resolve_dtype(dtype_name))
        got, ref = kernel(*a, **kwargs), plain(*a, **kwargs)
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            err = max(compare(name, g, r, dtype_name)
                      for g, r in zip(got, ref))
        else:
            err = compare(name, got, ref, dtype_name)
        warm = event_ms(lambda: kernel(*a, **kwargs), REAL_REPS)
        cold = event_ms(lambda: kernel(*a, **kwargs), REAL_REPS, flush)
        plain_ms = cuda_ms(lambda: plain(*a, **kwargs), 1)
        b = bound_fn(a, kwargs, dtype_name)
        row = dict(shape=list(shape), launches_at_shape=count,
                   dtype=dtype_name, max_abs_err=err, ms=cold, ms_warm=warm,
                   plain_ms=plain_ms, share=b["bound_ms"] / cold, **b)
        log(f"real {name} {shape}x{count} {dtype_name}: err {err:.3e} "
            f"L2-flushed {cold:.4f} ms warm {warm:.4f} ms plain "
            f"{plain_ms:.3f} ms | bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({b['ops']:.3e} ops, {b['bytes']:.3e} bytes, "
            f"{b['exp_log']:.3e} exp/log): {100 * row['share']:.1f} % of "
            f"the bound")
        rows.append(row)
    return rows


def phase_real_shapes(tmp, device, slice_shapes, seq_shapes, loci):
    """Each kernel at its path's two most frequent launch shapes, on the
    arguments that path passed (captured in a second run of it)."""
    import torch
    from hipstr_tpu_torch import cli, kernels
    from hipstr_tpu_torch.ops import hmm2, hmm_scan
    from hipstr_tpu_torch.ops.emission import stutter_emissions
    from hipstr_tpu_torch.ops.stutter_emission import stutter_emissions_plain
    from hipstr_tpu_torch.pipeline.hap_aligner import \
        compute_hap_log_likelihoods
    base = ["--bams", f"{tmp}/sim.bam", "--fasta", f"{tmp}/sim.fa",
            "--regions", f"{tmp}/regions.bed", "--min-reads", "15",
            "--use-unpaired", "--def-stutter-model", "--dtype", "float32",
            "--device", "cuda", "--silent"]
    k1 = Capture(hmm2, "stutter_emissions", shape_emission,
                 top(slice_shapes["emission"]))
    k2 = Capture(hmm2, "segment_kernel", shape_segment,
                 top(slice_shapes["segment"]))
    with k1, k2:
        cli.run(base + ["--batch-loci", "32", "--str-vcf", f"{tmp}/cap.vcf"])
    k4 = Capture(hmm_scan, "flank_scan_kernel", shape_flank_scan,
                 top(seq_shapes["flank_scan"]))
    with k4:
        cli.run(base + ["--batch-loci", "0", "--str-vcf", f"{tmp}/cap0.vcf"])
    kernels.reset_launches()
    k3 = Capture(hmm_scan, "segment_scan_kernel", shape_segment_scan)
    with k3:
        for locus in loci:
            compute_hap_log_likelihoods(*locus, dtype="float32",
                                        device=device, mode="fused")
    k3_shapes = kernels.SHAPES["segment_scan"].copy()
    log_shapes("fused mode", {"segment_scan": k3_shapes})
    hists = dict(emission=slice_shapes["emission"],
                 segment=slice_shapes["segment"],
                 flank_scan=seq_shapes["flank_scan"],
                 segment_scan=k3_shapes)
    table = {
        "emission": (k1, stutter_emissions, stutter_emissions_plain,
                     bound_emission),
        "segment": (k2, hmm2.segment_kernel, hmm2.segment_forward_plain,
                    bound_segment),
        "flank_scan": (k4, hmm_scan.flank_scan_kernel,
                       hmm_scan.flank_scan_plain, bound_flank_scan),
        "segment_scan": (k3, hmm_scan.segment_scan_kernel,
                         hmm_scan.segment_scan_plain, bound_segment_scan),
    }
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {}
    for name, (cap, kernel, plain, bound_fn) in table.items():
        results[name] = []
        for shape in top(hists[name]):
            if shape not in cap.args:
                raise AssertionError(f"{name}: shape {shape} not captured")
            args, kwargs = cap.args[shape]
            results[name] += time_real(name, kernel, plain, bound_fn, args,
                                       kwargs, shape, hists[name][shape],
                                       flush)
    del flush
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = phase_env()
    check_no_jax()
    phase_build()
    check_no_jax()
    from hipstr_tpu_torch.device import resolve_device
    from hipstr_tpu_torch.utils.simdata import trio_loci, write_sim
    device = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.makedirs(f"{tmp}/slice")
        os.makedirs(f"{tmp}/ref")
        t0 = time.perf_counter()
        write_sim(f"{tmp}/slice", trio_loci(SLICE_LOCI, SLICE_READS))
        log(f"dataset: {SLICE_LOCI} loci x 3 samples x {SLICE_READS} reads "
            f"in {time.perf_counter() - t0:.2f} s")
        kres = phase_kernels(device, f"{tmp}/slice")
        check_no_jax()
        # each path's launches, counted from 0 over that path's run
        launches, slice_shapes, slice_stats = phase_slice(f"{tmp}/slice")
        seq_launches, seq_shapes, seq_stats = phase_sequential(
            f"{tmp}/slice")
        mode_launches, loci, mode_stats = phase_modes(f"{tmp}/slice", device)
        phase_em(f"{tmp}/slice")
        phase_reference(f"{tmp}/ref")
        check_no_jax()
        real = phase_real_shapes(f"{tmp}/slice", device, slice_shapes,
                                 seq_shapes, loci)
        check_no_jax()
    log(json.dumps({"slice": slice_stats, "sequential": seq_stats,
                    "modes": mode_stats, "card": card}))
    launches.update(flank_scan=seq_launches["flank_scan"],
                    segment_scan=mode_launches["segment_scan"])
    main32 = kres[("main", "float32")]
    summary = {"kernels": []}
    for name, (src, rep) in SOURCES.items():
        r = real[name][0]            # the most frequent shape, float32
        summary["kernels"].append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], ms_warm=r["ms_warm"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share=r["share"], exp_log=r["exp_log"], shape=r["shape"],
            library_ms=None, main_shape_ms=main32[name][1],
            main_shape_bound_ms=main32[name][3]))
    if not all(k["launches"] > 0 for k in summary["kernels"]):
        raise AssertionError(f"a kernel was never launched: {summary}")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
