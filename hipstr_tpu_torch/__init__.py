"""hipstr_tpu_torch — the PyTorch/CUDA port of hipstr_tpu for NVIDIA Hopper.

The layout mirrors `hipstr_tpu` so each module's counterpart is easy to
find.  The JAX package stays the reference; this package imports `torch`
and never `jax`, and nothing of `hipstr_tpu`: the host code it needs (BAM,
CRAM, FASTA and VCF IO, filters, haplotype generation, the genotyper's
adaptive rounds, the host stutter EM, VCF records, the native host
library's bindings) is a copy of the JAX package's, each module where its
counterpart sits, its docstring naming the file it came from.

Package layout:
  device.py    device / dtype resolution (explicit, never falls back)
  kernels.py   nvcc build + ctypes loading of csrc/*.cu, launch counters
  csrc/        hand-written CUDA C++ kernels for sm_90a
  native.py    the native host library (native/*.cpp, built here) + bindings
  align/ io/ models/ phasing/    host layers (copies)
  ops/         HMM containers, stutter emissions, segment forward,
               seed combination, posteriors (torch and host), host EM,
               batched stutter EM (torch)
  pipeline/    per-locus packing (prepare_locus), the torch aligner, the
               sequential run, and the host pipeline (copies)
  parallel/    the batched executor (run_batched, each dispatch sharded
               over the devices) and the host worker pool (run_pooled)
  utils/       simulated datasets, math, timers
  cli.py       `python -m hipstr_tpu_torch.cli`
  graft_entry.py  the counterparts of __graft_entry__.py (entry,
               dryrun_multichip)
"""

__version__ = "0.1.0"
