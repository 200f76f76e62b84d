"""hipstr_tpu_torch — the PyTorch/CUDA port of hipstr_tpu for NVIDIA Hopper.

The layout mirrors `hipstr_tpu` so each module's counterpart is easy to
find.  The JAX package stays the reference; this package imports `torch`
and never `jax`.  Host-side code that never touched JAX (BAM/FASTA/VCF IO,
filters, haplotype generation, the genotyper's adaptive rounds, VCF
records) is imported from `hipstr_tpu` through `host.py`.

Package layout:
  device.py    device / dtype resolution (explicit, never falls back)
  host.py      the one bridge into hipstr_tpu's JAX-free host code
  kernels.py   nvcc build + ctypes loading of csrc/*.cu, launch counters
  csrc/        hand-written CUDA C++ kernels for sm_90a
  ops/         HMM containers, stutter emissions, segment forward,
               seed combination, fused genotype posteriors
  pipeline/    per-locus packing (prepare_locus) and the torch aligner
  parallel/    the batched executor (run_batched)
  cli.py       `python -m hipstr_tpu_torch.cli`
"""

__version__ = "0.1.0"
