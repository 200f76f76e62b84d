// Ordered per-sample sum of the fused genotype posteriors, for sm_90a.
//
// The port's own kernel: it replaces no Pallas kernel.  In the JAX package
// the fused posteriors' per-sample sum is an XLA op
// (hipstr_tpu/ops/posteriors.py::batched_pool_posteriors, its
// jax.ops.segment_sum), and the host posteriors that write the JAX CLI's
// VCF add each sample's reads in order (np.add.at in
// ops/posteriors.py::_segment_sum).  A one-hot matrix product (a DGEMM)
// rounds its blocked accumulation differently: at 100 samples a tenth of
// the float64 cells land an ulp or more away from the host's sum.  This
// kernel adds them in the host's order, so the card's float64 posteriors
// are those of the host, bit for bit.
//
// Computes out[g, s, c] = sum over the reads r of sample s of contrib[g, r,
// c], taken as ((0 + x_r0) + x_r1) + ... over that sample's reads in read
// order.  The wrapper (ops/posteriors.sample_sums) passes order[g, :], the
// read indices of locus g stably sorted by sample, and start/count[g, s],
// each sample's run in it.
//
// What bounds it on the H100: bytes.  One add per value read (8 or 4 bytes
// of contrib, read once); the output and the index arrays are small beside
// it.  Design: one block per (locus, sample), one thread per genotype cell
// c (C = H * H <= 1024 cells, strided by the block), each walking its
// sample's reads in order with the sum in a register.  A warp reads 32
// neighbouring cells of one read's row: coalesced.  No atomics, so the
// result does not depend on the order in which blocks run.  Adds only: no
// multiply for the compiler to contract into an FMA.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void sample_sum_kernel(const T* __restrict__ contrib,
                                  const int* __restrict__ order,
                                  const int* __restrict__ start,
                                  const int* __restrict__ count,
                                  T* __restrict__ out, int R, int Sm, int C) {
  const int gs = blockIdx.x;               // g * Sm + s
  const int g = gs / Sm;
  const int n = count[gs];
  const int* reads = order + static_cast<size_t>(g) * R + start[gs];
  const T* base = contrib + static_cast<size_t>(g) * R * C;
  T* dst = out + static_cast<size_t>(gs) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    T acc = T(0);
    for (int k = 0; k < n; ++k) {
      acc += base[static_cast<size_t>(reads[k]) * C + c];
    }
    dst[c] = acc;
  }
}

template <typename T>
int launch(const void* contrib, const void* order, const void* start,
           const void* count, void* out, int G, int R, int Sm, int C,
           void* stream) {
  if (G <= 0 || R <= 0 || Sm <= 0 || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = C < kThreads ? ((C + 31) / 32) * 32 : kThreads;
  sample_sum_kernel<T><<<G * Sm, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(contrib), static_cast<const int*>(order),
      static_cast<const int*>(start), static_cast<const int*>(count),
      static_cast<T*>(out), R, Sm, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sample_sum_f32(const void* contrib, const void* order,
                              const void* start, const void* count, void* out,
                              int G, int R, int Sm, int C, void* stream) {
  return launch<float>(contrib, order, start, count, out, G, R, Sm, C,
                       stream);
}

extern "C" int sample_sum_f64(const void* contrib, const void* order,
                              const void* start, const void* count, void* out,
                              int G, int R, int Sm, int C, void* stream) {
  return launch<double>(contrib, order, start, count, out, G, R, Sm, C,
                        stream);
}
