// Device helpers shared by the forward-DP kernels (segment.cu, K2;
// flank_scan.cu, K4; segment_scan.cu, K3).
//
// Every kernel that includes this runs one block per (pool, haplotype) row
// with one thread per read lane j (blockDim = L <= kMaxLanes, a multiple of
// 32).  The helpers below are the row recurrences of ops/hmm.py written for
// that layout: the one-lane shifts go through shared memory, the in-row
// insert recurrence is a block max-scan.  Each helper contains block
// barriers, so every thread of the block must call it.  IEEE exp/log: the
// kernels are built without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace dp {

// one thread per read lane; the largest L bucket of prepare_locus
constexpr int kMaxLanes = 512;

// transition constants of ops/hmm.py (log(e^-1), log1p(-e^-1))
constexpr double kInsToIns = -1.0;
constexpr double kInsToMatch = -0.45867514538708193;
constexpr double kDelToDel = -1.0;
constexpr double kDelToMatch = -0.45867514538708193;
constexpr double kNeg = -1.0e30;
constexpr double kImpossible = -1.0e9;

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) { return a > b ? a : b; }

// Inclusive max-scan over the block's lanes (warp shuffles, then a prefix
// over the warp totals; max is exact, so the order cannot change a bit).
// Contains one __syncthreads().
template <typename T>
__device__ __forceinline__ T block_max_scan(T v, T* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = xmax(v, t);
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  T pre = T(kNeg);
  for (int w = 0; w < warp; ++w) pre = xmax(pre, wtot[w]);
  return warp > 0 ? xmax(v, pre) : v;
}

// Shared scratch of one block: the previous row's M and D and the new I
// for the one-lane shifts (L each), and 32 warp totals.
template <typename T>
struct RowScratch {
  T* sM;
  T* sD;
  T* sI;
  T* wtot;
  __device__ explicit RowScratch(T* base, int L)
      : sM(base), sD(base + L), sI(base + 2 * L), wtot(base + 3 * L) {}
  static size_t bytes(int L) { return (3 * L + 32) * sizeof(T); }
};

// One flank row (reference HapAligner.cpp:110-156) at lane j.  m and d
// hold the previous row's M and D and are replaced by the new row's;
// returns the new row's I.  em is this lane's emission, Cj / Cshj the
// read's inclusive / exclusive prefix sums of log P(correct).
template <typename T>
__device__ __forceinline__ T flank_row(T& m, T& d, T em, T Cj, T Cshj,
                                       T m2m, T m2i, T m2d,
                                       const RowScratch<T>& s) {
  const int j = threadIdx.x;
  const T neg = T(kNeg);
  const T jj = T(j);
  s.sM[j] = m;
  s.sD[j] = d;
  __syncthreads();
  const T mprev = j ? s.sM[j - 1] : neg;
  const T dprev = j ? s.sD[j - 1] : neg;
  const T a = j ? mprev + T(kInsToMatch) : T(0);
  const T f = a - Cshj - jj * T(kInsToIns);
  const T cm = block_max_scan(f, s.wtot);
  const T i_new = Cj + jj * T(kInsToIns) + cm;
  s.sI[j] = i_new;
  __syncthreads();
  const T iprev = j ? s.sI[j - 1] : neg;
  const T t = j ? xmax(iprev + m2i, xmax(mprev + m2m, dprev + m2d)) : T(0);
  const T d_new = xmax(m + T(kDelToMatch), d + T(kDelToDel));
  m = em + t;
  d = d_new;
  return i_new;
}

// The collapsed repeat-block row (reference HapAligner.cpp:62-108) at lane
// j: an online log-sum-exp over nD artifact sizes.  m holds the previous
// row's M and is replaced by the stutter row's.  Artifact dd enters from
// M_prev[(j - s_d) mod L] with s_d = shift + dd * period (shift may be
// negative), and from 0.0 (not NEG) where j < s_d; every term is clamped
// at IMPOSSIBLE.  Eh points at this lane's emission of artifact 0 of the
// haplotype's repeat option, artifact dd `plane` elements further; lp at
// the haplotype's nD log artifact probabilities.
template <typename T>
__device__ __forceinline__ void stutter_row(T& m, const T* Eh, size_t plane,
                                            const T* lp, int shift,
                                            int period, int nD, int L,
                                            const RowScratch<T>& s) {
  const int j = threadIdx.x;
  s.sM[j] = m;
  __syncthreads();
  T mx = T(kNeg), sm = T(0);
  for (int dd = 0; dd < nD; ++dd) {
    const int s_d = shift + dd * period;
    int src = (j - s_d) % L;
    if (src < 0) src += L;
    const T ent = j >= s_d ? s.sM[src] : T(0);
    const T val = xmax(lp[dd] + Eh[dd * plane] + ent, T(kImpossible));
    const T nm = xmax(mx, val);
    sm = sm * xexp(mx - nm) + xexp(val - nm);
    mx = nm;
  }
  m = mx + xlog(sm);
  __syncthreads();
}

// The row right after the repeat block, entered by a match only
// (reference HapAligner.cpp:124-139).
template <typename T>
__device__ __forceinline__ void forced_match_row(T& m, T em,
                                                 const RowScratch<T>& s) {
  const int j = threadIdx.x;
  s.sM[j] = m;
  __syncthreads();
  const T t = j ? s.sM[j - 1] : T(0);
  m = em + t;
  __syncthreads();
}

}  // namespace dp
