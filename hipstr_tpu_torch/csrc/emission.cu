// Stutter-block emission kernel (K1) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_emission.py::_emission_kernel
// (wrapper stutter_emissions_pallas).  Computes E[G, O, 13, P, L]: for each
// locus g, repeat option o, read pool p and read lane j, the log-likelihood
// of the read suffix ending at j against the repeat block with a stutter
// artifact of D = k * period, k in [-6, 6], marginalised over the artifact
// position (reference StutterAlignerClass.cpp:55-162).
//
// What bounds it on the H100: operations, not bytes.  Each lane runs
// O(blen) serial steps with twelve online log-sum-exp terms per step (six
// deletion, six insertion), while it reads one pool row (L codes and
// qualities) and writes 13 values; the exp throughput of the SMs and the
// serial sweep length (the real block length, up to Bmax) set the time.
// The first design carried all twelve accumulator chains in one thread per
// lane (56 registers f32, 114 f64) and paid two exps per term.
//
// Design: one block per (g, o, p) with two threads per read lane
// (blockDim = 2L <= 1024): the threads of the first half take deletions
// 6p..4p and insertions 4p..6p, those of the second half deletions 3p..1p
// and insertions 1p..3p, so each carries six chains and the grid holds
// twice the threads where the real batched shapes are small.  float64 at
// L > 256 keeps one thread per lane (blockDim = L) with all twelve chains:
// two threads per lane there would leave 64 registers a thread and spill.
// After the TPU kernel's lane shears, lane j at sweep step t reads
// score(codes[p, j - t], brev[o, t]): it depends only on the lane, so the
// sweeps run per thread with their accumulators in registers.  The pool row
// sits in shared memory as a score table, tab[b][i] = log P(read i | base
// b) (rows for the five codes, one of blw and one of blc), so a score is
// one shared load at a warp-uniform row offset of the repeat allele's
// character.  The one value that crosses lanes is E0: the insertion pass
// reads E0[j - k * period], so E0 goes to shared memory behind one
// __syncthreads().  The deletion sweep (pass 2) and the insertion position
// sweep (pass 4) run as one loop over the block position q; the insertion
// shift's delta at a read position is the difference of two table rows.
// Each log-sum-exp term costs one exp.  The TPU kernel's
// binary-decomposition shears and loop unrolling are Mosaic workarounds and
// are not carried over.  IEEE exp/log throughout: no fast math.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// the largest L bucket of prepare_locus
constexpr int kMaxLanes = 512;
constexpr int kUnits = 6;            // max_units: artifacts -6p .. +6p
constexpr int kND = 2 * kUnits + 1;  // 13
// dynamic shared memory a block may use without cudaFuncSetAttribute
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }

// online log-sum-exp with one exp per term and no branch (a branch would
// diverge within a warp and pay both exps): (mx, sm) holds mx + log(sm)
// of the terms so far; mx = NEG, sm = 0 is the empty sum
template <typename T>
__device__ __forceinline__ void lse_push(T& mx, T& sm, T v) {
  const bool up = v > mx;
  const T e = xexp(up ? mx - v : v - mx);
  sm = up ? sm * e + T(1) : sm + e;
  mx = up ? v : mx;
}

// rows of the score table: one per read code 0..4, then blw and blc
constexpr int kCodes = 5;
constexpr int kRowW = kCodes, kRowC = kCodes + 1, kRows = kCodes + 2;

// the block's pool row as a score table and the repeat allele as row
// offsets into it, in shared memory
template <typename T>
struct Row {
  const T* tab;      // [kRows][L]: tab[b * L + i] = code[i] == b ? blc : blw
  const int* brow;   // [Bmax]: row offset of each block character
  int blen;
  int c_row;         // row offset of blc (kRowC * L)
  // col_S(k) sheared, seen from a lane: read position i against block
  // position k; 0 outside the block or left of the read
  __device__ __forceinline__ T score(int i, int k) const {
    if (i < 0 || k >= blen) return T(0);
    return tab[brow[k] + i];
  }
};

// Pass 1 for the kN deletions D0 .. D0+kN-1 (dp = (6 - d) * period): the
// no-artifact prefix E0 and each deletion's total.
template <typename T, int kD0, int kN>
__device__ __forceinline__ void pass1(const Row<T>& row, int j, int period,
                                      T (&tot)[kN], T& e0) {
  T pref0 = T(0), run[kN];
#pragma unroll
  for (int d = 0; d < kN; ++d) { run[d] = T(0); tot[d] = T(0); }
  for (int t = 0; t < row.blen; ++t) {
    const int i = j - t;
    pref0 += row.score(i, t);
#pragma unroll
    for (int d = 0; d < kN; ++d) {
      const int dp = (kUnits - kD0 - d) * period;
      run[d] += row.score(i, t + dp);
      if (t + 1 == row.blen - dp) tot[d] = run[d];
    }
  }
  e0 = pref0;
}

// Passes 3, 2 and 4 for the kN deletions D0 .. and the kN insertions
// K0 .. (kp = (k + 1) * period), then their outputs.
template <typename T, int kD0, int kK0, int kN>
__device__ __forceinline__ void sweeps(const Row<T>& row, const T* s_e0,
                                       int j, int period, const T (&tot)[kN],
                                       T* Eo, size_t plane) {
  const T NEG = T(-1.0e30);
  const int blen = row.blen;

  // ---- pass 3: insertion prefix with periodic extension -----------------
  T cum[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) cum[k] = T(0);
  T ins = T(0);
  const int max_ins = (kK0 + kN) * period;  // the largest own kp
  for (int t = 0; t < max_ins; ++t) {
    const int i = j - t;
    const int cm = t % period;
    T pair = T(0);
    if (i >= 0) pair = row.tab[(cm < blen ? row.brow[cm] : row.c_row) + i];
    ins += pair;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int kp = (kK0 + k + 1) * period;
      if (t + 1 == kp) {
        const int src = j - kp;
        cum[k] = ins + (src >= 0 ? s_e0[src] : T(0));
      }
    }
  }

  // ---- passes 2 and 4: one sweep over block positions q -----------------
  T mxD[kN], smD[kN], run[kN];
  T mxI[kN], smI[kN], star[kN];
  int pstar[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    mxD[k] = NEG; smD[k] = T(0); run[k] = T(0);
    int v = j + 1 - (kK0 + k + 1) * period;
    v = v < blen ? v : blen;
    pstar[k] = v < 0 ? 0 : v;
    mxI[k] = NEG; smI[k] = T(0); star[k] = T(0);
  }
  T pref0 = T(0);
  for (int q = 0; q <= blen; ++q) {
    // pass 2: deletion position (evaluate at q; valid positions are the
    // prefix q <= blen - dp, later ones would be NEG no-op terms)
#pragma unroll
    for (int d = 0; d < kN; ++d) {
      if (q <= blen - (kUnits - kD0 - d) * period) {
        lse_push(mxD[d], smD[d], pref0 + tot[d] - run[d]);
      }
    }
    // pass 4: insertion position with the P*-clamp
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (q == pstar[k]) star[k] = cum[k];
      if (q <= pstar[k]) lse_push(mxI[k], smI[k], cum[k]);
    }
    if (q == blen) break;
    // pass 2: extend the prefixes by block position q
    const int i = j - q;
    pref0 += row.score(i, q);
#pragma unroll
    for (int d = 0; d < kN; ++d) {
      run[d] += row.score(i, q + (kUnits - kD0 - d) * period);
    }
    // pass 4: per-unit position-shift deltas, frozen near the block end;
    // both lookups of a unit share its read position
    if (q + period < blen) {
      const T* lo = row.tab + row.brow[q];
      const T* hi = row.tab + row.brow[q + period];
      T run_d = T(0);
#pragma unroll
      for (int m = 0; m < kK0 + kN; ++m) {
        const int im = i - (m + 1) * period;
        run_d += im >= 0 ? hi[im] - lo[im] : T(0);
        if (m >= kK0) cum[m - kK0] += run_d;
      }
    }
  }

#pragma unroll
  for (int d = 0; d < kN; ++d) {
    const int rem = blen - (kUnits - kD0 - d) * period;
    const T prior = -xlog(T(rem + 1 > 1 ? rem + 1 : 1));
    Eo[(kD0 + d) * plane] = rem >= 0 ? prior + (mxD[d] + xlog(smD[d])) : NEG;
  }
  const T prior_ins = -xlog(T(blen + 1));
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int count = blen - pstar[k];
    T m = mxI[k], s = smI[k];
    if (count > 0) lse_push(m, s, star[k] + xlog(T(count)));
    Eo[(kUnits + 1 + kK0 + k) * plane] = prior_ins + (m + xlog(s));
  }
}

// kSplit threads per lane (1 or 2), at most kMaxThreads a block
template <typename T, int kSplit, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) emission_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const int* __restrict__ brev,
    const int* __restrict__ blen_arr, const int* __restrict__ periods,
    T* __restrict__ E, int O, int P, int L, int Bmax) {
  constexpr int kN = kUnits / kSplit;  // artifacts of each kind per thread
  const int p = blockIdx.x, o = blockIdx.y, g = blockIdx.z;
  const int half = threadIdx.x >= L;  // whole warps: L is a multiple of 32
  const int j = threadIdx.x - half * L;

  extern __shared__ unsigned char smem_raw[];
  T* s_tab = reinterpret_cast<T*>(smem_raw);  // [kRows][L]
  T* s_e0 = s_tab + kRows * L;
  int* s_brow = reinterpret_cast<int*>(s_e0 + L);

  const size_t row0 = (static_cast<size_t>(g) * P + p) * L;
  if (!half) {
    const int code = codes[row0 + j];
    const T w = blw[row0 + j], c = blc[row0 + j];
#pragma unroll
    for (int b = 0; b < kCodes; ++b) s_tab[b * L + j] = code == b ? c : w;
    s_tab[kRowW * L + j] = w;
    s_tab[kRowC * L + j] = c;
  }
  // a block character outside the read codes matches no read base: blw
  const int* brev_o = brev + (static_cast<size_t>(g) * O + o) * Bmax;
  for (int k = threadIdx.x; k < Bmax; k += blockDim.x) {
    const int b = brev_o[k];
    s_brow[k] = (b >= 0 && b < kCodes ? b : kRowW) * L;
  }
  const Row<T> row{s_tab, s_brow, blen_arr[g * O + o], kRowC * L};
  const int period = periods[g];
  __syncthreads();

  const size_t plane = static_cast<size_t>(P) * L;
  T* Eo = E + (static_cast<size_t>(g) * O + o) * kND * plane
          + static_cast<size_t>(p) * L + j;
  T tot[kN], e0;
  if constexpr (kSplit == 2) {
    if (half) pass1<T, kN, kN>(row, j, period, tot, e0);
  }
  if (!half) {
    pass1<T, 0, kN>(row, j, period, tot, e0);
    s_e0[j] = e0;
    Eo[kUnits * plane] = e0;
  }
  __syncthreads();
  if constexpr (kSplit == 2) {
    if (half) sweeps<T, kN, 0, kN>(row, s_e0, j, period, tot, Eo, plane);
  }
  if (!half) sweeps<T, 0, kUnits - kN, kN>(row, s_e0, j, period, tot, Eo, plane);
}

template <typename T>
int launch(const void* codes, const void* blw, const void* blc,
           const void* brev, const void* blen, const void* periods, void* E,
           int G, int O, int P, int L, int Bmax, void* stream) {
  if (G == 0 || O == 0 || P == 0) return 0;
  if (L % 32 || L > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(P, O, G);
  // K1 sets no shared-memory attribute (K2, K3 and K4 do, per device:
  // dp_warp.cuh's allow_smem), so its block stays within the 48 KB allowed
  // without one: the table and E0 take at
  // most (kRows + 1) * L * sizeof(T) = 8 * 512 * 8 = 32 KB (float64,
  // L = 512), which leaves room for Bmax <= 4096 repeat characters there;
  // ops/emission.py raises before a launch past it.
  const size_t smem = (kRows + 1) * L * sizeof(T) + Bmax * sizeof(int);
  if (smem > kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(codes);
  const T* w = static_cast<const T*>(blw);
  const T* k = static_cast<const T*>(blc);
  const int* b = static_cast<const int*>(brev);
  const int* n = static_cast<const int*>(blen);
  const int* q = static_cast<const int*>(periods);
  T* e = static_cast<T*>(E);
  if constexpr (sizeof(T) == 4) {
    emission_kernel<T, 2, 2 * kMaxLanes><<<grid, 2 * L, smem, s>>>(
        c, w, k, b, n, q, e, O, P, L, Bmax);
  } else if (L <= kMaxLanes / 2) {
    emission_kernel<T, 2, kMaxLanes><<<grid, 2 * L, smem, s>>>(
        c, w, k, b, n, q, e, O, P, L, Bmax);
  } else {
    emission_kernel<T, 1, kMaxLanes><<<grid, L, smem, s>>>(
        c, w, k, b, n, q, e, O, P, L, Bmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int emission_f32(const void* codes, const void* blw,
                            const void* blc, const void* brev,
                            const void* blen, const void* periods, void* E,
                            int G, int O, int P, int L, int Bmax,
                            void* stream) {
  return launch<float>(codes, blw, blc, brev, blen, periods, E, G, O, P, L,
                       Bmax, stream);
}

extern "C" int emission_f64(const void* codes, const void* blw,
                            const void* blc, const void* brev,
                            const void* blen, const void* periods, void* E,
                            int G, int O, int P, int L, int Bmax,
                            void* stream) {
  return launch<double>(codes, blw, blc, brev, blen, periods, E, G, O, P, L,
                        Bmax, stream);
}
