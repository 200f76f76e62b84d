// Stutter-block emission kernel (K1) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_emission.py::_emission_kernel
// (wrapper stutter_emissions_pallas).  Computes E[G, O, 13, P, L]: for each
// locus g, repeat option o, read pool p and read lane j, the log-likelihood
// of the read suffix ending at j against the repeat block with a stutter
// artifact of D = k * period, k in [-6, 6], marginalised over the artifact
// position (reference StutterAlignerClass.cpp:55-162).
//
// What bounds it on the H100: arithmetic, not bytes.  Each lane runs
// O(blen) serial steps per sweep with six online log-sum-exps (two exp each)
// in the deletion and insertion sweeps, while it reads one pool row (L
// codes and qualities) and writes 13 values.  The exp/log throughput of the
// SMs and the serial sweep length (the real block length, up to Bmax) set
// the time; padded options (blen = 0) fall straight through.
//
// Design: one block per (g, o, p), one thread per read lane j
// (blockDim = L <= 512).
// After the TPU kernel's lane shears, lane j at sweep step t reads
// score(codes[p, j - t], brev[o, t]): it depends only on the thread's own
// lane, so passes 1, 2 and 4 run per thread with their six-way accumulators
// in registers.  The pool row and the repeat allele sit in shared memory.
// The one value that crosses lanes is E0: the insertion pass reads
// E0[j - k * period], so E0 goes to shared memory behind one
// __syncthreads().  The TPU kernel's binary-decomposition shears and loop
// unrolling are Mosaic workarounds and are not carried over.  Invalid
// log-sum-exp terms (exact no-ops once a real term has been seen) are
// skipped.  IEEE exp/log throughout: no fast math.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// one thread per read lane; the largest L bucket of prepare_locus
constexpr int kMaxLanes = 512;
constexpr int kUnits = 6;            // max_units: artifacts -6p .. +6p
constexpr int kND = 2 * kUnits + 1;  // 13

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ void lse_push(T& mx, T& sm, T v) {
  T nm = xmax(mx, v);
  sm = sm * xexp(mx - nm) + xexp(v - nm);
  mx = nm;
}

template <typename T>
__global__ void __launch_bounds__(kMaxLanes) emission_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const int* __restrict__ brev,
    const int* __restrict__ blen_arr, const int* __restrict__ periods,
    T* __restrict__ E, int O, int P, int L, int Bmax) {
  const T NEG = T(-1.0e30);
  const int p = blockIdx.x, o = blockIdx.y, g = blockIdx.z;
  const int j = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  T* s_blw = reinterpret_cast<T*>(smem_raw);
  T* s_blc = s_blw + L;
  T* s_e0 = s_blc + L;
  int* s_codes = reinterpret_cast<int*>(s_e0 + L);
  int* s_brev = s_codes + L;

  const size_t row = (static_cast<size_t>(g) * P + p) * L;
  s_codes[j] = codes[row + j];
  s_blw[j] = blw[row + j];
  s_blc[j] = blc[row + j];
  const int* brev_o = brev + (static_cast<size_t>(g) * O + o) * Bmax;
  for (int k = j; k < Bmax; k += L) s_brev[k] = brev_o[k];
  const int blen = blen_arr[g * O + o];
  const int period = periods[g];
  __syncthreads();

  // col_S(k) sheared by t, seen from lane j: read position i = j - t
  // against block position k; 0 outside the block or left of the read
  auto score = [&](int i, int k) -> T {
    if (i < 0 || k >= blen) return T(0);
    return s_codes[i] == s_brev[k] ? s_blc[i] : s_blw[i];
  };

  int dps[kUnits], kps[kUnits];
#pragma unroll
  for (int d = 0; d < kUnits; ++d) {
    dps[d] = (kUnits - d) * period;  // 6p .. 1p
    kps[d] = (d + 1) * period;       // 1p .. 6p
  }

  // ---- pass 1: no-artifact prefix (E0) and per-deletion totals ----------
  T pref0 = T(0), e0 = T(0);
  T run[kUnits], tot[kUnits];
#pragma unroll
  for (int d = 0; d < kUnits; ++d) { run[d] = T(0); tot[d] = T(0); }
  for (int t = 0; t < blen; ++t) {
    const int i = j - t;
    pref0 += score(i, t);
    if (t + 1 == blen) e0 = pref0;
#pragma unroll
    for (int d = 0; d < kUnits; ++d) {
      run[d] += score(i, t + dps[d]);
      if (t + 1 == blen - dps[d]) tot[d] = run[d];
    }
  }

  // ---- pass 2: deletion position log-sum-exp (evaluate at p, extend) ----
  T mx[kUnits], sm[kUnits];
  pref0 = T(0);
#pragma unroll
  for (int d = 0; d < kUnits; ++d) { run[d] = T(0); mx[d] = NEG; sm[d] = T(0); }
  for (int q = 0; q <= blen; ++q) {
#pragma unroll
    for (int d = 0; d < kUnits; ++d) {
      // valid positions are the prefix q <= blen - dp; later ones are NEG
      // terms that leave (mx, sm) unchanged
      if (q <= blen - dps[d]) lse_push(mx[d], sm[d], pref0 + tot[d] - run[d]);
    }
    const int i = j - q;
    pref0 += score(i, q);
#pragma unroll
    for (int d = 0; d < kUnits; ++d) run[d] += score(i, q + dps[d]);
  }

  const size_t plane = static_cast<size_t>(P) * L;
  T* Eo = E + (static_cast<size_t>(g) * O + o) * kND * plane
          + static_cast<size_t>(p) * L + j;
#pragma unroll
  for (int d = 0; d < kUnits; ++d) {
    const int rem = blen - dps[d];
    const T prior = -xlog(T(rem + 1 > 1 ? rem + 1 : 1));
    Eo[d * plane] = rem >= 0 ? prior + (mx[d] + xlog(sm[d])) : NEG;
  }
  Eo[kUnits * plane] = e0;

  // ---- pass 3: insertion prefix with periodic extension -----------------
  s_e0[j] = e0;
  __syncthreads();
  T cum[kUnits];
  T ins = T(0);
#pragma unroll
  for (int k = 0; k < kUnits; ++k) cum[k] = T(0);
  const int max_ins = kUnits * period;
  for (int t = 0; t < max_ins; ++t) {
    const int i = j - t;
    const int cm = t % period;
    T pair = T(0);
    if (i >= 0) {
      pair = cm < blen ? (s_codes[i] == s_brev[cm] ? s_blc[i] : s_blw[i])
                       : s_blc[i];
    }
    ins += pair;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (t + 1 == kps[k]) {
        const int src = j - kps[k];
        cum[k] = ins + (src >= 0 ? s_e0[src] : T(0));
      }
    }
  }

  // ---- pass 4: position sweep with the P*-clamp ---------------------------
  int pstar[kUnits];
  T star[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    int v = j + 1 - kps[k];
    v = v < blen ? v : blen;
    pstar[k] = v < 0 ? 0 : v;
    mx[k] = NEG; sm[k] = T(0); star[k] = T(0);
  }
  for (int q = 0; q <= blen; ++q) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (q == pstar[k]) star[k] = cum[k];
      if (q <= pstar[k]) lse_push(mx[k], sm[k], cum[k]);
    }
    // per-unit position-shift deltas, frozen near the block end
    if (q + period < blen) {
      T run_d = T(0);
#pragma unroll
      for (int m = 0; m < kUnits; ++m) {
        const int i = j - q - kps[m];
        const T cur = i >= 0 ? score(i, q + period) - score(i, q) : T(0);
        run_d += cur;
        cum[m] += run_d;
      }
    }
  }
  const T prior_ins = -xlog(T(blen + 1));
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int count = blen - pstar[k];
    T m = mx[k], s = sm[k];
    if (count > 0) lse_push(m, s, star[k] + xlog(T(count)));
    Eo[(kUnits + 1 + k) * plane] = prior_ins + (m + xlog(s));
  }
}

template <typename T>
int launch(const void* codes, const void* blw, const void* blc,
           const void* brev, const void* blen, const void* periods, void* E,
           int G, int O, int P, int L, int Bmax, void* stream) {
  if (G == 0 || O == 0 || P == 0) return 0;
  dim3 grid(P, O, G);
  const size_t smem = 3 * L * sizeof(T) + (L + Bmax) * sizeof(int);
  emission_kernel<T><<<grid, L, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const T*>(blw),
      static_cast<const T*>(blc), static_cast<const int*>(brev),
      static_cast<const int*>(blen), static_cast<const int*>(periods),
      static_cast<T*>(E), O, P, L, Bmax);
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
