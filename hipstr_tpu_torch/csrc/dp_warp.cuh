// Warp-per-chain helpers of the forward DP (segment.cu, K2).
//
// One warp runs one (locus, haplotype, read pool) chain: thread t holds the
// V = L/32 consecutive read lanes j = t*V .. t*V+V-1 of the row state M and
// D in registers.  A flank row needs no shared memory and no barrier: the
// one-lane shifts are register moves plus one __shfl_up_sync for the
// thread's first lane, and the in-row insert recurrence (an inclusive
// max-scan over the lanes) is a serial scan over the thread's own lanes
// followed by a 5-step shuffle scan of the thread totals.  Max is exact, so
// the bits are those of the block-per-chain rows of dp_rows.cuh.  The
// stutter row gathers M_prev[(j - s) mod L] through a per-warp row in
// shared memory behind one __syncwarp().  IEEE exp/log: no fast math.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace dpw {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kND = 13;  // artifact sizes -6p .. +6p

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

// ---- copies of a thread's V consecutive lanes ------------------------------
// V*sizeof(T) bytes starting at a multiple of that size: 16-byte pieces where
// the size allows, 8-byte pieces otherwise (V is even, so 8 always divides).
template <typename T, int V>
__host__ __device__ constexpr int piece_bytes() {
  return (V * sizeof(T)) % 16 == 0 ? 16 : 8;
}

// one piece of kN elements of T as a CUDA vector type, moved member by
// member (a pointer cast into a local vector would put it in local memory)
template <typename T, int kN>
struct Piece;
template <>
struct Piece<float, 4> {
  using V = float4;
  __device__ static void get(const V& v, float* d) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __device__ static V make(const float* s) {
    return make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <>
struct Piece<float, 2> {
  using V = float2;
  __device__ static void get(const V& v, float* d) { d[0] = v.x; d[1] = v.y; }
  __device__ static V make(const float* s) { return make_float2(s[0], s[1]); }
};
template <>
struct Piece<int, 4> {
  using V = int4;
  __device__ static void get(const V& v, int* d) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __device__ static V make(const int* s) {
    return make_int4(s[0], s[1], s[2], s[3]);
  }
};
template <>
struct Piece<int, 2> {
  using V = int2;
  __device__ static void get(const V& v, int* d) { d[0] = v.x; d[1] = v.y; }
  __device__ static V make(const int* s) { return make_int2(s[0], s[1]); }
};
template <>
struct Piece<double, 2> {
  using V = double2;
  __device__ static void get(const V& v, double* d) { d[0] = v.x; d[1] = v.y; }
  __device__ static V make(const double* s) {
    return make_double2(s[0], s[1]);
  }
};
template <>
struct Piece<double, 1> {
  using V = double;
  __device__ static void get(const V& v, double* d) { d[0] = v; }
  __device__ static V make(const double* s) { return s[0]; }
};

// dst[0..V) = src[0..V) through registers (global or shared memory)
template <typename T, int V>
__device__ __forceinline__ void load_lanes(T (&dst)[V], const T* src) {
  constexpr int kN = piece_bytes<T, V>() / sizeof(T);
  using P = Piece<T, kN>;
#pragma unroll
  for (int i = 0; i < V; i += kN) {
    P::get(*reinterpret_cast<const typename P::V*>(src + i), dst + i);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_lanes(T* dst, const T (&src)[V]) {
  constexpr int kN = piece_bytes<T, V>() / sizeof(T);
  using P = Piece<T, kN>;
#pragma unroll
  for (int i = 0; i < V; i += kN) {
    *reinterpret_cast<typename P::V*>(dst + i) = P::make(src + i);
  }
}

// ---- cp.async: device memory -> shared memory without registers ------------
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// copy a thread's V lanes (V*sizeof(T) bytes, aligned to that size)
template <typename T, int V>
__device__ __forceinline__ void cp_lanes(T* smem, const T* gmem) {
  constexpr int kB = piece_bytes<T, V>();
  constexpr int kN = kB / sizeof(T);
#pragma unroll
  for (int i = 0; i < V; i += kN) cp_async<kB>(smem + i, gmem + i);
}

// ---- per-lane read constants ------------------------------------------------
// code, log P(error) w, log P(correct) c and the inclusive / exclusive prefix
// sums C / Csh of log P(correct), for the thread's V lanes.  In registers,
// or (kShared, where registers would spill) in a per-warp slab of shared
// memory laid out [V][32] so lane v of all 32 threads is one conflict-free
// row.
template <typename T, int V, bool kShared>
struct Lanes;

template <typename T, int V>
struct Lanes<T, V, false> {
  int code_[V];
  T w_[V], c_[V], C_[V], Csh_[V];
  // one warp's slab, bytes (none)
  __host__ __device__ static constexpr size_t slab_bytes() { return 0; }
  __device__ void load(const int* code, const T* w, const T* c, const T* C,
                       const T* Csh, size_t lane0, unsigned char*) {
    load_lanes<int, V>(code_, code + lane0);
    load_lanes<T, V>(w_, w + lane0);
    load_lanes<T, V>(c_, c + lane0);
    load_lanes<T, V>(C_, C + lane0);
    load_lanes<T, V>(Csh_, Csh + lane0);
  }
  __device__ __forceinline__ int code(int v) const { return code_[v]; }
  __device__ __forceinline__ T w(int v) const { return w_[v]; }
  __device__ __forceinline__ T c(int v) const { return c_[v]; }
  __device__ __forceinline__ T C(int v) const { return C_[v]; }
  __device__ __forceinline__ T Csh(int v) const { return Csh_[v]; }
};

template <typename T, int V>
struct Lanes<T, V, true> {
  const T* s_;  // [4][V][32]: w, c, C, Csh; then int code [V][32]
  int t_;
  __host__ __device__ static constexpr size_t slab_bytes() {
    return static_cast<size_t>(V) * 32 * (4 * sizeof(T) + sizeof(int));
  }
  __device__ void load(const int* code, const T* w, const T* c, const T* C,
                       const T* Csh, size_t lane0, unsigned char* slab) {
    t_ = threadIdx.x & 31;
    T* s = reinterpret_cast<T*>(slab);
    int* sc = reinterpret_cast<int*>(s + 4 * V * 32);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s[(0 * V + v) * 32 + t_] = w[lane0 + v];
      s[(1 * V + v) * 32 + t_] = c[lane0 + v];
      s[(2 * V + v) * 32 + t_] = C[lane0 + v];
      s[(3 * V + v) * 32 + t_] = Csh[lane0 + v];
      sc[v * 32 + t_] = code[lane0 + v];
    }
    s_ = s;  // each thread reads back only its own entries: no sync needed
  }
  __device__ __forceinline__ int code(int v) const {
    return reinterpret_cast<const int*>(s_ + 4 * V * 32)[v * 32 + t_];
  }
  __device__ __forceinline__ T w(int v) const { return s_[v * 32 + t_]; }
  __device__ __forceinline__ T c(int v) const {
    return s_[(V + v) * 32 + t_];
  }
  __device__ __forceinline__ T C(int v) const {
    return s_[(2 * V + v) * 32 + t_];
  }
  __device__ __forceinline__ T Csh(int v) const {
    return s_[(3 * V + v) * 32 + t_];
  }
};

// M of lane lc (the pool's last read column) into *dst, by the thread that
// holds it: one predicated store per lane (a select over v would be
// compiled into an indexed load from a local-memory copy of m)
template <typename T, int V>
__device__ __forceinline__ void keep_col(const T (&m)[V], int lc, T* dst) {
  const int j0 = (threadIdx.x & 31) * V;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (j0 + v == lc) *dst = m[v];
  }
}

// M/D of lane j-1 for the thread's first lane (NEG at lane 0)
template <typename T>
__device__ __forceinline__ T from_left(T x_last, int t) {
  const T y = __shfl_up_sync(kFull, x_last, 1);
  return t ? y : T(kNeg);
}

// One flank row (reference HapAligner.cpp:110-156) over the thread's V lanes.
// m and d hold the previous row's M and D and become the new row's; ch is
// the row's haplotype character, m2m/m2i/m2d its transitions; jk[v] is
// j * ins2ins of the thread's lane v.  Same terms in the same order as
// dp::flank_row, so the same bits.
template <typename T, int V, class LanesT>
__device__ __forceinline__ void flank_row(T (&m)[V], T (&d)[V],
                                          const LanesT& ln, const T (&jk)[V],
                                          int ch, T m2m, T m2i, T m2d) {
  const int t = threadIdx.x & 31;
  const T m_in = from_left(m[V - 1], t);
  const T d_in = from_left(d[V - 1], t);
  // f = a - Csh - j*ins2ins, then its inclusive max-scan over the lanes;
  // only lane 0 (thread 0, v = 0) has no left neighbour
  T f[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const T a = v ? m[v - 1] + T(kInsToMatch)
                  : (t ? m_in + T(kInsToMatch) : T(0));
    f[v] = a - ln.Csh(v) - jk[v];
  }
#pragma unroll
  for (int v = 1; v < V; ++v) f[v] = xmax(f[v], f[v - 1]);
  T incl = f[V - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, off);
    if (t >= off) incl = xmax(incl, y);
  }
  const T before = __shfl_up_sync(kFull, incl, 1);  // max over lanes < j0
  // I of the new row (f becomes i_new)
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const T cm = t ? xmax(f[v], before) : f[v];
    f[v] = ln.C(v) + jk[v] + cm;
  }
  const T i_in = from_left(f[V - 1], t);
  // new M and D, last lane first so lane v-1 still holds the old row
#pragma unroll
  for (int v = V - 1; v >= 0; --v) {
    const T mprev = v ? m[v - 1] : m_in;
    const T dprev = v ? d[v - 1] : d_in;
    const T iprev = v ? f[v - 1] : i_in;
    const T best = xmax(iprev + m2i, xmax(mprev + m2m, dprev + m2d));
    const T tr = (v || t) ? best : T(0);
    const T d_new = xmax(m[v] + T(kDelToMatch), d[v] + T(kDelToDel));
    const T em = ln.code(v) == ch ? ln.c(v) : ln.w(v);
    m[v] = em + tr;
    d[v] = d_new;
  }
}

// The row right after the repeat block, entered by a match only
// (reference HapAligner.cpp:124-139).
template <typename T, int V, class LanesT>
__device__ __forceinline__ void forced_match_row(T (&m)[V], const LanesT& ln,
                                                 int ch) {
  const int t = threadIdx.x & 31;
  const T y = __shfl_up_sync(kFull, m[V - 1], 1);
  const T m_in = t ? y : T(0);
#pragma unroll
  for (int v = V - 1; v >= 0; --v) {
    const T em = ln.code(v) == ch ? ln.c(v) : ln.w(v);
    m[v] = em + (v ? m[v - 1] : m_in);
  }
}

// The collapsed repeat-block row (reference HapAligner.cpp:62-108): an
// online log-sum-exp over the 13 artifact sizes, the terms in the order and
// form of dp::stutter_row.  Artifact dd enters from M_prev[(j - s_d) mod L]
// with s_d = shift + dd * period (shift may be negative), and from 0.0 (not
// NEG) where j < s_d; every term is clamped at IMPOSSIBLE.  sM is the
// warp's row of L values; sE the warp's copy of the 13 emission planes
// [13][L] of the haplotype's repeat option; lp (shared) the 13 log artifact
// probabilities.  Once per chain, so the artifact loop stays rolled.
template <typename T, int V>
__device__ __forceinline__ void stutter_row(T (&m)[V], T* sM, const T* sE,
                                            const T* lp, int shift,
                                            int period, int L) {
  const int j0 = (threadIdx.x & 31) * V;
  store_lanes<T, V>(sM + j0, m);
  __syncwarp();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j0 + v;
    T mx = T(kNeg), sm = T(0);
#pragma unroll 1
    for (int dd = 0; dd < kND; ++dd) {
      const int s_d = shift + dd * period;
      int src = (j - s_d) % L;
      if (src < 0) src += L;
      const T ent = j >= s_d ? sM[src] : T(0);
      const T val = xmax(lp[dd] + sE[dd * L + j] + ent, T(kImpossible));
      const T nm = xmax(mx, val);
      sm = sm * xexp(mx - nm) + xexp(val - nm);
      mx = nm;
    }
    m[v] = mx + xlog(sm);
  }
}

}  // namespace dpw
