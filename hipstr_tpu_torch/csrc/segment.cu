// One-orientation stutter-aware forward DP (K2) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_hmm2.py::_seg_kernel
// (wrapper segment_forward_v2).  For each (locus g, haplotype h, read pool
// p) it runs the match/insert/delete DP over the haplotype's rows in order
// (reference HapAligner.cpp:26-231): row 0 with soft-clip initialisation,
// the flank rows before the repeat, one collapsed stutter row (online
// log-sum-exp over 13 artifact sizes), a forced-match row, the remaining
// flank rows.  It keeps M at the pool's last read column for every row:
// Mcol[g, h, r, p].
//
// What bounds it on the H100: operations (~16 per DP cell, a few per byte
// of E read), issued along one serial row chain per (g, h, p) that rows
// cannot shorten.  The first design ran a block of L threads per chain and
// paid three block barriers per row (~390 in a chain of ~130 rows, with ~15
// operations between them).
//
// Design: one warp per (g, h, p) chain, thread t holding the V = L/32
// consecutive lanes t*V .. t*V+V-1 of M and D in registers; a flank row has
// no shared memory and no barrier (dp_warp.cuh).  A block holds W warps
// (ops/hmm2.segment_geometry picks W for the SM's shared memory) that take
// consecutive p of one (g, h).  The block stages the haplotype's row chars
// and three transition rows into shared memory once with cp.async; each
// warp starts a cp.async copy of the 13 emission planes of the haplotype's
// repeat option for its own pool, which lands while the phase-1 rows run,
// and waits for it only at the stutter row.  The per-lane read constants
// (code, w, c, C, Csh) live in registers, or in a per-warp shared slab for
// float64 at L > 256 where registers would spill.  Each row's last-column M
// goes into a shared [R][W] tile written out coalesced at the end.  Rows
// outside [start1, end3) and haplotypes h >= h_real hold NEG.  The stutter
// row reads M_prev[(j - s_d) mod L] with s_d = rep_len + D_min + d * period
// (may be negative), and 0.0 (not NEG) where j < s_d; every term is clamped
// at IMPOSSIBLE.  IEEE exp/log: no fast math.

#include "dp_warp.cuh"

namespace {

using dpw::kND;

constexpr int kMaxWarps = 8;

// Shared memory of one block, in the order the kernel carves it; the same
// sum as ops/hmm2.segment_geometry.
template <typename T, int V, bool kShared>
size_t smem_bytes(int W, int R) {
  const size_t L = 32 * V;
  size_t b = W * (kND + 1) * L * sizeof(T);                // E planes, M row
  b += W * dpw::Lanes<T, V, kShared>::slab_bytes();        // lane constants
  b += (static_cast<size_t>(R) * W + 3 * R + kND) * sizeof(T);  // Mcol tile,
                                                                // rows, lpmf
  b += static_cast<size_t>(R) * sizeof(int);               // row chars
  return b;
}

template <typename T, int V, bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) segment_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const int* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const T* __restrict__ E, const int* __restrict__ hap_opt,
    const int* __restrict__ shift, const T* __restrict__ lpmf_h,
    const int* __restrict__ bounds, T* __restrict__ Mcol, int H, int P,
    int R, int O, int sr, int W) {
  constexpr int L = 32 * V;
  const T NEG = T(dpw::kNeg);
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int h = blockIdx.y, g = blockIdx.z;
  const int p0 = blockIdx.x * W, p = p0 + w;
  const int wn = min(W, P - p0);  // warps of this block with a pool
  const int start1 = bounds[g * 4 + 0];
  const int end3 = bounds[g * 4 + 1];
  const int h_real = bounds[g * 4 + 2];
  const int period = bounds[g * 4 + 3];
  const size_t gh = static_cast<size_t>(g) * H + h;
  T* out = Mcol + gh * R * P + p0;  // row r, warp w at out[r * P + w]

  if (h >= h_real) {  // bucket-padding haplotype: NEG wholesale
    for (int i = threadIdx.x; i < R * wn; i += blockDim.x) {
      out[static_cast<size_t>(i / wn) * P + i % wn] = NEG;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sE = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * kND * L;
  T* sM = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(W) * kND * L
          + static_cast<size_t>(w) * L;
  unsigned char* slabs = reinterpret_cast<unsigned char*>(
      reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(W) * (kND + 1) * L);
  unsigned char* slab = slabs + w * dpw::Lanes<T, V, kShared>::slab_bytes();
  T* sOut = reinterpret_cast<T*>(
      slabs + W * dpw::Lanes<T, V, kShared>::slab_bytes());  // [R][W]
  T* sM2M = sOut + static_cast<size_t>(R) * W;
  T* sM2I = sM2M + R;
  T* sM2D = sM2I + R;
  T* sLp = sM2D + R;
  int* sChar = reinterpret_cast<int*>(sLp + kND);

  // group 1: the haplotype's rows (whole block)
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dpw::cp_async<sizeof(T)>(sM2M + r, row_m2m + gh * R + r);
    dpw::cp_async<sizeof(T)>(sM2I + r, row_m2i + gh * R + r);
    dpw::cp_async<sizeof(T)>(sM2D + r, row_m2d + gh * R + r);
    dpw::cp_async<sizeof(int)>(sChar + r, row_char + gh * R + r);
  }
  if (threadIdx.x < kND) {
    dpw::cp_async<sizeof(T)>(sLp + threadIdx.x, lpmf_h + gh * kND + threadIdx.x);
  }
  dpw::cp_async_commit();
  // group 2: this pool's 13 emission planes of the haplotype's option, each
  // thread its own lanes (waited for at the stutter row)
  const size_t plane = static_cast<size_t>(P) * L;
  if (p < P) {
    const T* Eh = E + (static_cast<size_t>(g) * O + hap_opt[gh]) * kND * plane
                  + static_cast<size_t>(p) * L + t * V;
#pragma unroll
    for (int dd = 0; dd < kND; ++dd) {
      dpw::cp_lanes<T, V>(sE + dd * L + t * V, Eh + dd * plane);
    }
  }
  dpw::cp_async_commit();
  for (int i = threadIdx.x; i < R * W; i += blockDim.x) sOut[i] = NEG;
  dpw::cp_async_wait<1>();
  __syncthreads();

  if (p < P) {
    dpw::Lanes<T, V, kShared> ln;
    ln.load(codes, blw, blc, C, Csh,
            (static_cast<size_t>(g) * P + p) * L + t * V, slab);
    const int lc = last_col[g * P + p];
    T* col = sOut + w;  // the last column's M of row r at col[r * W]
    T jk[V];            // j * ins2ins of the thread's lanes
#pragma unroll
    for (int v = 0; v < V; ++v) jk[v] = T(t * V + v) * T(dpw::kInsToIns);
    T m[V], d[V];

    // row 0: leftmost hap char; earlier read bases soft-clip at blc
    // (I of a row feeds no later row: it is rebuilt from M by the scan)
    const int ch0 = sChar[0];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      m[v] = (ln.code(v) == ch0 ? ln.c(v) : ln.w(v)) + ln.Csh(v);
      d[v] = T(dpw::kImpossible);
    }
    dpw::keep_col<T, V>(m, lc, col);

    // phase 1: flank rows start1 .. sr-1 (1 .. start1-1 are bucket padding)
    for (int r = start1; r < sr; ++r) {
      dpw::flank_row<T, V>(m, d, ln, jk, sChar[r], sM2M[r], sM2I[r],
                           sM2D[r]);
      dpw::keep_col<T, V>(m, lc, col + r * W);
    }

    // phase 2: the stutter row, once the emission planes have landed
    dpw::cp_async_wait<0>();
    __syncwarp();
    dpw::stutter_row<T, V>(m, sM, sE, sLp, shift[gh], period, L);
#pragma unroll
    for (int v = 0; v < V; ++v) d[v] = T(dpw::kImpossible);
    dpw::keep_col<T, V>(m, lc, col + sr * W);

    // forced-match row: the repeat block is left through a match
    if (sr + 1 < R) {
      dpw::forced_match_row<T, V>(m, ln, sChar[sr + 1]);
      dpw::keep_col<T, V>(m, lc, col + (sr + 1) * W);
    }

    // phase 3: remaining flank rows (tail bucket padding skipped)
    for (int r = sr + 2; r < end3; ++r) {
      dpw::flank_row<T, V>(m, d, ln, jk, sChar[r], sM2M[r], sM2I[r],
                           sM2D[r]);
      dpw::keep_col<T, V>(m, lc, col + r * W);
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < R * wn; i += blockDim.x) {
    const int r = i / wn, ww = i % wn;
    out[static_cast<size_t>(r) * P + ww] = sOut[r * W + ww];
  }
}

template <typename T, int V, bool kShared>
int launch_v(const void* const* a, void* Mcol, int G, int H, int P, int R,
             int O, int sr, int W, int smem, cudaStream_t stream) {
  auto kern = segment_kernel<T, V, kShared>;
  if (smem_bytes<T, V, kShared>(W, R) > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int configured = 0;  // dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  dim3 grid((P + W - 1) / W, H, G);
  kern<<<grid, W * 32, smem, stream>>>(
      static_cast<const int*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const T*>(a[10]), static_cast<const int*>(a[11]),
      static_cast<const int*>(a[12]), static_cast<const T*>(a[13]),
      static_cast<const int*>(a[14]), static_cast<T*>(Mcol), H, P, R, O, sr,
      W);
  return static_cast<int>(cudaGetLastError());
}

// lane constants in shared memory for float64 past 8 lanes a thread (L > 256)
template <typename T>
int launch(const void* const* a, void* Mcol, int G, int H, int P, int L,
           int R, int O, int nD, int sr, int W, int smem, void* stream) {
  if (G == 0 || H == 0 || P == 0) return 0;
  if (nD != kND || W < 1 || W > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kWide = sizeof(T) == 8;
  switch (L) {
    case 64: return launch_v<T, 2, false>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    case 128: return launch_v<T, 4, false>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    case 192: return launch_v<T, 6, false>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    case 256: return launch_v<T, 8, false>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    case 384: return launch_v<T, 12, kWide>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    case 512: return launch_v<T, 16, kWide>(a, Mcol, G, H, P, R, O, sr, W, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define SEGMENT_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d, const void* E,     \
      const void* hap_opt, const void* shift, const void* lpmf_h,           \
      const void* bounds, void* Mcol, int G, int H, int P, int L, int R,    \
      int O, int nD, int sr, int W, int smem, void* stream) {               \
    const void* a[15] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, E, hap_opt, shift, lpmf_h, bounds};      \
    return launch<T>(a, Mcol, G, H, P, L, R, O, nD, sr, W, smem, stream);   \
  }

SEGMENT_ENTRY(segment_f32, float)
SEGMENT_ENTRY(segment_f64, double)
