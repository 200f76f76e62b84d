// Fused single-locus segment forward (K3) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_hmm.py::_segment_kernel
// (wrapper segment_scan_pallas).  For one locus and one orientation it
// runs the whole match/insert/delete DP of every (read pool p, haplotype
// h) in one launch (reference HapAligner.cpp:26-231): row 0 with
// soft-clip initialisation, the flank rows before the repeat, the
// collapsed stutter row (online log-sum-exp over 13 artifact sizes), the
// forced-match row, the remaining flank rows.  A flank row whose active
// flag is 0 (bucket padding) passes the state through.  It writes M at
// the pool's last read column for every row, inactive rows included (the
// carried value): Mcol[r, p, h].  Bucket-padding haplotypes are computed
// like real ones (the caller slices them off).
//
// What bounds it on the H100: counted, operations (~16 per DP cell of a
// flank row, 13 log-sum-exp terms per lane of the stutter row).  What its
// time follows is the latency of one serial chain of up to 450 rows per
// (p, h).  The first design ran a block of L threads per chain, paid three
// block barriers per flank row and read each row's char and transitions
// from device memory inside the chain.
//
// Design: one warp per (p, h) chain on dp_warp.cuh's rows, thread t holding
// lanes t*V .. t*V+V-1 (V = L/32) of M and D in registers; a flank row has
// no barrier and touches no shared memory.  A block holds W warps on
// consecutive h of one p, the map of ops/hmm_scan.scan_chain (W from
// ops/hmm_scan.scan_geometry), so each row's W last-column values are one
// contiguous run of Mcol [R, P, H] and the block's row metadata one
// contiguous range of the [H, R] rows.  Before row 0 the block stages those
// rows (three transition rows with cp.async, and the chars; [W][R]), the R
// active flags and, for each haplotype, the 13 log artifact probabilities
// of its repeat option o = hap_opt[h] into shared memory; the row loops read
// nothing from device memory.  The kernel takes the locus's metadata as the
// per-locus path holds it (int8 chars, bool flags, the options' lpmf [O,
// 13] and rep_len [O]), so a launch needs no conversion kernels beside it.
// Each warp starts a cp.async copy of the 13 emission planes of option o
// for its pool (E stays in K1's layout [O, 13, P, L]); it lands while the
// phase-1 rows run and is waited for only at the stutter row, which reads
// M_prev[(j - s_d) mod L] with s_d = rep_len[o] - 6 * period + d * period
// (may be negative), and 0.0 where j < s_d, as the TPU kernel's circular
// rolls do.  Each row's last-column M goes into a shared [R][W] tile
// written out at the end.  The per-lane read constants live in registers,
// or in a per-warp shared slab for float64 at L > 256 where registers would
// spill.  IEEE exp/log: no fast math.

#include "dp_warp.cuh"

namespace {

using dpw::kND;

constexpr int kMaxWarps = 8;

// Shared memory of one block, in the order the kernel carves it; the same
// sum as ops/hmm_scan.scan_smem("segment_scan", ...).
template <typename T, int V, bool kShared>
size_t smem_bytes(int W, int R) {
  const size_t L = 32 * V;
  const size_t rw = static_cast<size_t>(R) * W;
  return W * (kND + 1) * L * sizeof(T)                // E planes, M row
         + W * dpw::Lanes<T, V, kShared>::slab_bytes()  // lane constants
         + (4 * rw + W * kND) * sizeof(T)  // Mcol tile, transitions, lpmf
         + (rw + R) * sizeof(int);         // row chars, active flags
}

template <typename T, int V, bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) segment_scan_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const signed char* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const unsigned char* __restrict__ row_active, const T* __restrict__ E,
    const int* __restrict__ hap_opt, const int* __restrict__ rep_len,
    const T* __restrict__ lpmf, T* __restrict__ Mcol, int P, int H, int R,
    int sr, int period, int W) {
  constexpr int L = 32 * V;
  constexpr size_t kSlab = dpw::Lanes<T, V, kShared>::slab_bytes();
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  // the chain of ops/hmm_scan.scan_chain: block (x, y) runs h0 .. h0+W-1
  // of pool y, warp w haplotype h0 + w
  const int p = blockIdx.y, h0 = blockIdx.x * W, h = h0 + w;
  const int wn = min(W, H - h0);  // warps of this block with a haplotype
  const size_t rw = static_cast<size_t>(R) * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sE = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * kND * L;
  T* sM = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(W) * kND * L
          + static_cast<size_t>(w) * L;
  unsigned char* slabs = reinterpret_cast<unsigned char*>(
      reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(W) * (kND + 1) * L);
  unsigned char* slab = slabs + w * kSlab;
  T* sOut = reinterpret_cast<T*>(slabs + W * kSlab);  // [R][W]
  T* sM2M = sOut + rw;                                // [W][R]
  T* sM2I = sM2M + rw;
  T* sM2D = sM2I + rw;
  T* sLp = sM2D + rw;                                 // [W][13]
  int* sChar = reinterpret_cast<int*>(sLp + W * kND);  // [W][R]
  int* sAct = sChar + rw;                              // [R]

  // group 1 (whole block): rows h0 .. h0+wn-1 of the [H, R] metadata, one
  // contiguous range, to [W][R]; the active flags; each warp's lpmf row
  const size_t row0 = static_cast<size_t>(h0) * R;
  for (int i = threadIdx.x; i < R * wn; i += blockDim.x) {
    dpw::cp_async<sizeof(T)>(sM2M + i, row_m2m + row0 + i);
    dpw::cp_async<sizeof(T)>(sM2I + i, row_m2i + row0 + i);
    dpw::cp_async<sizeof(T)>(sM2D + i, row_m2d + row0 + i);
    sChar[i] = row_char[row0 + i];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) sAct[r] = row_active[r];
  const int o = w < wn ? hap_opt[h] : 0;  // the haplotype's repeat option
  if (w < wn && t < kND) {
    dpw::cp_async<sizeof(T)>(sLp + w * kND + t,
                             lpmf + static_cast<size_t>(o) * kND + t);
  }
  dpw::cp_async_commit();
  // group 2: this chain's 13 emission planes of its haplotype's option,
  // each thread its own lanes (waited for at the stutter row)
  const size_t plane = static_cast<size_t>(P) * L;
  if (w < wn) {
    const T* Eh = E + static_cast<size_t>(o) * kND * plane
                  + static_cast<size_t>(p) * L + t * V;
#pragma unroll
    for (int dd = 0; dd < kND; ++dd) {
      dpw::cp_lanes<T, V>(sE + dd * L + t * V, Eh + dd * plane);
    }
  }
  dpw::cp_async_commit();
  dpw::cp_async_wait<1>();
  __syncthreads();

  if (w < wn) {
    dpw::Lanes<T, V, kShared> ln;
    ln.load(codes, blw, blc, C, Csh, static_cast<size_t>(p) * L + t * V,
            slab);
    const int lc = last_col[p];
    const int s_h = rep_len[o] - (kND - 1) / 2 * period;  // artifact 0
    const int* ch = sChar + static_cast<size_t>(w) * R;  // this chain's rows
    const T* m2m = sM2M + static_cast<size_t>(w) * R;
    const T* m2i = sM2I + static_cast<size_t>(w) * R;
    const T* m2d = sM2D + static_cast<size_t>(w) * R;
    T* col = sOut + w;  // the last column's M of row r at col[r * W]
    T jk[V];            // j * ins2ins of the thread's lanes
#pragma unroll
    for (int v = 0; v < V; ++v) jk[v] = T(t * V + v) * T(dpw::kInsToIns);
    T m[V], d[V];

    // row 0: leftmost hap char; earlier read bases soft-clip at blc
    const int ch0 = ch[0];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      m[v] = (ln.code(v) == ch0 ? ln.c(v) : ln.w(v)) + ln.Csh(v);
      d[v] = T(dpw::kImpossible);
    }
    dpw::keep_col<T, V>(m, lc, col);

    // phase 1: flank rows 1 .. sr-1, inactive ones carrying the state
    for (int r = 1; r < sr; ++r) {
      if (sAct[r]) {  // uniform across the block
        dpw::flank_row<T, V>(m, d, ln, jk, ch[r], m2m[r], m2i[r], m2d[r]);
      }
      dpw::keep_col<T, V>(m, lc, col + r * W);
    }

    // phase 2: the stutter row, once the emission planes have landed
    dpw::cp_async_wait<0>();
    __syncwarp();
    dpw::stutter_row<T, V>(m, sM, sE, sLp + w * kND, s_h, period, L);
#pragma unroll
    for (int v = 0; v < V; ++v) d[v] = T(dpw::kImpossible);
    dpw::keep_col<T, V>(m, lc, col + sr * W);

    // forced-match row: the repeat block is left through a match
    if (sr + 1 < R) {
      dpw::forced_match_row<T, V>(m, ln, ch[sr + 1]);
      dpw::keep_col<T, V>(m, lc, col + (sr + 1) * W);
    }

    // phase 3: remaining flank rows
    for (int r = sr + 2; r < R; ++r) {
      if (sAct[r]) {
        dpw::flank_row<T, V>(m, d, ln, jk, ch[r], m2m[r], m2i[r], m2d[r]);
      }
      dpw::keep_col<T, V>(m, lc, col + r * W);
    }
  }

  __syncthreads();
  // row r of haplotype h0 + k at out[r * P * H + k]
  T* out = Mcol + static_cast<size_t>(p) * H + h0;
  const size_t row_stride = static_cast<size_t>(P) * H;
  for (int i = threadIdx.x; i < R * wn; i += blockDim.x) {
    const int r = i / wn, k = i % wn;
    out[r * row_stride + k] = sOut[r * W + k];
  }
}

template <typename T, int V, bool kShared>
int launch_v(const void* const* a, void* Mcol, int P, int H, int R, int sr,
             int period, int W, int smem, cudaStream_t stream) {
  auto kern = segment_scan_kernel<T, V, kShared>;
  if (smem_bytes<T, V, kShared>(W, R) > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int allowed[dpw::kMaxDevices] = {};  // per device, by index
  const cudaError_t e = dpw::allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((H + W - 1) / W, P);
  kern<<<grid, W * 32, smem, stream>>>(
      static_cast<const int*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const signed char*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const unsigned char*>(a[10]),
      static_cast<const T*>(a[11]), static_cast<const int*>(a[12]),
      static_cast<const int*>(a[13]), static_cast<const T*>(a[14]),
      static_cast<T*>(Mcol), P, H, R, sr, period, W);
  return static_cast<int>(cudaGetLastError());
}

// lane constants in shared memory for float64 past 8 lanes a thread (L > 256)
template <typename T>
int launch(const void* const* a, void* Mcol, int P, int H, int L, int R,
           int nD, int sr, int period, int W, int smem, void* stream) {
  if (P == 0 || H == 0) return 0;
  if (nD != kND || W < 1 || W > kMaxWarps || sr < 1 || sr >= R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kWide = sizeof(T) == 8;
  switch (L) {
    case 64: return launch_v<T, 2, false>(a, Mcol, P, H, R, sr, period, W, smem, s);
    case 128: return launch_v<T, 4, false>(a, Mcol, P, H, R, sr, period, W, smem, s);
    case 192: return launch_v<T, 6, false>(a, Mcol, P, H, R, sr, period, W, smem, s);
    case 256: return launch_v<T, 8, false>(a, Mcol, P, H, R, sr, period, W, smem, s);
    case 384: return launch_v<T, 12, kWide>(a, Mcol, P, H, R, sr, period, W, smem, s);
    case 512: return launch_v<T, 16, kWide>(a, Mcol, P, H, R, sr, period, W, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define SEGMENT_SCAN_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d,                    \
      const void* row_active, const void* E, const void* hap_opt,           \
      const void* rep_len, const void* lpmf, void* Mcol, int P, int H,      \
      int L, int R, int nD, int sr, int period, int W, int smem,            \
      void* stream) {                                                       \
    const void* a[15] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, row_active, E, hap_opt, rep_len, lpmf};  \
    return launch<T>(a, Mcol, P, H, L, R, nD, sr, period, W, smem, stream); \
  }

SEGMENT_SCAN_ENTRY(segment_scan_f32, float)
SEGMENT_SCAN_ENTRY(segment_scan_f64, double)
