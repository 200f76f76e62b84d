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
// What bounds it on the H100: latency of the serial row chain.  Each row is
// a handful of flops per lane plus an in-row max-scan and three block
// barriers, and rows cannot overlap; device-memory traffic is the [P, L]
// read slab and one E plane read once per block, plus R scalars written.
// Enough (g, h, p) blocks are in flight (G*H*P, 16k at the main shape) to
// hide that latency across the 132 SMs.
//
// Design: one block per (g, h, p) with one thread per read lane
// (blockDim = L <= 512).  M and D of the current row live in registers
// (I feeds no later row); the previous row's M and D and the new I go
// through shared memory for the one-lane shifts, behind __syncthreads().
// The in-row insert recurrence is a block-wide inclusive max-scan (warp
// shuffles, then a prefix over the warp totals; max is exact, so the scan
// order cannot change a bit).  Row metadata (char, m2m/m2i/m2d) is read
// straight from HapMeta; the TPU kernel's packed int32 stream and LUT
// argmin existed for its scalar memory.  The stutter row reads M_prev[(j - s_d) mod L] with
// s_d = rep_len + D_min + d * period (may be negative), and 0.0 (not NEG)
// where j < s_d; every term is clamped at IMPOSSIBLE.  It fills all L
// lanes, past the pool's last column too.  Rows outside [start1, end3) and
// haplotypes h >= h_real hold NEG.  IEEE exp/log: no fast math.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// one thread per read lane; the largest L bucket of prepare_locus
constexpr int kMaxLanes = 512;

__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
template <typename T>
__device__ __forceinline__ T xmax(T a, T b) { return a > b ? a : b; }

// transition constants of ops/hmm.py (log(e^-1), log1p(-e^-1))
constexpr double kInsToIns = -1.0;
constexpr double kInsToMatch = -0.45867514538708193;
constexpr double kDelToDel = -1.0;
constexpr double kDelToMatch = -0.45867514538708193;

// Inclusive max-scan over the block's lanes.  Every thread of the block
// must call it; it contains one __syncthreads().
template <typename T>
__device__ __forceinline__ T block_max_scan(T v, T* wtot, T neg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = xmax(v, t);
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  T pre = neg;
  for (int w = 0; w < warp; ++w) pre = xmax(pre, wtot[w]);
  return warp > 0 ? xmax(v, pre) : v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxLanes) segment_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const int* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const T* __restrict__ E, const int* __restrict__ hap_opt,
    const int* __restrict__ shift, const T* __restrict__ lpmf_h,
    const int* __restrict__ bounds, T* __restrict__ Mcol,
    int H, int P, int L, int R, int O, int nD, int sr) {
  const T NEG = T(-1.0e30);
  const T IMPOSSIBLE = T(-1.0e9);
  const int p = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int j = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  T* sM = reinterpret_cast<T*>(smem_raw);
  T* sD = sM + L;
  T* sI = sD + L;
  T* wtot = sI + L;  // 32 warp totals

  const int start1 = bounds[g * 4 + 0];
  const int end3 = bounds[g * 4 + 1];
  const int h_real = bounds[g * 4 + 2];
  const int period = bounds[g * 4 + 3];
  const size_t gh = static_cast<size_t>(g) * H + h;
  T* out = Mcol + gh * R * P + p;  // row r at out[r * P]

  if (h >= h_real) {  // bucket-padding haplotype: NEG wholesale
    for (int r = j; r < R; r += L) out[static_cast<size_t>(r) * P] = NEG;
    return;
  }
  // rows the runtime bounds skip (bucket padding) hold NEG
  for (int r = 1 + j; r < start1; r += L) {
    out[static_cast<size_t>(r) * P] = NEG;
  }
  for (int r = end3 + j; r < R; r += L) out[static_cast<size_t>(r) * P] = NEG;

  const size_t lane = (static_cast<size_t>(g) * P + p) * L + j;
  const int code = codes[lane];
  const T w = blw[lane], c = blc[lane], Cj = C[lane], Cshj = Csh[lane];
  const int lc = last_col[g * P + p];
  const int* chars = row_char + gh * R;
  const T* m2m = row_m2m + gh * R;
  const T* m2i = row_m2i + gh * R;
  const T* m2d = row_m2d + gh * R;
  const T jj = T(j);

  // row 0: leftmost hap char; earlier read bases soft-clip at blc
  // (I of a row feeds no later row: the insert state is rebuilt from M by
  // the max-scan, so only M and D are carried)
  T m = (code == chars[0] ? c : w) + Cshj;
  T d = IMPOSSIBLE;
  if (j == lc) out[0] = m;

  auto flank_row = [&](int r) {
    sM[j] = m;
    sD[j] = d;
    __syncthreads();
    const T mprev = j ? sM[j - 1] : NEG;
    const T dprev = j ? sD[j - 1] : NEG;
    const T a = j ? mprev + T(kInsToMatch) : T(0);
    const T f = a - Cshj - jj * T(kInsToIns);
    const T cm = block_max_scan(f, wtot, NEG);
    const T i_new = Cj + jj * T(kInsToIns) + cm;
    sI[j] = i_new;
    __syncthreads();
    const T iprev = j ? sI[j - 1] : NEG;
    const T t = j ? xmax(iprev + m2i[r], xmax(mprev + m2m[r], dprev + m2d[r]))
                  : T(0);
    const T d_new = xmax(m + T(kDelToMatch), d + T(kDelToDel));
    m = (code == chars[r] ? c : w) + t;
    d = d_new;
    if (j == lc) out[static_cast<size_t>(r) * P] = m;
  };

  // phase 1: flank rows start1 .. sr-1 (1 .. start1-1 are bucket padding)
  for (int r = start1; r < sr; ++r) flank_row(r);

  // phase 2: the stutter row, an online log-sum-exp over artifact sizes
  sM[j] = m;
  __syncthreads();
  {
    const int opt = hap_opt[gh];
    const int sh = shift[gh];  // rep_len[opt] + D_min, may be negative
    const T* lp = lpmf_h + gh * nD;
    const size_t plane = static_cast<size_t>(P) * L;
    const T* Eh = E + (static_cast<size_t>(g) * O + opt) * nD * plane
                  + static_cast<size_t>(p) * L + j;
    T mx = NEG, sm = T(0);
    for (int dd = 0; dd < nD; ++dd) {
      const int s_d = sh + dd * period;
      int src = (j - s_d) % L;
      if (src < 0) src += L;
      const T ent = j >= s_d ? sM[src] : T(0);
      const T val = xmax(lp[dd] + Eh[dd * plane] + ent, IMPOSSIBLE);
      const T nm = xmax(mx, val);
      sm = sm * xexp(mx - nm) + xexp(val - nm);
      mx = nm;
    }
    m = mx + xlog(sm);
    d = IMPOSSIBLE;
    if (j == lc) out[static_cast<size_t>(sr) * P] = m;
  }
  __syncthreads();

  // forced-match row: the repeat block is left through a match
  if (sr + 1 < R) {
    sM[j] = m;
    __syncthreads();
    const T t = j ? sM[j - 1] : T(0);
    m = (code == chars[sr + 1] ? c : w) + t;
    if (j == lc) out[static_cast<size_t>(sr + 1) * P] = m;
    __syncthreads();
  }

  // phase 3: remaining flank rows (tail bucket padding skipped)
  for (int r = sr + 2; r < end3; ++r) flank_row(r);
}

template <typename T>
int launch(const void* const* a, void* Mcol, int G, int H, int P, int L,
           int R, int O, int nD, int sr, void* stream) {
  if (G == 0 || H == 0 || P == 0) return 0;
  dim3 grid(P, H, G);
  const size_t smem = (3 * L + 32) * sizeof(T);
  segment_kernel<T><<<grid, L, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const T*>(a[10]), static_cast<const int*>(a[11]),
      static_cast<const int*>(a[12]), static_cast<const T*>(a[13]),
      static_cast<const int*>(a[14]), static_cast<T*>(Mcol),
      H, P, L, R, O, nD, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SEGMENT_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d, const void* E,     \
      const void* hap_opt, const void* shift, const void* lpmf_h,           \
      const void* bounds, void* Mcol, int G, int H, int P, int L, int R,    \
      int O, int nD, int sr, void* stream) {                                \
    const void* a[15] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, E, hap_opt, shift, lpmf_h, bounds};      \
    return launch<T>(a, Mcol, G, H, P, L, R, O, nD, sr, stream);            \
  }

SEGMENT_ENTRY(segment_f32, float)
SEGMENT_ENTRY(segment_f64, double)
