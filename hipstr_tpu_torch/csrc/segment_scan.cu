// Fused single-locus segment forward (K3) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_hmm.py::_segment_kernel
// (wrapper segment_scan_pallas).  For one locus and one orientation it
// runs the whole match/insert/delete DP of every (read pool p, haplotype
// h) in one launch (reference HapAligner.cpp:26-231): row 0 with
// soft-clip initialisation, the flank rows before the repeat, the
// collapsed stutter row (online log-sum-exp over nD artifact sizes), the
// forced-match row, the remaining flank rows.  A flank row whose active
// flag is 0 (bucket padding) passes the state through.  It writes M at
// the pool's last read column for every row, inactive rows included (the
// carried value): Mcol[r, p, h].  Bucket-padding haplotypes are computed
// like real ones (the caller slices them off).
//
// What bounds it on the H100: latency of the serial row chain, as for K2
// and K4.  Device-memory traffic is the [P, L] read slab, the nD emission
// planes of the haplotype's repeat option, and R scalars per block; the
// state never leaves the SM.
//
// Design: one block per (p, h), grid (P, H), one thread per lane
// (blockDim = L <= 512, a multiple of 32); the row recurrences are
// dp_rows.cuh's.  The stutter row reads M_prev[(j - s_d) mod L] through
// shared memory with s_d = shift[h] + d * period (may be negative), and
// 0.0 where j < s_d, as the TPU kernel's circular rolls do.  The TPU
// kernel's binary-decomposed rolls, one-hot option select and per-artifact
// accumulator existed because Mosaic has no gather: here each block reads
// its haplotype's option hap_opt[h] directly.  E stays in the emission
// kernel's layout [O, nD, P, L].  IEEE exp/log: no fast math.

#include "dp_rows.cuh"

namespace {

using dp::kMaxLanes;

template <typename T>
__global__ void __launch_bounds__(kMaxLanes) segment_scan_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const int* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const int* __restrict__ row_active, const T* __restrict__ E,
    const int* __restrict__ hap_opt, const int* __restrict__ shift,
    const T* __restrict__ lpmf_h, T* __restrict__ Mcol, int P, int H,
    int L, int R, int nD, int sr, int period) {
  const int p = blockIdx.x, h = blockIdx.y;
  const int j = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  const dp::RowScratch<T> s(reinterpret_cast<T*>(smem_raw), L);

  const size_t lane = static_cast<size_t>(p) * L + j;
  const int code = codes[lane];
  const T w = blw[lane], c = blc[lane], Cj = C[lane], Cshj = Csh[lane];
  const int lc = last_col[p];
  const size_t hr = static_cast<size_t>(h) * R;  // row r of h at hr + r
  T* out = Mcol + static_cast<size_t>(p) * H + h;  // row r at out[r * P * H]
  const size_t row_stride = static_cast<size_t>(P) * H;

  // row 0: leftmost hap char; earlier read bases soft-clip at blc
  T m = (code == row_char[hr] ? c : w) + Cshj;
  T d = T(dp::kImpossible);
  if (j == lc) out[0] = m;

  auto flank_row = [&](int r) {
    if (row_active[r]) {  // uniform across the block
      dp::flank_row(m, d, (code == row_char[hr + r] ? c : w), Cj, Cshj,
                    row_m2m[hr + r], row_m2i[hr + r], row_m2d[hr + r], s);
    }
    if (j == lc) out[r * row_stride] = m;
  };

  // phase 1: flank rows 1 .. sr-1
  for (int r = 1; r < sr; ++r) flank_row(r);

  // the stutter row
  const size_t plane = static_cast<size_t>(P) * L;
  const T* Eh = E + static_cast<size_t>(hap_opt[h]) * nD * plane + lane;
  dp::stutter_row(m, Eh, plane, lpmf_h + static_cast<size_t>(h) * nD,
                  shift[h], period, nD, L, s);
  d = T(dp::kImpossible);
  if (j == lc) out[sr * row_stride] = m;

  // forced-match row after the repeat block
  if (sr + 1 < R) {
    dp::forced_match_row(m, (code == row_char[hr + sr + 1] ? c : w), s);
    if (j == lc) out[(sr + 1) * row_stride] = m;
  }

  // phase 3: remaining flank rows
  for (int r = sr + 2; r < R; ++r) flank_row(r);
}

template <typename T>
int launch(const void* const* a, void* Mcol, int P, int H, int L, int R,
           int nD, int sr, int period, void* stream) {
  if (P == 0 || H == 0) return 0;
  dim3 grid(P, H);
  segment_scan_kernel<T><<<grid, L, dp::RowScratch<T>::bytes(L),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const int*>(a[10]), static_cast<const T*>(a[11]),
      static_cast<const int*>(a[12]), static_cast<const int*>(a[13]),
      static_cast<const T*>(a[14]), static_cast<T*>(Mcol), P, H, L, R, nD,
      sr, period);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SEGMENT_SCAN_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d,                    \
      const void* row_active, const void* E, const void* hap_opt,           \
      const void* shift, const void* lpmf_h, void* Mcol, int P, int H,      \
      int L, int R, int nD, int sr, int period, void* stream) {             \
    const void* a[15] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, row_active, E, hap_opt, shift, lpmf_h};  \
    return launch<T>(a, Mcol, P, H, L, R, nD, sr, period, stream);          \
  }

SEGMENT_SCAN_ENTRY(segment_scan_f32, float)
SEGMENT_SCAN_ENTRY(segment_scan_f64, double)
