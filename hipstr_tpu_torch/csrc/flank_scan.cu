// Flank-row scan of the per-locus forward DP (K4) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_hmm.py::_scan_kernel
// (wrapper flank_scan_pallas).  For one locus it advances the
// match/insert/delete state [P, H, L] (read pool p, haplotype h, read lane
// j) through n_rows flank rows (reference HapAligner.cpp:110-156).  A row
// whose active flag is 0 (bucket padding) passes the state through.  It
// writes M at the pool's last read column for every row, inactive rows
// included (the carried value): Mcol[r, p, h]; and the final M, I, D.
//
// What bounds it on the H100: latency of the serial row chain, as for K2.
// Each row is a handful of flops per lane plus an in-row max-scan and three
// block barriers, and rows cannot overlap.  Device-memory traffic is the
// [P, L] read slab, the state read once and written once, and n_rows
// scalars per block.  P*H blocks are in flight (2k-8k at the sequential
// path's shapes) to hide the chain's latency across the 132 SMs.
//
// Design: one block per (p, h), grid (P, H), one thread per lane
// (blockDim = L <= 512, a multiple of 32).  M, I and D live in registers
// for the whole scan; the row recurrence is dp_rows.cuh's flank_row (the
// one-lane shifts through shared memory, the insert recurrence as a block
// max-scan).  The TPU kernel's log-doubling rolls existed because Mosaic
// has no cummax.  The state makes one round trip through device memory
// between the two launches of an orientation (phase 1 and phase 3), as in
// the JAX package's flank mode.

#include "dp_rows.cuh"

namespace {

using dp::kMaxLanes;

template <typename T>
__global__ void __launch_bounds__(kMaxLanes) flank_scan_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const int* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const int* __restrict__ row_active, const T* __restrict__ M0,
    const T* __restrict__ I0, const T* __restrict__ D0,
    T* __restrict__ Mcol, T* __restrict__ Mout, T* __restrict__ Iout,
    T* __restrict__ Dout, int P, int H, int L, int n_rows) {
  const int p = blockIdx.x, h = blockIdx.y;
  const int j = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  const dp::RowScratch<T> s(reinterpret_cast<T*>(smem_raw), L);

  const size_t lane = static_cast<size_t>(p) * L + j;
  const int code = codes[lane];
  const T w = blw[lane], c = blc[lane], Cj = C[lane], Cshj = Csh[lane];
  const int lc = last_col[p];
  const size_t st = (static_cast<size_t>(p) * H + h) * L + j;
  T m = M0[st], i = I0[st], d = D0[st];
  T* out = Mcol + static_cast<size_t>(p) * H + h;  // row r at out[r * P * H]

  for (int r = 0; r < n_rows; ++r) {
    const size_t rh = static_cast<size_t>(r) * H + h;
    if (row_active[r]) {  // uniform across the block
      i = dp::flank_row(m, d, (code == row_char[rh] ? c : w), Cj, Cshj,
                        row_m2m[rh], row_m2i[rh], row_m2d[rh], s);
    }
    if (j == lc) out[static_cast<size_t>(r) * P * H] = m;
  }
  Mout[st] = m;
  Iout[st] = i;
  Dout[st] = d;
}

template <typename T>
int launch(const void* const* a, void* const* o, int P, int H, int L,
           int n_rows, void* stream) {
  if (P == 0 || H == 0) return 0;
  dim3 grid(P, H);
  flank_scan_kernel<T><<<grid, L, dp::RowScratch<T>::bytes(L),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const int*>(a[10]), static_cast<const T*>(a[11]),
      static_cast<const T*>(a[12]), static_cast<const T*>(a[13]),
      static_cast<T*>(o[0]), static_cast<T*>(o[1]), static_cast<T*>(o[2]),
      static_cast<T*>(o[3]), P, H, L, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLANK_SCAN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d,                    \
      const void* row_active, const void* M0, const void* I0,               \
      const void* D0, void* Mcol, void* Mout, void* Iout, void* Dout,       \
      int P, int H, int L, int n_rows, void* stream) {                      \
    const void* a[14] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, row_active, M0, I0, D0};                 \
    void* o[4] = {Mcol, Mout, Iout, Dout};                                  \
    return launch<T>(a, o, P, H, L, n_rows, stream);                        \
  }

FLANK_SCAN_ENTRY(flank_scan_f32, float)
FLANK_SCAN_ENTRY(flank_scan_f64, double)
