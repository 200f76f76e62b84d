// Flank-row scan of the per-locus forward DP (K4) for sm_90a.
//
// Replaces the TPU kernel hipstr_tpu/ops/pallas_hmm.py::_scan_kernel
// (wrapper flank_scan_pallas).  For one locus it advances the
// match/insert/delete state [P, H, L] (read pool p, haplotype h, read lane
// j) through n_rows flank rows (reference HapAligner.cpp:110-156).  A row
// whose active flag is 0 (bucket padding) passes the state through, I
// included.  It writes M at the pool's last read column for every row,
// inactive rows included (the carried value): Mcol[r, p, h]; and the final
// M, I, D.
//
// What bounds it on the H100: counted, bytes (the state read once and
// written once, the [P, L] read slab, Mcol), a few microseconds at the
// sequential path's shapes.  What its time follows is the latency of one
// serial chain of up to 224 rows per (p, h), each row a handful of
// dependent operations per lane and an in-row max-scan.  The first design
// ran a block of L threads per chain, paid three block barriers per row and
// read each row's char and transitions from device memory inside the chain.
//
// Design: one warp per (p, h) chain on dp_warp.cuh's rows.  Thread t holds
// lanes t*V .. t*V+V-1 (V = L/32) of M, I and D in registers for the whole
// scan, so a flank row has no barrier and touches no shared memory.  A block
// holds W warps on consecutive h of one p (ops/hmm_scan.scan_chain is the
// map, ops/hmm_scan.scan_geometry picks W): h is the fastest axis of the
// state [P, H, L] and of Mcol [n_rows, P, H], so the block's state is one
// contiguous range and each row's W last-column values one contiguous run.
// Before the row loop the block stages its [n_rows][W] transitions (with
// cp.async), row chars and the n_rows active flags into shared memory; the
// row loop reads nothing from device memory.  The rows come as the caller
// holds them (int8 chars, bool flags, any strides: the per-locus path
// passes transposed slices of its [H, R] rows), so a launch needs no
// conversion kernels beside it.  Each row's last-column M goes into a
// shared [n_rows][W] tile written out at the end.  The per-lane read
// constants live in registers, or in a per-warp shared slab for float64 at
// L > 256 where registers would spill.  The state makes one round trip
// through device memory between the two launches of an orientation (phase 1
// and phase 3), as in the JAX package's flank mode.

#include "dp_warp.cuh"

namespace {

constexpr int kMaxWarps = 8;

// Shared memory of one block, in the order the kernel carves it; the same
// sum as ops/hmm_scan.scan_smem("flank_scan", ...).
template <typename T, int V, bool kShared>
size_t smem_bytes(int W, int n_rows) {
  const size_t rw = static_cast<size_t>(n_rows) * W;
  return W * dpw::Lanes<T, V, kShared>::slab_bytes()  // lane constants
         + 4 * rw * sizeof(T)      // Mcol tile, three transition rows
         + (rw + n_rows) * sizeof(int);  // row chars, active flags
}

template <typename T, int V, bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) flank_scan_kernel(
    const int* __restrict__ codes, const T* __restrict__ blw,
    const T* __restrict__ blc, const T* __restrict__ C,
    const T* __restrict__ Csh, const int* __restrict__ last_col,
    const signed char* __restrict__ row_char, const T* __restrict__ row_m2m,
    const T* __restrict__ row_m2i, const T* __restrict__ row_m2d,
    const unsigned char* __restrict__ row_active, const T* __restrict__ M0,
    const T* __restrict__ I0, const T* __restrict__ D0,
    T* __restrict__ Mcol, T* __restrict__ Mout, T* __restrict__ Iout,
    T* __restrict__ Dout, int P, int H, int n_rows, int rs, int hs, int W) {
  constexpr int L = 32 * V;
  constexpr size_t kSlab = dpw::Lanes<T, V, kShared>::slab_bytes();
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  // the chain of ops/hmm_scan.scan_chain: block (x, y) runs h0 .. h0+W-1
  // of pool y, warp w haplotype h0 + w
  const int p = blockIdx.y, h0 = blockIdx.x * W, h = h0 + w;
  const int wn = min(W, H - h0);  // warps of this block with a haplotype
  const size_t rw = static_cast<size_t>(n_rows) * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* slab = smem_raw + w * kSlab;
  T* sOut = reinterpret_cast<T*>(smem_raw + W * kSlab);  // [n_rows][W]
  T* sM2M = sOut + rw;                                    // [n_rows][W]
  T* sM2I = sM2M + rw;
  T* sM2D = sM2I + rw;
  int* sChar = reinterpret_cast<int*>(sM2D + rw);         // [n_rows][W]
  int* sAct = sChar + rw;                                 // [n_rows]

  // the block's rows: element (r, h) of a row array at r * rs + h * hs in
  // device memory, row r of haplotype h0 + k at [r * W + k] here; the
  // index walks the axis of unit stride fastest, so reads coalesce
  const bool r_fast = rs < hs;
  for (int i = threadIdx.x; i < n_rows * wn; i += blockDim.x) {
    const int r = r_fast ? i % n_rows : i / wn;
    const int k = r_fast ? i / n_rows : i % wn;
    const size_t src = static_cast<size_t>(r) * rs
                       + static_cast<size_t>(h0 + k) * hs;
    const int dst = r * W + k;
    dpw::cp_async<sizeof(T)>(sM2M + dst, row_m2m + src);
    dpw::cp_async<sizeof(T)>(sM2I + dst, row_m2i + src);
    dpw::cp_async<sizeof(T)>(sM2D + dst, row_m2d + src);
    sChar[dst] = row_char[src];
  }
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    sAct[r] = row_active[r];
  }
  dpw::cp_async_commit();
  dpw::cp_async_wait<0>();
  __syncthreads();

  if (w < wn) {
    dpw::Lanes<T, V, kShared> ln;
    ln.load(codes, blw, blc, C, Csh, static_cast<size_t>(p) * L + t * V,
            slab);
    const int lc = last_col[p];
    T jk[V];  // j * ins2ins of the thread's lanes
#pragma unroll
    for (int v = 0; v < V; ++v) jk[v] = T(t * V + v) * T(dpw::kInsToIns);
    const size_t st = (static_cast<size_t>(p) * H + h) * L + t * V;
    T m[V], i[V], d[V];
    dpw::load_lanes<T, V>(m, M0 + st);
    dpw::load_lanes<T, V>(i, I0 + st);
    dpw::load_lanes<T, V>(d, D0 + st);
    for (int r = 0; r < n_rows; ++r) {
      const int k = r * W + w;
      if (sAct[r]) {  // uniform across the block
        dpw::flank_row<T, V>(m, d, i, ln, jk, sChar[k], sM2M[k], sM2I[k],
                             sM2D[k]);
      }
      dpw::keep_col<T, V>(m, lc, sOut + k);
    }
    dpw::store_lanes<T, V>(Mout + st, m);
    dpw::store_lanes<T, V>(Iout + st, i);
    dpw::store_lanes<T, V>(Dout + st, d);
  }

  __syncthreads();
  // row r of haplotype h0 + k at out[r * P * H + k]
  T* out = Mcol + static_cast<size_t>(p) * H + h0;
  const size_t row_stride = static_cast<size_t>(P) * H;
  for (int i = threadIdx.x; i < n_rows * wn; i += blockDim.x) {
    const int r = i / wn, k = i % wn;
    out[r * row_stride + k] = sOut[r * W + k];
  }
}

template <typename T, int V, bool kShared>
int launch_v(const void* const* a, void* const* o, int P, int H, int n_rows,
             int rs, int hs, int W, int smem, cudaStream_t stream) {
  auto kern = flank_scan_kernel<T, V, kShared>;
  if (smem_bytes<T, V, kShared>(W, n_rows) > static_cast<size_t>(smem)) {
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
      static_cast<const T*>(a[11]), static_cast<const T*>(a[12]),
      static_cast<const T*>(a[13]), static_cast<T*>(o[0]),
      static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
      P, H, n_rows, rs, hs, W);
  return static_cast<int>(cudaGetLastError());
}

// lane constants in shared memory for float64 past 8 lanes a thread (L > 256)
template <typename T>
int launch(const void* const* a, void* const* o, int P, int H, int L,
           int n_rows, int rs, int hs, int W, int smem, void* stream) {
  if (P == 0 || H == 0) return 0;
  if (W < 1 || W > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kWide = sizeof(T) == 8;
  switch (L) {
    case 64: return launch_v<T, 2, false>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    case 128: return launch_v<T, 4, false>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    case 192: return launch_v<T, 6, false>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    case 256: return launch_v<T, 8, false>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    case 384: return launch_v<T, 12, kWide>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    case 512: return launch_v<T, 16, kWide>(a, o, P, H, n_rows, rs, hs, W, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FLANK_SCAN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                      \
      const void* codes, const void* blw, const void* blc, const void* C,   \
      const void* Csh, const void* last_col, const void* row_char,          \
      const void* m2m, const void* m2i, const void* m2d,                    \
      const void* row_active, const void* M0, const void* I0,               \
      const void* D0, void* Mcol, void* Mout, void* Iout, void* Dout,       \
      int P, int H, int L, int n_rows, int rs, int hs, int W, int smem,     \
      void* stream) {                                                       \
    const void* a[14] = {codes, blw, blc, C, Csh, last_col, row_char, m2m,  \
                         m2i, m2d, row_active, M0, I0, D0};                 \
    void* o[4] = {Mcol, Mout, Iout, Dout};                                  \
    return launch<T>(a, o, P, H, L, n_rows, rs, hs, W, smem, stream);       \
  }

FLANK_SCAN_ENTRY(flank_scan_f32, float)
FLANK_SCAN_ENTRY(flank_scan_f64, double)
