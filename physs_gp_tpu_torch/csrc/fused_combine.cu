// Fused associative combines of the parallel Kalman filter and smoother for
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of physs_gp_tpu/ops/pallas/fused_combine.py:
//   fused_filter_{tiled,block}_kernel  <- _combine_kernel   (fused_filtering_combine)
//   fused_smooth_{tiled,block}_kernel  <- _smoothing_kernel (fused_smoothing_combine)
//
// Filtering combine (ei earlier, ej later):
//   U   = (I + C_i J_j)^-1             unpivoted Gauss-Jordan, as on the TPU
//   A   = A_j U A_i
//   b   = b_j + A_j U (b_i + C_i eta_j)
//   C   = sym(A_j U C_i A_j^T + C_j)
//   W   = U A_i
//   eta = eta_i + W^T (eta_j - J_j b_i)
//   J   = sym(J_i + W^T J_j A_i)
// Smoothing combine (ej later suffix, ei earlier):
//   E = E_i E_j,  g = g_i + E_i g_j,  L = sym(L_i + E_i L_j E_i^T)
//
// The TPU kernels put the batch on the 128 vector lanes ([d, d, B] layout,
// padded with identities to a lane multiple). Here one block takes one pair of
// elements: every operand is read once from its [N, d, d] / [N, d] row-major
// place (batch and row strides are arguments, so the blocked scan's strided
// views and its stride-0 identity carry need no copy), every product, the
// inverse and both symmetrisations run out of shared memory and registers,
// and only the results go back to device memory: one launch per combine.
//
// What bounds them on this card: the scans call them at batch 256 (the
// sequential pass over the blocks) and 128 (the Sklansky levels), d = 32. That
// is 9.6 MB of operands and results and 0.15 GFLOP for the filtering combine,
// 3 us of bytes and 2 us of operations at the card's rates; but a pair is a
// chain of dependent steps (an inverse of d pivots, then three levels of
// products), and with one or two blocks per SM nothing hides its latency. So
// the chain's length, and the instructions and shared-memory words in each
// link, set the time.
//
// Tiled route, 3 <= d <= 32 (the main path): four warps per pair, the problem
// padded to 32 (zeros in the products, the identity in the inverse), so no
// load or loop tests d and no index needs a runtime division.
//   - Staging: the six matrices and four vectors go to [32][pitch] tiles
//     (tiles.cuh) with cp.async, 16 bytes at a time for an operand whose base,
//     batch stride and row stride allow it (decided per operand by the
//     wrapper), one element at a time otherwise; rows and columns past d are
//     zero-filled.
//   - Products: bmm_kernel's register tiles (tile_product, the same inner
//     loop): 64 threads per 32 x 32 product, a 4 x 4 tile of the result per
//     thread, 16-byte shared loads (0.125 per multiply-add in f32, against
//     two in a scalar loop). Two independent products share each barrier
//     interval, warps 0-1 on one and warps 2-3 on the other.
//   - Inverse: gj_warp_kernel's layout in warp 0 (warp_inverse): lane j
//     holds column j of M and of X = I in registers, one __syncwarp per
//     pivot and no block barrier inside the elimination; the other warps
//     form the two vectors that need b_i and eta_j meanwhile. U is kept
//     explicit, as the TPU kernel and the plain version form it.
//   - Code size: every piece runs once per pair, so a fully unrolled loop is
//     fetched once per pair and the fetch, not the arithmetic, sets its pace
//     (the fully unrolled kernel is 1.6x slower; PERF.md, section 6). The
//     elimination keeps its rows rotated so that its loop needs no unrolling
//     for static register indices; the products' contraction loop is
//     unrolled twice.
//   - Schedule, one block barrier between levels:
//       L0  M = I + C_i J_j            || K = J_j A_i
//       L1  U = M^-1 (warp 0)          || u = b_i + C_i eta_j, w = eta_j - J_j b_i
//       L2  P = A_j U                  || W = U A_i
//       L3  A = P A_i (stored)         || X = P C_i;  b = b_j + P u, eta = eta_i + W^T w
//       L4  X A_j^T + C_j              || W^T K + J_i
//       L5  both symmetrised, out through shared memory in 16-byte stores
//     and for the smoothing combine
//       L0  E = E_i E_j (stored)       || S = E_i L_j;  g = g_i + E_i g_j
//       L1  S E_i^T + L_i over all four warps (2 x 4 tiles)
//       L2  symmetrised store.
//   Sums over the contraction index run in order, as in the plain version.
// Block route, d > 32 (off the main path; a lane cannot hold a column): one
// block of up to 256 threads per pair with every matrix in shared memory at a
// row pitch of d + 1 words, d pivots of two block barriers each, scalar
// products (the first design of this port).
//
// No pivoting and no pivot floor, exactly as on the TPU: I + C_i J_j is
// identity-dominated (it is exactly I for the identity element and for a
// chunk's first element).

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::Pack;

template <typename T>
struct FilterArgs {
  // in: Ai, bi, Ci, Ji, etai, Aj, bj, Cj, Jj, etaj; out: A, b, C, J, eta
  const T* in[10];
  long long sb[10];  // batch strides, in elements
  long long sr[10];  // row strides of the matrices
  T* out[5];
};

template <typename T>
struct SmoothArgs {
  // in: Ej, gj, Lj, Ei, gi, Li; out: E, g, L
  const T* in[6];
  long long sb[6];
  long long sr[6];
  T* out[3];
};

// ---------------------------------------------------------------------------
// Tiled route (3 <= d <= 32)
// ---------------------------------------------------------------------------
constexpr int TILED_THREADS = 128;

// Stage vector number `slot` (d elements at src) into s, zero-padded to 32,
// with the 32 / W threads from slot * 32 / W on.
template <typename T>
__device__ __forceinline__ void stage_vec(T* s, const T* src, int d, bool vec, int slot,
                                          int tid) {
  constexpr int W = Pack<T>::W;
  const unsigned g = (unsigned)(tid - slot * (32 / W));
  if (g < 32 / W) tiles::stage_group(s + g * W, src + g * W, min(W, d - (int)(g * W)), vec);
}

// 4 consecutive elements from a 16-byte aligned shared-memory address.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&out)[4]) {
  constexpr int W = Pack<T>::W;
#pragma unroll
  for (int q = 0; q < 4 / W; ++q) {
    const Pack<T> v = *reinterpret_cast<const Pack<T>*>(p + q * W);
#pragma unroll
    for (int e = 0; e < W; ++e) out[q * W + e] = v.v[e];
  }
}

// acc[r][c] += sum_l op(A)[row r, l] op(B)[l, column c] over the 32
// contraction steps in order, for this thread's R rows and 4 columns (bmm's
// register tile: 16-byte shared loads, 0.125 per multiply-add in f32 at
// R = 4). a_s points at the thread's first row (TA: column R ti of the
// stored [k][m] tile; else row R ti), b_s at its first column (TB: row tj of
// the stored [n][k] tile, the columns then being tj + 8 c; else column 4 tj).
// The loop is unrolled twice, not 16 or 8 times: each product is executed
// once per pair, so its code is fetched once per pair, and a short loop
// stays in the instruction cache. It is bmm_kernel's inner loop, kept apart
// from it: moving that loop into a header both kernels include changed
// bmm_kernel's compiled code and its time (PERF.md, section 6).
template <typename T, bool TA, bool TB, int R>
__device__ __forceinline__ void tile_product(const T* a_s, const T* b_s, int pitch,
                                             T (&acc)[R][4]) {
  constexpr int W = Pack<T>::W;
  static_assert(R == 4 || !TA, "a transposed A is read 4 rows at a time");
#pragma unroll 2
  for (int l0 = 0; l0 < 32; l0 += W) {
    T a[R][W], bb[W][4];
    if (TA) {  // stored [k][m]: R rows of the result from one contraction row
#pragma unroll
      for (int l = 0; l < W; ++l) {
        T v[4];
        load4(a_s + (l0 + l) * pitch, v);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r][l] = v[r];
      }
    } else {  // stored [m][k]: 16 bytes of the contraction per row of the result
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Pack<T> v = *reinterpret_cast<const Pack<T>*>(a_s + r * pitch + l0);
#pragma unroll
        for (int l = 0; l < W; ++l) a[r][l] = v.v[l];
      }
    }
    if (TB) {  // stored [n][k]: 16 bytes of the contraction per column
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const Pack<T> v = *reinterpret_cast<const Pack<T>*>(b_s + 8 * c * pitch + l0);
#pragma unroll
        for (int l = 0; l < W; ++l) bb[l][c] = v.v[l];
      }
    } else {  // stored [k][n]: 4 columns from one contraction row
#pragma unroll
      for (int l = 0; l < W; ++l) load4(b_s + (l0 + l) * pitch, bb[l]);
    }
#pragma unroll
    for (int l = 0; l < W; ++l)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r][l] * bb[l][c];
  }
}

// acc = op(A) op(B) for thread t (0 .. 63) of a product of two [32][pitch]
// tiles: rows 4 (t >> 3) .. + 3; columns 4 (t & 7) .. + 3, or (t & 7) + 8 c
// when TB.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void product(const T* A, const T* B, int pitch, int t,
                                        T (&acc)[4][4]) {
  const int ti = t >> 3, tj = t & 7;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
  tile_product<T, TA, TB, 4>(A + (TA ? 4 * ti : 4 * ti * pitch), B + (TB ? tj * pitch : 4 * tj),
                             pitch, acc);
}

// X <- M^-1 X by unpivoted Gauss-Jordan in one warp, gj_warp_kernel's
// layout: lane j holds column j of M in x and of X in y. The rows are kept
// rotated so that the pivot row is always register 0: at step k, lane k
// publishes its column (1 / pivot in slot 0, the multipliers below) as row k
// of the [32][32] history H; after one __syncwarp every lane scales its
// pivot entry, updates the other 31 rows, and moves the pivot row to
// register 31. So every register index is static and the loop over k need
// not be unrolled (a fully unrolled elimination is some 4000 instructions
// executed once per pair, fetched faster than it runs). After 32 steps the
// rows are back in order; for d < 32 the last steps act on the identity
// padding and change nothing.
template <typename T>
__device__ __forceinline__ void warp_inverse(T (&x)[32], T (&y)[32], T* H, int lane) {
  constexpr int W = Pack<T>::W;
#pragma unroll 4
  for (int k = 0; k < 32; ++k) {
    T* h = H + k * 32;
    if (lane == k) {
      const T inv = T(1) / x[0];
#pragma unroll
      for (int q = 0; q < 32 / W; ++q) {
        Pack<T> p;
#pragma unroll
        for (int e = 0; e < W; ++e) p.v[e] = q * W + e == 0 ? inv : x[q * W + e];
        *reinterpret_cast<Pack<T>*>(h + q * W) = p;
      }
    }
    __syncwarp();
    T c[32];
#pragma unroll
    for (int q = 0; q < 32 / W; ++q) {
      const Pack<T> p = *reinterpret_cast<const Pack<T>*>(h + q * W);
#pragma unroll
      for (int e = 0; e < W; ++e) c[q * W + e] = p.v[e];
    }
    const T xk = x[0] * c[0], yk = y[0] * c[0];
#pragma unroll
    for (int i = 0; i < 31; ++i) {
      x[i] = x[i + 1] - c[i + 1] * xk;
      y[i] = y[i + 1] - c[i + 1] * yk;
    }
    x[31] = xk;
    y[31] = yk;
  }
}

// Thread t's tile of a product with untransposed B into the [32][pitch] tile
// S, in 16-byte stores (the 8 threads of a quarter warp cover one row).
template <typename T>
__device__ __forceinline__ void put_tile(T* S, int pitch, int t, const T (&acc)[4][4]) {
  constexpr int W = Pack<T>::W;
  const int ti = t >> 3, tj = t & 7;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4 / W; ++q) {
      Pack<T> v;
#pragma unroll
      for (int e = 0; e < W; ++e) v.v[e] = acc[r][q * W + e];
      *reinterpret_cast<Pack<T>*>(S + (4 * ti + r) * pitch + 4 * tj + q * W) = v;
    }
}

// Thread t's tile of a product with untransposed B into the contiguous
// [d, d] matrix out: 16-byte stores when d is a multiple of 16 bytes' worth
// of elements (every row then starts 16-byte aligned), else one element each.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, int d, int t, const T (&acc)[4][4]) {
  constexpr int W = Pack<T>::W;
  const int ti = t >> 3, tj = t & 7;
  const bool packed = (d & (W - 1)) == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ti + r;
    if (i >= d) break;
#pragma unroll
    for (int q = 0; q < 4 / W; ++q) {
      const int j0 = 4 * tj + q * W;
      if (packed) {
        if (j0 < d) {
          Pack<T> v;
#pragma unroll
          for (int e = 0; e < W; ++e) v.v[e] = acc[r][q * W + e];
          *reinterpret_cast<Pack<T>*>(out + i * d + j0) = v;
        }
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e)
          if (j0 + e < d) out[i * d + j0 + e] = acc[r][q * W + e];
      }
    }
  }
}

// out[i, j] = (S[i, j] + S[j, i]) / 2 for i, j < d, out contiguous [d, d],
// by the block's threads: 16-byte stores when rows allow them.
template <typename T>
__device__ __forceinline__ void store_sym(T* out, const T* S, int pitch, int d, int tid) {
  constexpr unsigned W = Pack<T>::W, G = 32 / W;  // 16-byte groups per padded row
  if ((d & (W - 1)) == 0) {
    for (unsigned p = tid; p < d * G; p += TILED_THREADS) {
      const unsigned i = p / G, c0 = (p % G) * W;
      if (c0 >= (unsigned)d) continue;
      Pack<T> v;
#pragma unroll
      for (unsigned e = 0; e < W; ++e)
        v.v[e] = T(0.5) * (S[i * pitch + c0 + e] + S[(c0 + e) * pitch + i]);
      *reinterpret_cast<Pack<T>*>(out + i * d + c0) = v;
    }
  } else {
    for (unsigned p = tid; p < d * 32u; p += TILED_THREADS) {
      const unsigned i = p >> 5, j = p & 31;
      if (j < (unsigned)d) out[i * d + j] = T(0.5) * (S[i * pitch + j] + S[j * pitch + i]);
    }
  }
}

// sum_k row[k] x[k] over the 32 (zero-padded) columns, in order: 16 bytes of
// the row and of x per step. Lane i reading row i: a quarter warp reads 8
// neighbouring rows, which the pitch puts on distinct banks.
template <typename T>
__device__ __forceinline__ T row_dot(const T* row, const T* x) {
  constexpr int W = Pack<T>::W;
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < 32 / W; ++q) {
    const Pack<T> a = *reinterpret_cast<const Pack<T>*>(row + q * W);
    const Pack<T> v = *reinterpret_cast<const Pack<T>*>(x + q * W);
#pragma unroll
    for (int e = 0; e < W; ++e) acc += a.v[e] * v.v[e];
  }
  return acc;
}

// sum_k S[k, col] x[k], in order (lane col: neighbouring words at each k).
template <typename T>
__device__ __forceinline__ T col_dot(const T* S, int pitch, int col, const T* x) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 32; ++k) acc += S[k * pitch + col] * x[k];
  return acc;
}

// Filtering combine, one pair per block of 128 threads. Shared memory: ten
// [32][pitch] tiles and six vectors of 32; `vec` bit q: input q may be staged
// 16 bytes at a time.
template <typename T>
__global__ void __launch_bounds__(TILED_THREADS)
fused_filter_tiled_kernel(const FilterArgs<T> args, int d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = tiles::row_pitch<T>(32), mat = 32 * pitch;
  T* sAi = reinterpret_cast<T*>(smem_raw);
  T* sCi = sAi + mat;
  T* sJi = sCi + mat;  // J_i, then J before symmetrisation
  T* sAj = sJi + mat;
  T* sCj = sAj + mat;  // C_j, then C before symmetrisation
  T* sJj = sCj + mat;
  T* sM = sJj + mat;   // I + C_i J_j, then the elimination's history, then P = A_j U
  T* sK = sM + mat;    // J_j A_i
  T* sU = sK + mat;    // U, then X = A_j U C_i
  T* sW = sU + mat;    // W = U A_i
  T* vbi = sW + mat;
  T* vetai = vbi + 32;
  T* vbj = vetai + 32;
  T* vetaj = vbj + 32;
  T* vu = vetaj + 32;  // u = b_i + C_i eta_j
  T* vw = vu + 32;     // w = eta_j - J_j b_i
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = tid >> 6, t = tid & 63;
  const long long b = blockIdx.x;
  const long long dd = (long long)d * d;

  const T* g[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) g[q] = args.in[q] + b * args.sb[q];
  T* const mats[6] = {sAi, sCi, sJi, sAj, sCj, sJj};
  const int mat_in[6] = {0, 2, 3, 5, 7, 8};
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int q = mat_in[m];
    tiles::stage_warp<T, 32, TILED_THREADS>(mats[m], pitch, g[q], args.sr[q], d, d,
                                            (vec >> q) & 1, tid);
  }
  stage_vec(vbi, g[1], d, (vec >> 1) & 1, 0, tid);
  stage_vec(vetai, g[4], d, (vec >> 4) & 1, 1, tid);
  stage_vec(vbj, g[6], d, (vec >> 6) & 1, 2, tid);
  stage_vec(vetaj, g[9], d, (vec >> 9) & 1, 3, tid);
  tiles::cp_async_wait_all();
  __syncthreads();

  T acc[4][4];
  // L0: M = I + C_i J_j || K = J_j A_i
  if (half == 0) {
    product<T, false, false>(sCi, sJj, pitch, t, acc);
    if ((t >> 3) == (t & 7)) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][r] += T(1);
    }
    put_tile(sM, pitch, t, acc);
  } else {
    product<T, false, false>(sJj, sAi, pitch, t, acc);
    put_tile(sK, pitch, t, acc);
  }
  __syncthreads();

  // L1: U = M^-1 in warp 0 || u, w
  if (warp == 0) {
    T x[32], y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = sM[i * pitch + lane];
      y[i] = i == lane ? T(1) : T(0);
    }
    __syncwarp();  // M is in registers: its tile takes the history
    warp_inverse(x, y, sM, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) sU[i * pitch + lane] = y[i];
  } else if (warp == 1) {
    vu[lane] = vbi[lane] + row_dot(sCi + lane * pitch, vetaj);
  } else if (warp == 2) {
    vw[lane] = vetaj[lane] - row_dot(sJj + lane * pitch, vbi);
  }
  __syncthreads();

  // L2: P = A_j U || W = U A_i
  if (half == 0) {
    product<T, false, false>(sAj, sU, pitch, t, acc);
    put_tile(sM, pitch, t, acc);
  } else {
    product<T, false, false>(sU, sAi, pitch, t, acc);
    put_tile(sW, pitch, t, acc);
  }
  __syncthreads();

  // L3: A = P A_i || X = P C_i; then b and eta
  if (half == 0) {
    product<T, false, false>(sM, sAi, pitch, t, acc);
    store_tile(args.out[0] + b * dd, d, t, acc);
  } else {
    product<T, false, false>(sM, sCi, pitch, t, acc);
    put_tile(sU, pitch, t, acc);
  }
  if (warp == 1 && lane < d) {
    args.out[1][b * d + lane] = vbj[lane] + row_dot(sM + lane * pitch, vu);
  } else if (warp == 3 && lane < d) {
    args.out[4][b * d + lane] = vetai[lane] + col_dot(sW, pitch, lane, vw);
  }
  __syncthreads();

  // L4: C = X A_j^T + C_j into C_j's tile || J = W^T K + J_i into J_i's
  if (half == 0) {
    product<T, false, true>(sU, sAj, pitch, t, acc);
    const int ti = t >> 3, tj = t & 7;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T* p = sCj + (4 * ti + r) * pitch + tj + 8 * c;
        *p = acc[r][c] + *p;
      }
  } else {
    product<T, true, false>(sW, sK, pitch, t, acc);
    const int ti = t >> 3, tj = t & 7;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T* p = sJi + (4 * ti + r) * pitch + 4 * tj + c;
        *p = acc[r][c] + *p;
      }
  }
  __syncthreads();

  // L5
  store_sym(args.out[2] + b * dd, sCj, pitch, d, tid);
  store_sym(args.out[3] + b * dd, sJi, pitch, d, tid);
}

// Smoothing combine, one pair per block of 128 threads. Shared memory: five
// [32][pitch] tiles and two vectors of 32.
template <typename T>
__global__ void __launch_bounds__(TILED_THREADS)
fused_smooth_tiled_kernel(const SmoothArgs<T> args, int d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = tiles::row_pitch<T>(32), mat = 32 * pitch;
  T* sEj = reinterpret_cast<T*>(smem_raw);
  T* sLj = sEj + mat;
  T* sEi = sLj + mat;
  T* sLi = sEi + mat;  // L_i, then L before symmetrisation
  T* sS = sLi + mat;   // S = E_i L_j
  T* vgj = sS + mat;
  T* vgi = vgj + 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = tid >> 6, t = tid & 63;
  const long long b = blockIdx.x;
  const long long dd = (long long)d * d;

  const T* g[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) g[q] = args.in[q] + b * args.sb[q];
  T* const mats[4] = {sEj, sLj, sEi, sLi};
  const int mat_in[4] = {0, 2, 3, 5};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int q = mat_in[m];
    tiles::stage_warp<T, 32, TILED_THREADS>(mats[m], pitch, g[q], args.sr[q], d, d,
                                            (vec >> q) & 1, tid);
  }
  stage_vec(vgj, g[1], d, (vec >> 1) & 1, 0, tid);
  stage_vec(vgi, g[4], d, (vec >> 4) & 1, 1, tid);
  tiles::cp_async_wait_all();
  __syncthreads();

  // L0: E = E_i E_j (stored) || S = E_i L_j; then g
  {
    T acc[4][4];
    if (half == 0) {
      product<T, false, false>(sEi, sEj, pitch, t, acc);
      store_tile(args.out[0] + b * dd, d, t, acc);
    } else {
      product<T, false, false>(sEi, sLj, pitch, t, acc);
      put_tile(sS, pitch, t, acc);
    }
  }
  if (warp == 1 && lane < d) args.out[1][b * d + lane] = vgi[lane] + row_dot(sEi + lane * pitch, vgj);
  __syncthreads();

  // L1: L = S E_i^T + L_i into L_i's tile, 2 x 4 tiles over all 128 threads:
  // rows 2 (tid >> 3) .. + 1, columns (tid & 7) + 8 c
  {
    const int ti = tid >> 3, tj = tid & 7;
    T acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
    tile_product<T, false, true, 2>(sS + 2 * ti * pitch, sEi + tj * pitch, pitch, acc);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T* p = sLi + (2 * ti + r) * pitch + tj + 8 * c;
        *p = acc[r][c] + *p;
      }
  }
  __syncthreads();

  // L2
  store_sym(args.out[2] + b * dd, sLi, pitch, d, tid);
}

// ---------------------------------------------------------------------------
// Block route (d > 32)
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load_mat(T* S, const T* G, long long sr, int d, int ld) {
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    S[i * ld + j] = G[(long long)i * sr + j];
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(T* s, const T* g, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) s[i] = g[i];
}

// put(i, j, sum_k op(A)[i, k] op(B)[k, j]) for every (i, j); A, B in shared
// memory with row pitch ld, op = transpose when TA / TB.
template <typename T, bool TA, bool TB, typename Put>
__device__ __forceinline__ void mm(const T* A, const T* B, int d, int ld, Put put) {
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    T acc = 0;
    for (int k = 0; k < d; ++k) {
      const T a = TA ? A[k * ld + i] : A[i * ld + k];
      const T b = TB ? B[j * ld + k] : B[k * ld + j];
      acc += a * b;
    }
    put(i, j, acc);
  }
}

// put(i, sum_k op(A)[i, k] x[k]) for every i.
template <typename T, bool TA, typename Put>
__device__ __forceinline__ void mv(const T* A, const T* x, int d, int ld, Put put) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    T acc = 0;
    for (int k = 0; k < d; ++k) acc += (TA ? A[k * ld + i] : A[i * ld + k]) * x[k];
    put(i, acc);
  }
}

// G[i, j] = 0.5 (S[i, j] + S[j, i]), G contiguous [d, d].
template <typename T>
__device__ __forceinline__ void store_sym_block(T* G, const T* S, int d, int ld) {
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    G[idx] = T(0.5) * (S[i * ld + j] + S[j * ld + i]);
  }
}

// Unpivoted Gauss-Jordan: M -> I, X (the identity on entry) -> M^-1. Before
// step k the columns k.. of X are still identity columns and the columns ..k-1
// of M are finished, so the step updates the d - k - 1 live columns of M and
// the k + 1 live columns of X: d columns in all. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void gj_inverse(T* M, T* X, T* colk, T* rowk, int d, int ld) {
  for (int k = 0; k < d; ++k) {
    const T inv = T(1) / M[k * ld + k];
    const int nm = d - k - 1;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      colk[i] = (i == k) ? T(0) : M[i * ld + k];
      rowk[i] = (i < nm ? M[k * ld + k + 1 + i] : X[k * ld + i - nm]) * inv;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
      const int i = idx / d, c = idx - i * d;
      T* dst = c < nm ? &M[i * ld + k + 1 + c] : &X[i * ld + c - nm];
      *dst = (i == k) ? rowk[c] : *dst - colk[i] * rowk[c];
    }
    __syncthreads();
  }
}

// Filtering combine, one pair per block. Shared memory: nine [d][d + 1]
// matrices (the six inputs and three temporaries that are reused as their
// contents die) and four vectors: 9 d (d + 1) + 4 d words.
template <typename T>
__global__ void fused_filter_block_kernel(const FilterArgs<T> args, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1, mat = d * ld;
  T* sAi = reinterpret_cast<T*>(smem_raw);
  T* sCi = sAi + mat;
  T* sJi = sCi + mat;
  T* sAj = sJi + mat;
  T* sCj = sAj + mat;
  T* sJj = sCj + mat;
  T* P = sJj + mat;  // I + C_i J_j, then A_j U, then C before symmetrisation
  T* X = P + mat;    // U, then A_j U C_i, then J before symmetrisation
  T* Q = X + mat;    // W
  T* v0 = Q + mat;   // b_i, then the pivot column of the elimination
  T* v1 = v0 + d;    // eta_j, then the pivot row
  T* su = v1 + d;    // u = b_i + C_i eta_j
  T* sw = su + d;    // w = eta_j - J_j b_i
  const long long b = blockIdx.x;
  const long long dd = (long long)d * d;

  const T* g[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) g[q] = args.in[q] + b * args.sb[q];
  load_mat(sAi, g[0], args.sr[0], d, ld);
  load_mat(sCi, g[2], args.sr[2], d, ld);
  load_mat(sJi, g[3], args.sr[3], d, ld);
  load_mat(sAj, g[5], args.sr[5], d, ld);
  load_mat(sCj, g[7], args.sr[7], d, ld);
  load_mat(sJj, g[8], args.sr[8], d, ld);
  load_vec(v0, g[1], d);
  load_vec(v1, g[9], d);
  const T* bj = g[6];
  const T* etai = g[4];
  T* A_out = args.out[0] + b * dd;
  T* b_out = args.out[1] + b * d;
  T* C_out = args.out[2] + b * dd;
  T* J_out = args.out[3] + b * dd;
  T* eta_out = args.out[4] + b * d;
  __syncthreads();

  // M = I + C_i J_j, X = I, and the two vectors that need b_i and eta_j
  mm<T, false, false>(sCi, sJj, d, ld, [&](int i, int j, T acc) {
    P[i * ld + j] = acc + (i == j ? T(1) : T(0));
    X[i * ld + j] = (i == j) ? T(1) : T(0);
  });
  mv<T, false>(sCi, v1, d, ld, [&](int i, T acc) { su[i] = v0[i] + acc; });
  mv<T, false>(sJj, v0, d, ld, [&](int i, T acc) { sw[i] = v1[i] - acc; });
  __syncthreads();

  gj_inverse(P, X, v0, v1, d, ld);  // X = U

  mm<T, false, false>(sAj, X, d, ld, [&](int i, int j, T acc) { P[i * ld + j] = acc; });
  mm<T, false, false>(X, sAi, d, ld, [&](int i, int j, T acc) { Q[i * ld + j] = acc; });
  __syncthreads();  // P = A_j U, Q = W; U is dead

  mm<T, false, false>(P, sAi, d, ld, [&](int i, int j, T acc) { A_out[i * d + j] = acc; });
  mv<T, false>(P, su, d, ld, [&](int i, T acc) { b_out[i] = bj[i] + acc; });
  mv<T, true>(Q, sw, d, ld, [&](int i, T acc) { eta_out[i] = etai[i] + acc; });
  mm<T, false, false>(P, sCi, d, ld, [&](int i, int j, T acc) { X[i * ld + j] = acc; });
  __syncthreads();  // X = A_j U C_i; A_j U and C_i are dead

  mm<T, false, true>(X, sAj, d, ld, [&](int i, int j, T acc) {
    P[i * ld + j] = acc + sCj[i * ld + j];
  });
  // J_j A_i takes C_i's place
  mm<T, false, false>(sJj, sAi, d, ld, [&](int i, int j, T acc) { sCi[i * ld + j] = acc; });
  __syncthreads();  // P = C, sCi = J_j A_i; A_j U C_i is dead

  store_sym_block(C_out, P, d, ld);
  mm<T, true, false>(Q, sCi, d, ld, [&](int i, int j, T acc) {
    X[i * ld + j] = acc + sJi[i * ld + j];
  });
  __syncthreads();  // X = J

  store_sym_block(J_out, X, d, ld);
}

// Smoothing combine, one pair per block. Shared memory: five [d][d + 1]
// matrices and one vector: 5 d (d + 1) + d words.
template <typename T>
__global__ void fused_smooth_block_kernel(const SmoothArgs<T> args, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + 1, mat = d * ld;
  T* sEj = reinterpret_cast<T*>(smem_raw);  // E_j, then L before symmetrisation
  T* sLj = sEj + mat;
  T* sEi = sLj + mat;
  T* sLi = sEi + mat;
  T* S = sLi + mat;  // E_i L_j
  T* sgj = S + mat;
  const long long b = blockIdx.x;
  const long long dd = (long long)d * d;

  const T* g[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) g[q] = args.in[q] + b * args.sb[q];
  load_mat(sEj, g[0], args.sr[0], d, ld);
  load_mat(sLj, g[2], args.sr[2], d, ld);
  load_mat(sEi, g[3], args.sr[3], d, ld);
  load_mat(sLi, g[5], args.sr[5], d, ld);
  load_vec(sgj, g[1], d);
  const T* gi = g[4];
  T* E_out = args.out[0] + b * dd;
  T* g_out = args.out[1] + b * d;
  T* L_out = args.out[2] + b * dd;
  __syncthreads();

  mm<T, false, false>(sEi, sEj, d, ld, [&](int i, int j, T acc) { E_out[i * d + j] = acc; });
  mv<T, false>(sEi, sgj, d, ld, [&](int i, T acc) { g_out[i] = gi[i] + acc; });
  mm<T, false, false>(sEi, sLj, d, ld, [&](int i, int j, T acc) { S[i * ld + j] = acc; });
  __syncthreads();  // S = E_i L_j; E_j is dead

  mm<T, false, true>(S, sEi, d, ld, [&](int i, int j, T acc) {
    sEj[i * ld + j] = acc + sLi[i * ld + j];
  });
  __syncthreads();

  store_sym_block(L_out, sEj, d, ld);
}

template <typename T>
int launch_filter(const void* const* in, const long long* strides, void* const* out,
                  int N, int d, int threads, int vec, cudaStream_t stream) {
  FilterArgs<T> args;
  for (int q = 0; q < 10; ++q) {
    args.in[q] = static_cast<const T*>(in[q]);
    args.sb[q] = strides[2 * q];
    args.sr[q] = strides[2 * q + 1];
  }
  for (int q = 0; q < 5; ++q) args.out[q] = static_cast<T*>(out[q]);
  cudaError_t err;
  if (d <= 32) {
    const size_t smem = (size_t)(10 * 32 * tiles::row_pitch<T>(32) + 6 * 32) * sizeof(T);
    auto kern = fused_filter_tiled_kernel<T>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, TILED_THREADS, smem, stream>>>(args, d, vec);
  } else {
    const size_t smem = (size_t)(9 * d * (d + 1) + 4 * d) * sizeof(T);
    auto kern = fused_filter_block_kernel<T>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, threads, smem, stream>>>(args, d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smooth(const void* const* in, const long long* strides, void* const* out,
                  int N, int d, int threads, int vec, cudaStream_t stream) {
  SmoothArgs<T> args;
  for (int q = 0; q < 6; ++q) {
    args.in[q] = static_cast<const T*>(in[q]);
    args.sb[q] = strides[2 * q];
    args.sr[q] = strides[2 * q + 1];
  }
  for (int q = 0; q < 3; ++q) args.out[q] = static_cast<T*>(out[q]);
  cudaError_t err;
  if (d <= 32) {
    const size_t smem = (size_t)(5 * 32 * tiles::row_pitch<T>(32) + 2 * 32) * sizeof(T);
    auto kern = fused_smooth_tiled_kernel<T>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, TILED_THREADS, smem, stream>>>(args, d, vec);
  } else {
    const size_t smem = (size_t)(5 * d * (d + 1) + d) * sizeof(T);
    auto kern = fused_smooth_block_kernel<T>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, threads, smem, stream>>>(args, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. `in` and `out` are host arrays of device
// pointers in the order of the argument structs; `strides` is a host array of
// (batch stride, row stride) per input, in elements (the row stride of a
// vector is ignored). Outputs are contiguous. d <= 32 takes the tiled route
// (128 threads), larger d the block route with `threads` per block; `vec` bit
// q says that input q's base address, batch stride and row stride are
// multiples of 16 bytes (16-byte staging on the tiled route). Each entry
// point returns the cudaError_t of the launch (0 on success).
extern "C" int physs_fused_filter(int dtype, const void* const* in,
                                  const long long* strides, void* const* out, int N,
                                  int d, int threads, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_filter<double>(in, strides, out, N, d, threads, vec, s);
  return launch_filter<float>(in, strides, out, N, d, threads, vec, s);
}

extern "C" int physs_fused_smooth(int dtype, const void* const* in,
                                  const long long* strides, void* const* out, int N,
                                  int d, int threads, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_smooth<double>(in, strides, out, N, d, threads, vec, s);
  return launch_smooth<float>(in, strides, out, N, d, threads, vec, s);
}
