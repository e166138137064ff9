// Batched small-matrix linear algebra for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of physs_gp_tpu/ops/pallas/batched_linalg.py:
//   bmm_kernel        <- _mm_kernel_g (batch_bmm) and _mm_kernel (batch_matmul)
//   gj_*_kernel       <- _gj_solve_kernel (batch_solve), LOGDET = false
//                     <- _gj_solve_logdet_kernel (batch_solve_logdet), LOGDET = true
//
// The TPU kernels put the batch on the 128 vector lanes ([d, d, B] layout,
// identity-padded to a lane multiple). Here each block reads its [m, n]
// row-major matrices as given (batch stride and row stride are arguments, the
// last dimension has unit stride), so no transposed copy and no padding exist.
//
// bmm. What bounds it: at the main path's shapes (d = 32, N = 25 000 per
// call, or 256 in the blocked scan) a product does 2 * 32^3 flops on 12 KB
// (f32) of operands and result, about 5 flops per byte, far below the ~20
// where the fp32 pipes would saturate: device-memory bytes are the bound.
// A kernel that reads two shared-memory words per multiply-add is held by
// the shared-memory pipe instead, three to four times above that bound.
// What the design does about it:
//   - each thread keeps a 4 x 4 tile of C in registers and walks the
//     contraction in steps of 16 bytes (4 floats, 2 doubles): eight 16-byte
//     shared loads feed 64 multiply-adds in f32, 0.125 loads per multiply-add;
//   - 64 threads own a 32 x 32 product; a block holds G products (4 at
//     d = 32), fewer when the batch is small, so that [256, 32, 32] still
//     spreads over every SM;
//   - operands are staged in their stored layout with cp.async, 16 bytes at a
//     time when base and strides are 16-byte aligned and one element at a
//     time otherwise (slices that start mid-row, odd row strides); nothing
//     is transposed on the way in. The transpose flags only choose how the
//     inner loop indexes the tile: an operand whose contraction index runs
//     along its rows is read as 16 bytes of one row per output row (or
//     column), the other kind as 4 consecutive outputs of one contraction
//     row;
//   - the pitch (tiles.cuh) keeps rows 16-byte aligned and neighbouring rows
//     4 banks apart. Threads that read the same column group of different
//     rows must therefore sit on neighbouring rows: for a transposed B the
//     thread's four output columns are tj, tj + tn, tj + 2 tn, tj + 3 tn (tn
//     threads across), so the eight lanes of a quarter warp read eight
//     neighbouring rows, conflict-free; all other operand reads are
//     broadcasts or contiguous;
//   - ragged m, n, k are zero-padded in shared memory (to multiples of 4),
//     the stores are masked.
// float32 stays float32 (FFMA, no tensor cores); sums run over the
// contraction index in order.
//
// gj_solve. The Gauss-Jordan solve does d^2 (d + r) multiply-adds on
// d (d + r) values, ~8 per byte at d = 32: bytes would bound it, but pivot
// k + 1 needs every update of step k, so the d dependent steps per matrix
// set the time. A block per matrix with two block-wide barriers per pivot,
// a runtime division per element and three shared-memory words per
// multiply-add sat at 5 % of the bound. What the design does about it, for
// d <= 32 (gj_warp_kernel):
//   - a column per lane. One warp owns the matrix: lane j keeps column j of
//     M and column j of R in registers (loaded straight from device memory:
//     at fixed row, the 32 lanes read 32 neighbouring words, so the loads
//     coalesce for any batch or row stride, and stride-0 batches hit L1);
//   - at step k lane k publishes its column (the multipliers c_i, with
//     1 / pivot in slot k) as one row of a [32][32] history in the warp's
//     shared memory; after one __syncwarp every lane scales its row-k entry
//     and applies the rank-1 update from broadcast 16-byte loads, all
//     register indices static (the loops over k and i are unrolled, d < 32
//     is the zero-padded 32 x 32 problem cut off after step d);
//   - the history is the whole elimination: R columns 32 .. r - 1 run on
//     further warps of the matrix after one block barrier, the same d steps
//     read from the history with no synchronisation, element for element
//     the arithmetic of the joint elimination. A block holds up to 8 warps;
//     small batches (the scan's 256 or 512 systems) run one matrix a block;
//   - X leaves coalesced from registers (at fixed row, lanes store
//     neighbouring columns); with LOGDET each lane keeps its pivot and lane
//     0 sums the logs in k order.
// d > 32 (off the main path) does not fit a lane's registers, and r > 256
// needs more than 8 warps: those shapes stay on one block per matrix in
// shared memory (gj_block_kernel), selected by shape in the launcher.
//
// No pivoting, exactly as on the TPU: the systems are SPD or identity-dominated
// (I + C J). A zero pivot gives inf/NaN, as it does there.

#include <cuda_runtime.h>
#include <math.h>

#include "tiles.cuh"

namespace {

using tiles::Pack;

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

// ---------------------------------------------------------------------------
// C[b] = op(A[b]) @ op(B[b]),  op(A) [m, k], op(B) [k, n], C contiguous [N, m, n].
// G batch members per block; a thread owns rows 4 ti .. 4 ti + 3 of C and
// columns 4 tj .. 4 tj + 3 (tj + c tn, c = 0 .. 3, when TB).
// ---------------------------------------------------------------------------
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(512)
bmm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int N,
           int m, int n, int k, long long sA, long long ldA, long long sB,
           long long ldB, int G, int vecA, int vecB) {
  constexpr int W = Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ra = TA ? k : m, ca = TA ? m : k;  // stored shapes
  const int rb = TB ? n : k, cb = TB ? k : n;
  const int rap = tiles::ceil4(ra), rbp = tiles::ceil4(rb);
  const int pa = tiles::row_pitch<T>(ca), pb = tiles::row_pitch<T>(cb);
  const int perA = rap * pa, perB = rbp * pb;
  T* As = reinterpret_cast<T*>(smem_raw);  // [G][rap][pa]
  T* Bs = As + (size_t)G * perA;           // [G][rbp][pb]
  const int b0 = blockIdx.x * G;
  const int tid = threadIdx.x, nt = blockDim.x;

  tiles::stage<T, false>(As, perA, pa, A, sA, ldA, ra, ca, rap, b0, N, G, vecA != 0, tid, nt);
  tiles::stage<T, false>(Bs, perB, pb, B, sB, ldB, rb, cb, rbp, b0, N, G, vecB != 0, tid, nt);
  tiles::cp_async_wait_all();
  __syncthreads();

  const int tm = (m + 3) / 4, tn = (n + 3) / 4, tpp = tm * tn;
  const int k4 = tiles::ceil4(k);
  for (int t = tid; t < G * tpp; t += nt) {
    const int g = t / tpp, rem = t - g * tpp;
    const int b = b0 + g;
    if (b >= N) break;
    const int ti = rem / tn, tj = rem - ti * tn;
    const T* a_s = As + (size_t)g * perA + (TA ? 4 * ti : 4 * ti * pa);
    const T* b_s = Bs + (size_t)g * perB + (TB ? tj * pb : 4 * tj);
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

    for (int l0 = 0; l0 < k4; l0 += W) {
      T a[4][W], bb[W][4];
      if (TA) {  // stored [k][m]: 4 rows of C from one contraction row
#pragma unroll
        for (int l = 0; l < W; ++l) {
          T v[4];
          load4(a_s + (l0 + l) * pa, v);
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r][l] = v[r];
        }
      } else {  // stored [m][k]: 16 bytes of the contraction per row of C
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Pack<T> v = *reinterpret_cast<const Pack<T>*>(a_s + r * pa + l0);
#pragma unroll
          for (int l = 0; l < W; ++l) a[r][l] = v.v[l];
        }
      }
      if (TB) {  // stored [n][k]: 16 bytes of the contraction per column of C
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Pack<T> v = *reinterpret_cast<const Pack<T>*>(b_s + c * tn * pb + l0);
#pragma unroll
          for (int l = 0; l < W; ++l) bb[l][c] = v.v[l];
        }
      } else {  // stored [k][n]: 4 columns of C from one contraction row
#pragma unroll
        for (int l = 0; l < W; ++l) load4(b_s + (l0 + l) * pb, bb[l]);
      }
#pragma unroll
      for (int l = 0; l < W; ++l)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += a[r][l] * bb[l][c];
    }

    T* out = C + (long long)b * m * n;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ti + r;
      if (i >= m) break;
      if (!TB && (n & 3) == 0) {  // C is contiguous: 16-byte stores
#pragma unroll
        for (int q = 0; q < 4 / W; ++q) {
          Pack<T> v;
#pragma unroll
          for (int e = 0; e < W; ++e) v.v[e] = acc[r][q * W + e];
          *reinterpret_cast<Pack<T>*>(out + (long long)i * n + 4 * tj + q * W) = v;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = TB ? tj + c * tn : 4 * tj + c;
          if (j < n) out[(long long)i * n + j] = acc[r][c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Unpivoted Gauss-Jordan solve of M X = R, one system per block (d > 32 or
// r > 256). W = [M | R] lives in shared memory as [d][d + r]; X contiguous
// [N, d, r]; with LOGDET, ld[b] = sum_k log|pivot_k| (= log det M for SPD M).
// ---------------------------------------------------------------------------
template <typename T, bool LOGDET>
__global__ void gj_block_kernel(const T* __restrict__ M, const T* __restrict__ R,
                                T* __restrict__ X, T* __restrict__ ld, int d,
                                int r, long long sM, long long ldM, long long sR,
                                long long ldR) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = d + r;
  T* W = reinterpret_cast<T*>(smem_raw);  // [d][w]
  T* colk = W + (size_t)d * w;            // [d]   column k before step k
  T* rowk = colk + d;                     // [w]   normalised row k
  const long long b = blockIdx.x;

  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    W[i * w + j] = M[b * sM + (long long)i * ldM + j];
  }
  for (int idx = threadIdx.x; idx < d * r; idx += blockDim.x) {
    const int i = idx / r, j = idx - i * r;
    W[i * w + d + j] = R[b * sR + (long long)i * ldR + j];
  }
  __syncthreads();

  T logdet = 0;
  for (int k = 0; k < d; ++k) {
    const T piv = W[k * w + k];
    const T inv = T(1) / piv;
    if (LOGDET && threadIdx.x == 0) logdet += log(fabs(piv));
    // Columns left of k are finished identity columns and never read again,
    // so only columns k + 1 .. w - 1 are updated.
    const int width = w - k - 1;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      colk[i] = (i == k) ? T(0) : W[i * w + k];
    for (int j = threadIdx.x; j < width; j += blockDim.x)
      rowk[j] = W[k * w + k + 1 + j] * inv;
    __syncthreads();
    for (int idx = threadIdx.x; idx < d * width; idx += blockDim.x) {
      const int i = idx / width, j = idx - i * width;
      T* dst = &W[i * w + k + 1 + j];
      *dst = (i == k) ? rowk[j] : *dst - colk[i] * rowk[j];
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < d * r; idx += blockDim.x) {
    const int i = idx / r, j = idx - i * r;
    X[b * d * r + idx] = W[i * w + d + j];
  }
  if (LOGDET && threadIdx.x == 0) ld[b] = logdet;
}

// ---------------------------------------------------------------------------
// d <= 32: the same elimination with a column per lane (header). Column
// `col` of the [rows, cols] operand at p into z, zero where col >= cols or
// i >= rows; the loads are unconditional (clamped indices) so that they
// all overlap.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void load_column(T (&z)[32], const T* __restrict__ p, long long ld,
                                            int rows, int col, int cols) {
  const bool ok = col < cols;
  p += ok ? col : cols - 1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const T v = p[(long long)(i < rows ? i : rows - 1) * ld];
    z[i] = ok && i < rows ? v : T(0);
  }
}

// Step k on this lane's column y (and x, the column of M, WITH_M): h is row
// k of the history, the multipliers c_i = column k before the step with
// 1 / pivot_k in slot k. Row k is scaled by 1 / pivot_k, every other row i
// loses c_i times it.
template <typename T, bool WITH_M>
__device__ __forceinline__ void gj_step(T (&x)[32], T (&y)[32], const T* h, int k) {
  constexpr int W = Pack<T>::W;
  T c[32];
#pragma unroll
  for (int q = 0; q < 32 / W; ++q) {
    const Pack<T> p = *reinterpret_cast<const Pack<T>*>(h + q * W);
#pragma unroll
    for (int e = 0; e < W; ++e) c[q * W + e] = p.v[e];
  }
  const T inv = c[k];
  const T xk = WITH_M ? x[k] * inv : T(0), yk = y[k] * inv;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i == k) continue;
    if (WITH_M) x[i] -= c[i] * xk;
    y[i] -= c[i] * yk;
  }
  if (WITH_M) x[k] = xk;
  y[k] = yk;
}

// blockDim.x = 32 * wpm * G: wpm = ceil(r / 32) warps per matrix (at least
// one), G matrices per block. Warp 0 of a matrix eliminates M with R's
// columns 0 .. 31 and writes the history; warp w > 0 takes R's columns
// 32 w .. 32 w + 31 through the history after the block barrier (only when
// r > 32). Shared memory per matrix: the [32][32] history and 32 logs.
template <typename T, bool LOGDET>
__global__ void __launch_bounds__(256)
gj_warp_kernel(const T* __restrict__ M, const T* __restrict__ R, T* __restrict__ X,
               T* __restrict__ ld, int N, int d, int r, long long sM, long long ldM,
               long long sR, long long ldR) {
  constexpr int W = Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpm = r > 32 ? (r + 31) >> 5 : 1;
  const int G = blockDim.x / (32 * wpm);
  const int g = warp / wpm, w = warp - g * wpm;
  const long long b = (long long)blockIdx.x * G + g;
  const long long bc = b < N ? b : N - 1;  // past the end: a copy, never stored
  T* H = reinterpret_cast<T*>(smem_raw) + (size_t)g * (32 * 32 + 32);
  const int col = 32 * w + lane;
  T y[32];
  if (r > 0) {
    load_column(y, R + bc * sR, ldR, d, col, r);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = T(0);
  }

  if (w == 0) {
    T x[32];
    load_column(x, M + bc * sM, ldM, d, lane, d);
    T piv = T(1);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k >= d) break;
      T* h = H + k * 32;
      if (lane == k) {  // publish column k, 1 / pivot in slot k
        piv = x[k];
        const T inv = T(1) / piv;
#pragma unroll
        for (int q = 0; q < 32 / W; ++q) {
          Pack<T> p;
#pragma unroll
          for (int e = 0; e < W; ++e) p.v[e] = q * W + e == k ? inv : x[q * W + e];
          *reinterpret_cast<Pack<T>*>(h + q * W) = p;
        }
      }
      __syncwarp();
      gj_step<T, true>(x, y, h, k);
    }
    if (LOGDET) {
      T* logs = H + 32 * 32;
      logs[lane] = log(fabs(piv));
      __syncwarp();
      if (lane == 0 && b < N) {
        T s = T(0);
        for (int k = 0; k < d; ++k) s += logs[k];
        ld[b] = s;
      }
    }
  }
  if (wpm > 1) {  // r is uniform: the whole block takes this barrier or none does
    __syncthreads();
    if (w > 0) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k >= d) break;
        gj_step<T, false>(y, y, H + k * 32, k);
      }
    }
  }
  if (b < N && col < r) {
    T* out = X + b * d * r + col;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < d) out[(long long)i * r] = y[i];
  }
}

template <typename T, bool TA, bool TB>
int launch_bmm(const void* A, const void* B, void* C, int N, int m, int n, int k,
               long long sA, long long ldA, long long sB, long long ldB, int G,
               int threads, int vecA, int vecB, cudaStream_t stream) {
  const int ra = TA ? k : m, ca = TA ? m : k, rb = TB ? n : k, cb = TB ? k : n;
  const size_t smem = (size_t)G * sizeof(T) *
                      (tiles::ceil4(ra) * tiles::row_pitch<T>(ca) +
                       tiles::ceil4(rb) * tiles::row_pitch<T>(cb));
  auto kern = bmm_kernel<T, TA, TB>;
  static size_t granted = 48 * 1024;
  cudaError_t err = tiles::set_smem(kern, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + G - 1) / G;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), N,
      m, n, k, sA, ldA, sB, ldB, G, vecA, vecB);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bmm(int ta, int tb, const void* A, const void* B, void* C, int N,
                 int m, int n, int k, long long sA, long long ldA, long long sB,
                 long long ldB, int G, int threads, int vecA, int vecB, cudaStream_t s) {
  if (ta && tb)
    return launch_bmm<T, true, true>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
  if (ta)
    return launch_bmm<T, true, false>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
  if (tb)
    return launch_bmm<T, false, true>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
  return launch_bmm<T, false, false>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
}

// 1 <= d <= 32 and r <= 256: gj_warp_kernel, `threads` = 32 * wpm * G from
// gj_plan; otherwise one block of `threads` per matrix (gj_block_kernel).
template <typename T, bool LOGDET>
int launch_gj(const void* M, const void* R, void* X, void* ld, int N, int d,
              int r, long long sM, long long ldM, long long sR, long long ldR,
              int threads, cudaStream_t stream) {
  const T* m = static_cast<const T*>(M);
  const T* rr = static_cast<const T*>(R);
  T* x = static_cast<T*>(X);
  T* l = static_cast<T*>(ld);
  cudaError_t err;
  if (d >= 1 && d <= 32 && r <= 256) {
    const int wpm = r > 32 ? (r + 31) / 32 : 1;
    const int G = threads / (32 * wpm);
    const size_t smem = (size_t)G * (32 * 32 + 32) * sizeof(T);
    auto kern = gj_warp_kernel<T, LOGDET>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<(N + G - 1) / G, threads, smem, stream>>>(m, rr, x, l, N, d, r, sM, ldM, sR, ldR);
  } else {
    const size_t smem = (size_t)(d * (d + r) + d + (d + r)) * sizeof(T);
    auto kern = gj_block_kernel<T, LOGDET>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, threads, smem, stream>>>(m, rr, x, l, d, r, sM, ldM, sR, ldR);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Strides are in elements. Each entry point
// returns the cudaError_t of the launch (0 on success). vecA / vecB: the
// operand's base address, batch stride and row stride are all multiples of
// 16 bytes (16-byte staging); 0 selects element-wise staging.
extern "C" int physs_bmm(int dtype, int ta, int tb, const void* A, const void* B,
                         void* C, int N, int m, int n, int k, long long sA,
                         long long ldA, long long sB, long long ldB, int G,
                         int threads, int vecA, int vecB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bmm<double>(ta, tb, A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
  return dispatch_bmm<float>(ta, tb, A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, vecA, vecB, s);
}

extern "C" int physs_gj_solve(int dtype, int logdet, const void* M, const void* R,
                              void* X, void* ld, int N, int d, int r,
                              long long sM, long long ldM, long long sR,
                              long long ldR, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (logdet)
      return launch_gj<double, true>(M, R, X, ld, N, d, r, sM, ldM, sR, ldR, threads, s);
    return launch_gj<double, false>(M, R, X, ld, N, d, r, sM, ldM, sR, ldR, threads, s);
  }
  if (logdet)
    return launch_gj<float, true>(M, R, X, ld, N, d, r, sM, ldM, sR, ldR, threads, s);
  return launch_gj<float, false>(M, R, X, ld, N, d, r, sM, ldM, sR, ldR, threads, s);
}
