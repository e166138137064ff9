// Batched small-matrix linear algebra for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of physs_gp_tpu/ops/pallas/batched_linalg.py:
//   bmm_kernel        <- _mm_kernel_g (batch_bmm) and _mm_kernel (batch_matmul)
//   gj_solve_kernel   <- _gj_solve_kernel (batch_solve), LOGDET = false
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
// gj_solve. The Gauss-Jordan solve does ~d^2 (d + r) flops on d (d + r)
// values but carries a serial dependence over the pivot k, so it is bound by
// the d barrier-separated steps per block (latency), not by bytes or flops:
// one system per block, staged once into shared memory, all arithmetic out
// of shared memory, many resident blocks to hide the per-step latency.
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
// Unpivoted Gauss-Jordan solve of M X = R, one system per block.
// W = [M | R] lives in shared memory as [d][d + r]; X contiguous [N, d, r];
// with LOGDET, ld[b] = sum_k log|pivot_k| (= log det M for SPD M).
// ---------------------------------------------------------------------------
template <typename T, bool LOGDET>
__global__ void gj_solve_kernel(const T* __restrict__ M, const T* __restrict__ R,
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

template <typename T, bool LOGDET>
int launch_gj(const void* M, const void* R, void* X, void* ld, int N, int d,
              int r, long long sM, long long ldM, long long sR, long long ldR,
              int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(d * (d + r) + d + (d + r)) * sizeof(T);
  auto kern = gj_solve_kernel<T, LOGDET>;
  static size_t granted = 48 * 1024;
  cudaError_t err = tiles::set_smem(kern, smem, granted);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(
      static_cast<const T*>(M), static_cast<const T*>(R), static_cast<T*>(X),
      static_cast<T*>(ld), d, r, sM, ldM, sR, ldR);
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
