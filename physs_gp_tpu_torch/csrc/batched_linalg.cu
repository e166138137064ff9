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
// What bounds them on this card: the main path's shapes are d = 32 with
// N = 25 000 systems per call. bmm does 2*32^3 flops per 8 KB (f32) of operands,
// about 8 flops per byte: memory bound, far below the ~20 flops/byte where the
// H100's fp32 pipes would saturate. The Gauss-Jordan solve does ~d^2 (d + r)
// flops on d (d + r) values but carries a serial dependence over the pivot k,
// so it is bound by the d barrier-separated steps per block (latency), not by
// bytes or flops. The design answers both simply: every matrix is staged once
// into shared memory with coalesced loads, all arithmetic runs out of shared
// memory, and enough independent blocks (one system each, or several small
// products each) are in flight to hide the per-step latency. wgmma, TMA and
// several systems per warp are later work.
//
// No pivoting, exactly as on the TPU: the systems are SPD or identity-dominated
// (I + C J). A zero pivot gives inf/NaN, as it does there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---------------------------------------------------------------------------
// C[b] = op(A[b]) @ op(B[b]),  op(A) [m, k], op(B) [k, n], C contiguous [N, m, n]
// G batch elements per block (G > 1 only when m * n is small).
// ---------------------------------------------------------------------------
template <typename T, bool TA, bool TB>
__global__ void bmm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                           T* __restrict__ C, int N, int m, int n, int k,
                           long long sA, long long ldA, long long sB,
                           long long ldB, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [G][m][k]
  T* Bs = As + (size_t)G * m * k;          // [G][k][n]
  const int b0 = blockIdx.x * G;
  const int mk = m * k, kn = k * n, mn = m * n;

  // Stored A is [m, k] (or [k, m] when TA); walk the stored layout so that
  // neighbouring threads read neighbouring addresses.
  const int a_cols = TA ? m : k;
  for (int idx = threadIdx.x; idx < G * mk; idx += blockDim.x) {
    const int g = idx / mk, rem = idx - g * mk;
    const int b = b0 + g;
    if (b >= N) break;
    const int r = rem / a_cols, c = rem - r * a_cols;
    const T v = A[(long long)b * sA + (long long)r * ldA + c];
    As[g * mk + (TA ? c * k + r : r * k + c)] = v;
  }
  const int b_cols = TB ? k : n;
  for (int idx = threadIdx.x; idx < G * kn; idx += blockDim.x) {
    const int g = idx / kn, rem = idx - g * kn;
    const int b = b0 + g;
    if (b >= N) break;
    const int r = rem / b_cols, c = rem - r * b_cols;
    const T v = B[(long long)b * sB + (long long)r * ldB + c];
    Bs[g * kn + (TB ? c * n + r : r * n + c)] = v;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * mn; idx += blockDim.x) {
    const int g = idx / mn, rem = idx - g * mn;
    const int b = b0 + g;
    if (b >= N) break;
    const int i = rem / n, j = rem - i * n;
    const T* a = As + g * mk + i * k;
    const T* bb = Bs + g * kn + j;
    T acc = 0;
    for (int l = 0; l < k; ++l) acc += a[l] * bb[l * n];
    C[(long long)b * mn + rem] = acc;
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

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool TA, bool TB>
int launch_bmm(const void* A, const void* B, void* C, int N, int m, int n, int k,
               long long sA, long long ldA, long long sB, long long ldB, int G,
               int threads, cudaStream_t stream) {
  const size_t smem = (size_t)G * (m * k + k * n) * sizeof(T);
  auto kern = bmm_kernel<T, TA, TB>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + G - 1) / G;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), N,
      m, n, k, sA, ldA, sB, ldB, G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bmm(int ta, int tb, const void* A, const void* B, void* C, int N,
                 int m, int n, int k, long long sA, long long ldA, long long sB,
                 long long ldB, int G, int threads, cudaStream_t s) {
  if (ta && tb)
    return launch_bmm<T, true, true>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
  if (ta)
    return launch_bmm<T, true, false>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
  if (tb)
    return launch_bmm<T, false, true>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
  return launch_bmm<T, false, false>(A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
}

template <typename T, bool LOGDET>
int launch_gj(const void* M, const void* R, void* X, void* ld, int N, int d,
              int r, long long sM, long long ldM, long long sR, long long ldR,
              int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(d * (d + r) + d + (d + r)) * sizeof(T);
  auto kern = gj_solve_kernel<T, LOGDET>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(
      static_cast<const T*>(M), static_cast<const T*>(R), static_cast<T*>(X),
      static_cast<T*>(ld), d, r, sM, ldM, sR, ldR);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Strides are in elements. Each entry point
// returns the cudaError_t of the launch (0 on success).
extern "C" int physs_bmm(int dtype, int ta, int tb, const void* A, const void* B,
                         void* C, int N, int m, int n, int k, long long sA,
                         long long ldA, long long sB, long long ldB, int G,
                         int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bmm<double>(ta, tb, A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
  return dispatch_bmm<float>(ta, tb, A, B, C, N, m, n, k, sA, ldA, sB, ldB, G, threads, s);
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
