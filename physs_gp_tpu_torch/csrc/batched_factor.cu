// Batched triangular factorisations for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels
//   lq_kernel<T>          <- _lq_kernel in physs_gp_tpu/ops/pallas/batched_qr.py
//                            (batch_tria: Householder LQ, L L^T = B B^T)
//   chol_kernel<T, false> <- _chol_kernel in physs_gp_tpu/ops/pallas/batched_chol.py
//                            (batch_cholesky: explicit PSD A)
//   chol_kernel<T, true>  <- _chol_gram_kernel in the same file
//                            (batch_chol_gram: L = chol(X X^T + Y Y^T [+ I]))
//
// The TPU kernels put the batch on the 128 vector lanes; here one block owns
// one matrix, read row-major as given (batch and row strides are arguments,
// the last dimension has unit stride), and writes a contiguous lower factor.
//
// What bounds them on this card: at the main path's shapes (d = 32, m <= 64,
// N = 25 000 to 100 000) the arithmetic is ~2 d^2 m flops (LQ) or ~d^3 / 3
// (Cholesky) per 8-16 KB (f32) of operands, far under the ~20 flops per byte
// where the fp32 pipes would saturate, so bytes would bound them; but each
// factorisation carries a serial dependence over the pivot or reflector index
// k (d steps, each a reduction followed by a rank-1 update), so the barrier-
// separated steps per block, not bytes, set the time. The design keeps the
// matrix in shared memory for all d steps (one read, one write of device
// memory), reduces with warp shuffles, and relies on many resident blocks
// to hide the per-step latency. wgmma, TMA and several matrices per warp are
// later work.
//
// Numerics follow the TPU kernels step for step (same reflector, same pivot
// floor, same canonical signs), so the plain PyTorch versions in
// ops/cuda/batched_{qr,chol}.py agree with these kernels to rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Householder LQ of B [d, m] (m >= d), one matrix per block. Step k reflects
// row k's tail (columns >= k) onto alpha e_k with a right reflector
// I - beta v v^T supported on columns >= k, and applies it to the rows below.
// A zero tail gets beta = 0 (identity), so zero and rank-deficient inputs
// stay finite. L = W[:, :d], column j scaled by sign(L[j][j]) (0 -> +1),
// upper triangle zero.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void lq_kernel(const T* __restrict__ B, T* __restrict__ L, int d, int m,
                          long long sB, long long ldB) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);  // [d][m] working copy of B
  T* v = W + (size_t)d * m;               // [m] reflector, columns >= k
  T* w = v + m;                           // [d] w = W v for rows > k
  T* scal = w + d;                        // alpha, beta of step k
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int idx = threadIdx.x; idx < d * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    W[idx] = B[b * sB + (long long)i * ldB + j];
  }
  __syncthreads();

  for (int k = 0; k < d; ++k) {
    T* rowk = W + (size_t)k * m;
    if (warp == 0) {
      T s = 0;
      for (int j = k + lane; j < m; j += 32) s += rowk[j] * rowk[j];
      const T norm = sqrt(warp_sum(s));
      const T xk = rowk[k];
      const T alpha = xk < T(0) ? norm : -norm;
      T t = 0;
      for (int j = k + lane; j < m; j += 32) {
        const T vj = (j == k) ? xk - alpha : rowk[j];
        v[j] = vj;
        t += vj * vj;
      }
      const T vtv = warp_sum(t);
      if (lane == 0) {
        scal[0] = alpha;
        scal[1] = vtv > T(0) ? T(2) / vtv : T(0);
      }
    }
    __syncthreads();
    for (int i = k + 1 + warp; i < d; i += nwarps) {  // one warp per row
      const T* row = W + (size_t)i * m;
      T s = 0;
      for (int j = k + lane; j < m; j += 32) s += row[j] * v[j];
      s = warp_sum(s);
      if (lane == 0) w[i] = s;
    }
    __syncthreads();
    const T alpha = scal[0], beta = scal[1];
    const int width = m - k;
    for (int idx = threadIdx.x; idx < (d - k) * width; idx += blockDim.x) {
      const int r = idx / width, j = k + idx - r * width;
      if (r == 0) {
        rowk[j] = (j == k) ? alpha : T(0);
      } else {
        const int i = k + r;
        W[(size_t)i * m + j] -= beta * w[i] * v[j];
      }
    }
    __syncthreads();
  }

  T* out = L + b * d * d;
  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int i = idx / d, j = idx - i * d;
    T val = T(0);
    if (j <= i) {
      const T lij = W[(size_t)i * m + j];
      val = W[(size_t)j * m + j] < T(0) ? -lij : lij;
    }
    out[idx] = val;
  }
}

// ---------------------------------------------------------------------------
// Right-looking Cholesky with the per-row pivot floor, one matrix per block:
// pivot_k = max(a_kk, eps_rel * d0_k + 1e-30), d0 the diagonal before the
// elimination. GRAM forms A = X X^T (+ Y Y^T) (+ I) in shared memory first;
// otherwise A is read from the lower triangle of the input. Only the lower
// triangle is kept ([d][d + 1], padded against bank conflicts); output is
// L contiguous [N, d, d] with a zero upper triangle. Never NaN for PSD or
// all-zero input.
// ---------------------------------------------------------------------------
template <typename T, bool GRAM>
__global__ void chol_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                            T* __restrict__ L, int d, int mx, int my, long long sX,
                            long long ldX, long long sY, long long ldY, int plus_eye,
                            T eps_rel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = d + 1;
  T* A = reinterpret_cast<T*>(smem_raw);  // [d][d + 1]
  T* d0 = A + (size_t)d * lda;            // [d] diagonal before elimination
  T* c = d0 + d;                          // [d] column k / l_kk
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  if (GRAM) {
    const int ldx = mx + 1, ldy = my + 1;  // padded rows of the staged factors
    T* Xs = c + d;                         // [d][mx + 1]
    T* Ys = Xs + (size_t)d * ldx;          // [d][my + 1]
    for (int idx = tid; idx < d * mx; idx += nt) {
      const int i = idx / mx, j = idx - i * mx;
      Xs[i * ldx + j] = X[b * sX + (long long)i * ldX + j];
    }
    for (int idx = tid; idx < d * my; idx += nt) {
      const int i = idx / my, j = idx - i * my;
      Ys[i * ldy + j] = Y[b * sY + (long long)i * ldY + j];
    }
    __syncthreads();
    for (int idx = tid; idx < d * d; idx += nt) {
      const int i = idx / d, j = idx - i * d;
      if (j > i) continue;
      T acc = 0;
      for (int l = 0; l < mx; ++l) acc += Xs[i * ldx + l] * Xs[j * ldx + l];
      for (int l = 0; l < my; ++l) acc += Ys[i * ldy + l] * Ys[j * ldy + l];
      if (plus_eye && i == j) acc += T(1);
      A[i * lda + j] = acc;
    }
  } else {
    for (int idx = tid; idx < d * d; idx += nt) {
      const int i = idx / d, j = idx - i * d;
      if (j <= i) A[i * lda + j] = X[b * sX + (long long)i * ldX + j];
    }
  }
  __syncthreads();
  for (int i = tid; i < d; i += nt) d0[i] = A[i * lda + i];
  __syncthreads();

  for (int k = 0; k < d; ++k) {
    const T akk = A[k * lda + k];
    const T fl = eps_rel * d0[k] + T(1e-30);
    const T lkk = sqrt(akk < fl ? fl : akk);  // NaN propagates, as jnp.maximum
    const T inv = T(1) / lkk;
    for (int i = k + 1 + tid; i < d; i += nt) c[i] = A[i * lda + k] * inv;
    __syncthreads();
    if (tid == 0) A[k * lda + k] = lkk;
    const int n = d - k - 1;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int r = idx / n, s = idx - r * n;
      if (s > r) continue;
      const int i = k + 1 + r, j = k + 1 + s;
      A[i * lda + j] -= c[i] * c[j];
    }
    for (int i = k + 1 + tid; i < d; i += nt) A[i * lda + k] = c[i];
    __syncthreads();
  }

  T* out = L + b * d * d;
  for (int idx = tid; idx < d * d; idx += nt) {
    const int i = idx / d, j = idx - i * d;
    out[idx] = j <= i ? A[i * lda + j] : T(0);
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch_lq(const void* B, void* L, int N, int d, int m, long long sB, long long ldB,
              int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(d * m + m + d + 2) * sizeof(T);
  auto kern = lq_kernel<T>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(static_cast<const T*>(B), static_cast<T*>(L), d, m,
                                     sB, ldB);
  return (int)cudaGetLastError();
}

template <typename T, bool GRAM>
int launch_chol(const void* X, const void* Y, void* L, int N, int d, int mx, int my,
                long long sX, long long ldX, long long sY, long long ldY, int plus_eye,
                double eps_rel, int threads, cudaStream_t stream) {
  size_t words = (size_t)d * (d + 1) + 2 * d;
  if (GRAM) words += (size_t)d * (mx + 1) + (size_t)d * (my + 1);
  const size_t smem = words * sizeof(T);
  auto kern = chol_kernel<T, GRAM>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(static_cast<const T*>(X), static_cast<const T*>(Y),
                                     static_cast<T*>(L), d, mx, my, sX, ldX, sY, ldY,
                                     plus_eye, (T)eps_rel);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Strides are in elements. Each entry point
// returns the cudaError_t of the launch (0 on success).
extern "C" int physs_lq(int dtype, const void* B, void* L, int N, int d, int m,
                        long long sB, long long ldB, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_lq<double>(B, L, N, d, m, sB, ldB, threads, s);
  return launch_lq<float>(B, L, N, d, m, sB, ldB, threads, s);
}

// gram = 0: L = chol(X) for X [N, d, d] (lower triangle read; Y, mx, my unused).
// gram = 1: L = chol(X X^T + Y Y^T [+ I]), X [N, d, mx], Y [N, d, my] (my may be 0).
extern "C" int physs_chol(int dtype, int gram, const void* X, const void* Y, void* L,
                          int N, int d, int mx, int my, long long sX, long long ldX,
                          long long sY, long long ldY, int plus_eye, double eps_rel,
                          int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (gram)
      return launch_chol<double, true>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                       eps_rel, threads, s);
    return launch_chol<double, false>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                      eps_rel, threads, s);
  }
  if (gram)
    return launch_chol<float, true>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                    eps_rel, threads, s);
  return launch_chol<float, false>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                   eps_rel, threads, s);
}
