// Batched triangular factorisations for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels
//   lq_*_kernel<T>          <- _lq_kernel in physs_gp_tpu/ops/pallas/batched_qr.py
//                              (batch_tria: Householder LQ, L L^T = B B^T)
//   chol_*_kernel<T, false> <- _chol_kernel in physs_gp_tpu/ops/pallas/batched_chol.py
//                              (batch_cholesky: explicit PSD A)
//   chol_*_kernel<T, true>  <- _chol_gram_kernel in the same file
//                              (batch_chol_gram: L = chol(X X^T + Y Y^T [+ I]))
//
// The TPU kernels put the batch on the 128 vector lanes; here the matrices
// are read row-major as given (batch and row strides are arguments, the last
// dimension has unit stride), and the lower factor is written contiguous.
//
// Cholesky and Gram + Cholesky. What bounds them: at the main path's shapes
// (d = 32, N = 256 in the blocked scan, 25 000 to 100 000 at full width) the
// arithmetic is d^3 / 3 (+ 2 d^2 m for the Gram) flops on 8-12 KB (f32) per
// matrix, under the ~20 flops per byte where the fp32 pipes would saturate:
// device-memory bytes are the bound. A block per matrix with two block-wide
// barriers per pivot is held by those 2 d barriers and by a Gram that reads
// two shared-memory words per multiply-add, some ten times above the bound.
// What the design does about it, for d <= 32 (chol_warp_kernel):
//   - one warp owns one matrix, a block holds up to 8 of them (fewer when
//     the batch is small, so that 256 matrices spread over every SM), and
//     after the staging barrier the warps never wait for each other;
//   - lane i keeps row i of A in 32 registers. The Gram is formed straight
//     into them from [X | Y] staged once with cp.async (16 bytes at a time
//     when base and strides allow): per 16 bytes of lane i's own row, one
//     broadcast 16-byte load of row j feeds the multiply-adds of a_ij, all j;
//     every lane computes its full row (half of it is the unused upper
//     triangle: that is the price of no cross-lane traffic);
//   - the elimination is right-looking, the order of the TPU kernel: at step
//     k lane k's floored pivot goes round by one shuffle, every lane scales
//     its a_ik, column k goes through 128 (256) bytes of the warp's own
//     shared memory (double-buffered, one __syncwarp per step) and comes
//     back as broadcast 16-byte loads for the rank-1 update of the
//     registers. All register indices are static (the loops over k and j are
//     unrolled). d < 32 is the 32 x 32 problem with zero rows and columns
//     behind it (the tile's rows from d on are zero-filled), cut off after
//     step d, so that the inner loops carry no test on d: a branch per load
//     would keep the loads from overlapping, and one warp's latency is the
//     whole time of a launch at the scan's batch;
//   - the factor leaves through the warp's tile so that the stores to
//     device memory are coalesced, 16 bytes a lane when d is a multiple of 4.
// d > 32 does not fit a lane's registers (d up to 80 would need 3 x 96 per
// lane): those shapes, off the main path, stay on one block per matrix in
// shared memory (chol_block_kernel), selected by d in the launcher.
// Numerics are the TPU kernel's in both: pivot k is max(a_kk, eps_rel d0_k +
// 1e-30) with d0 the diagonal before the elimination, a NaN pivot stays NaN,
// all-zero and semi-definite members stay finite, the upper triangle is zero.
//
// LQ. ~2 d^2 m flops on 12 KB (f32, d = 32, m = 64) per matrix: bytes would
// bound it, but each of the d reflectors is a reduction over row k followed
// by a rank-1 update of the rows below, so the d dependent steps set the
// time. A block per matrix with three block-wide barriers per reflector, a
// norm computed by one warp while seven waited, a shuffle reduction per row
// and a runtime division per updated element sat at 4 % of the bound. What
// the design does about it, for d <= 32 and m <= 64 (lq_warp_kernel):
//   - a row per lane: one warp owns the matrix, staged into its own
//     [32][pitch] tile with cp.async (16 bytes when base and strides allow,
//     rows from d on and columns from m on zero-filled: no block barrier at
//     all), and lane i keeps row i, MW = 32 or 64 values, in registers;
//   - at step k lane k reduces its own row's tail alone, with no shuffles,
//     in four independent partial sums (the step's critical path), forms
//     alpha, v and beta, and writes v to a double-buffered MW values of the
//     warp's shared memory (zero below column k); after one __syncwarp every
//     lane takes w_i = row_i . v from its registers and broadcast 16-byte
//     loads (four partial sums again) and applies row_i -= beta w_i v. Lanes
//     at or above k update only their upper triangle, which is discarded,
//     so no lane branches; lane k's diagonal becomes alpha. The update reads
//     v a second time from shared memory instead of holding MW more
//     registers (f64 would spill);
//   - register indices are static (loops over k and j unrolled, loops start
//     at the 16-byte group of column k), d < 32 is the zero-padded problem
//     cut off after step d;
//   - the signs come from one ballot of the diagonal, and L leaves through
//     the warp's tile so that the stores are coalesced.
// d > 32 or m > 64 (off the main path) do not fit a lane's registers: those
// shapes stay on one block per matrix in shared memory (lq_block_kernel),
// selected by shape in the launcher.
//
// The plain PyTorch versions in ops/cuda/batched_{qr,chol}.py run the same
// steps (same reflector, same pivot floor, same canonical signs) and agree
// with these kernels to rounding.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "tiles.cuh"

namespace {

using tiles::Pack;

// the smallest normal number of T: a Householder step whose v^T v is below it
// reflects nothing
template <typename T>
__device__ __forceinline__ T min_normal();
template <>
__device__ __forceinline__ float min_normal<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double min_normal<double>() { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Householder LQ of B [d, m] (m >= d), one matrix per block (d > 32 or
// m > 64). Step k reflects
// row k's tail (columns >= k) onto alpha e_k with a right reflector
// I - beta v v^T supported on columns >= k, and applies it to the rows below.
// A zero tail gets beta = 0 (identity), and so does a tail whose v^T v is
// below the smallest normal number (a numerically zero tail of a
// rank-deficient row, where 2 / v^T v overflows): zero and rank-deficient
// inputs stay finite. L = W[:, :d], column j scaled by sign(L[j][j]) (0 -> +1),
// upper triangle zero.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void lq_block_kernel(const T* __restrict__ B, T* __restrict__ L, int d, int m,
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
        scal[1] = vtv >= min_normal<T>() ? T(2) / vtv : T(0);
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

// A 16-byte group from shared memory that the compiler may not merge with an
// earlier load of the same address: the LQ update reads v again instead of
// keeping MW more values live from the dot product.
template <typename T>
__device__ __forceinline__ Pack<T> lds_again(const T* p) {
  Pack<T> r;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (sizeof(T) == 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
                 : "r"(a));
  else
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(r.v[0]), "=d"(r.v[1]) : "r"(a));
  return r;
}

// Shared memory of one warp of lq_warp_kernel, in elements: the [32][pitch]
// tile, two reflectors of MW values, two betas (padded to 16 bytes).
template <typename T, int MW>
__host__ __device__ inline int lq_slice() {
  return 32 * tiles::row_pitch<T>(MW) + 2 * MW + Pack<T>::W;
}

// ---------------------------------------------------------------------------
// d <= 32, m <= MW (32 or 64): one warp per matrix, blockDim.x / 32 matrices
// per block, row `lane` of B in registers (header). vec: B's base, batch
// stride and row stride allow 16-byte staging.
// ---------------------------------------------------------------------------
template <typename T, int MW>
__global__ void __launch_bounds__(256)
lq_warp_kernel(const T* __restrict__ B, T* __restrict__ L, int N, int d, int m,
               long long sB, long long ldB, int vec) {
  constexpr int W = Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= N) return;  // whole warps leave; the block never synchronises
  const int pitch = tiles::row_pitch<T>(MW);
  T* S = reinterpret_cast<T*>(smem_raw) + (size_t)w * lq_slice<T, MW>();
  T* vbuf = S + 32 * pitch;  // [2][MW]
  T* betas = vbuf + 2 * MW;  // [2]
  T* own = S + lane * pitch;

  tiles::stage_warp<T, MW>(S, pitch, B + b * sB, ldB, d, m, vec != 0, lane);
  tiles::cp_async_wait_all();
  __syncwarp();
  T x[MW];
#pragma unroll
  for (int q = 0; q < MW / W; ++q) {
    const Pack<T> p = *reinterpret_cast<const Pack<T>*>(own + q * W);
#pragma unroll
    for (int e = 0; e < W; ++e) x[q * W + e] = p.v[e];
  }

  T alpha_own = T(0);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k >= d) break;
    T* v = vbuf + (k & 1) * MW;  // step k + 1 writes the other half
    if (lane == k) {
      T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int j = k + 1; j < MW; ++j) acc[j & 3] += x[j] * x[j];
      const T tail = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      const T xk = x[k];
      const T norm = sqrt(xk * xk + tail);
      const T alpha = xk < T(0) ? norm : -norm;
      const T vk = xk - alpha;
      const T vtv = vk * vk + tail;
      // a zero (or subnormal) tail reflects nothing
      betas[k & 1] = vtv >= min_normal<T>() ? T(2) / vtv : T(0);
      alpha_own = alpha;
#pragma unroll
      for (int q = k / W; q < MW / W; ++q) {
        Pack<T> p;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int j = q * W + e;
          p.v[e] = j < k ? T(0) : j == k ? vk : x[j];
        }
        *reinterpret_cast<Pack<T>*>(v + q * W) = p;
      }
    }
    __syncwarp();
    const T beta = betas[k & 1];
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int q = k / W; q < MW / W; ++q) {
      const Pack<T> p = *reinterpret_cast<const Pack<T>*>(v + q * W);
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (q * W + e >= k) acc[(q * W + e) & 3] += x[q * W + e] * p.v[e];
    }
    const T t = beta * ((acc[0] + acc[1]) + (acc[2] + acc[3]));
#pragma unroll
    for (int q = k / W; q < MW / W; ++q) {
      const Pack<T> p = lds_again(v + q * W);
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (q * W + e >= k) x[q * W + e] -= t * p.v[e];
    }
    x[k] = lane == k ? alpha_own : x[k];
  }

  // L[i][j] = x[j] for j <= i, column j negated where its diagonal is < 0
  const unsigned neg = __ballot_sync(0xffffffffu, alpha_own < T(0));
#pragma unroll
  for (int q = 0; q < 32 / W; ++q) {
    Pack<T> p;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int j = q * W + e;
      p.v[e] = j > lane ? T(0) : (neg >> j) & 1u ? -x[j] : x[j];
    }
    *reinterpret_cast<Pack<T>*>(own + q * W) = p;
  }
  __syncwarp();
  // [d][d] out of the tile, a lane per element (per 16 bytes when d % 4 == 0):
  // `groups` lanes a row, 32 / groups rows a pass
  const int ew = (d & 3) == 0 ? W : 1;
  const int groups = d / ew, rows = 32 / groups;
  const int r0 = lane / groups, c0 = (lane - r0 * groups) * ew;
  if (r0 >= rows) return;
  T* out = L + b * d * d;
  for (int r = r0; r < d; r += rows) {
    if (ew == W)
      *reinterpret_cast<Pack<T>*>(out + r * d + c0) =
          *reinterpret_cast<const Pack<T>*>(S + r * pitch + c0);
    else
      out[r * d + c0] = S[r * pitch + c0];
  }
}

// ---------------------------------------------------------------------------
// Right-looking Cholesky of the 32 x 32 (or smaller) matrix whose row `lane`
// sits in this lane's registers, with the per-row pivot floor
// pivot_k = max(a_kk, eps_rel * d0_k + 1e-30), d0 the diagonal on entry.
// Rows and columns from d on are zero on entry and take no part. On return
// row[j], j <= lane < d, is L[lane][j]; entries right of the diagonal are not
// meaningful. cb: 64 elements of this warp's shared memory.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void eliminate_rows(T (&row)[32], int d, int lane, T eps_rel,
                                               T* cb) {
  constexpr int W = Pack<T>::W;
  T d0 = T(0);
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j == lane) d0 = row[j];
  const T fl = eps_rel * d0 + T(1e-30);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k >= d) break;
    const T akk = row[k];
    const T own = sqrt(akk < fl ? fl : akk);  // NaN propagates, as jnp.maximum
    const T lkk = __shfl_sync(0xffffffffu, own, k);
    const T inv = T(1) / lkk;
    const T c = row[k] * inv;
    row[k] = lane == k ? lkk : c;
    if (k + 1 >= d) break;
    T* buf = cb + (k & 1) * 32;  // step k + 1 writes the other half
    buf[lane] = c;
    __syncwarp();
#pragma unroll
    for (int q = (k + 1) / W; q < 32 / W; ++q) {  // no test on d: the loads overlap
      const Pack<T> cj = *reinterpret_cast<const Pack<T>*>(buf + q * W);
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (q * W + e > k) row[q * W + e] -= c * cj.v[e];
    }
  }
}

// ---------------------------------------------------------------------------
// d <= 32: one warp per matrix, blockDim.x / 32 matrices per block. GRAM
// forms A = X X^T (+ Y Y^T) (+ I) from [X | Y] staged side by side (Y from
// column ceil4(mx)); otherwise the lower triangle of X is staged. Output is
// L contiguous [N, d, d] with a zero upper triangle.
// ---------------------------------------------------------------------------
template <typename T, bool GRAM>
__global__ void __launch_bounds__(256)
chol_warp_kernel(const T* __restrict__ X, const T* __restrict__ Y, T* __restrict__ L,
                 int N, int d, int mx, int my, long long sX, long long ldX,
                 long long sY, long long ldY, int plus_eye, T eps_rel, int vecX,
                 int vecY) {
  constexpr int W = Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = nt >> 5;
  const int cx = GRAM ? tiles::ceil4(mx) : 0;  // Y's first column in the tile
  const int width = GRAM ? cx + tiles::ceil4(my) : d;
  const int pitch = tiles::row_pitch<T>(width > d ? width : d);
  const int slice = 32 * pitch;
  T* S = reinterpret_cast<T*>(smem_raw);  // [G][32][pitch], rows >= d zero
  T* cbuf = S + (size_t)G * slice;        // [G][2][32]
  const int b0 = blockIdx.x * G;

  if (GRAM) {
    tiles::stage<T, false>(S, slice, pitch, X, sX, ldX, d, mx, 32, b0, N, G, vecX != 0, tid, nt);
    if (my > 0)
      tiles::stage<T, false>(S + cx, slice, pitch, Y, sY, ldY, d, my, 32, b0, N, G, vecY != 0,
                             tid, nt);
  } else {
    tiles::stage<T, true>(S, slice, pitch, X, sX, ldX, d, d, 32, b0, N, G, vecX != 0, tid, nt);
  }
  tiles::cp_async_wait_all();
  __syncthreads();

  const int w = tid >> 5, lane = tid & 31;
  const long long b = b0 + w;
  if (b >= N) return;  // whole warps leave; no block-wide barrier follows
  T* Sw = S + (size_t)w * slice;
  T* own = Sw + lane * pitch;
  T row[32];
  if (GRAM) {
#pragma unroll
    for (int j = 0; j < 32; ++j) row[j] = T(0);
    for (int l0 = 0; l0 < width; l0 += W) {
      const Pack<T> xi = *reinterpret_cast<const Pack<T>*>(own + l0);
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // no test on d: the 32 loads overlap
        const Pack<T> xj = *reinterpret_cast<const Pack<T>*>(Sw + j * pitch + l0);
#pragma unroll
        for (int e = 0; e < W; ++e) row[j] += xi.v[e] * xj.v[e];
      }
    }
    if (plus_eye) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j == lane) row[j] += T(1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 32 / W; ++q) {
      Pack<T> v;
#pragma unroll
      for (int e = 0; e < W; ++e) v.v[e] = T(0);
      if (q * W < d) v = *reinterpret_cast<const Pack<T>*>(own + q * W);
#pragma unroll
      for (int e = 0; e < W; ++e) row[q * W + e] = v.v[e];
    }
  }

  eliminate_rows(row, d, lane, eps_rel, cbuf + w * 64);

  __syncwarp();  // every lane is done reading the staged operands
  if (lane < d) {
#pragma unroll
    for (int q = 0; q < 32 / W; ++q) {
      if (q * W >= d) break;
      Pack<T> v;
#pragma unroll
      for (int e = 0; e < W; ++e) v.v[e] = q * W + e <= lane ? row[q * W + e] : T(0);
      *reinterpret_cast<Pack<T>*>(own + q * W) = v;
    }
  }
  __syncwarp();
  T* out = L + b * d * d;
  if ((d & 3) == 0) {
    const int groups = d / W;
    for (int idx = lane; idx < d * groups; idx += 32) {
      const int r = idx / groups, c0 = (idx - r * groups) * W;
      *reinterpret_cast<Pack<T>*>(out + r * d + c0) =
          *reinterpret_cast<const Pack<T>*>(Sw + r * pitch + c0);
    }
  } else {
    for (int idx = lane; idx < d * d; idx += 32) {
      const int r = idx / d;
      out[idx] = Sw[r * pitch + idx - r * d];
    }
  }
}

// ---------------------------------------------------------------------------
// d > 32: one block per matrix, the lower triangle in shared memory as
// [d][d + 1]; the same right-looking elimination with block-wide barriers.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void eliminate_block(T* A, int lda, const T* d0, T* c, int d,
                                                T eps_rel, int tid, int nt) {
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
}

template <typename T, bool GRAM>
__global__ void chol_block_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                                  T* __restrict__ L, int d, int mx, int my, long long sX,
                                  long long ldX, long long sY, long long ldY,
                                  int plus_eye, T eps_rel) {
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

  eliminate_block(A, lda, d0, c, d, eps_rel, tid, nt);

  T* out = L + b * d * d;
  for (int idx = tid; idx < d * d; idx += nt) {
    const int i = idx / d, j = idx - i * d;
    out[idx] = j <= i ? A[i * lda + j] : T(0);
  }
}

// 1 <= d <= 32, m <= 64: lq_warp_kernel, `threads` = 32 G from lq_plan;
// otherwise one block of `threads` per matrix (lq_block_kernel).
template <typename T, int MW>
cudaError_t launch_lq_warp(const T* B, T* L, int N, int d, int m, long long sB,
                           long long ldB, int threads, cudaStream_t stream) {
  const int G = threads / 32;
  const size_t smem = (size_t)G * lq_slice<T, MW>() * sizeof(T);
  const int vec = ((reinterpret_cast<size_t>(B) | (size_t)(sB * (long long)sizeof(T)) |
                    (size_t)(ldB * (long long)sizeof(T))) & 15) == 0;
  auto kern = lq_warp_kernel<T, MW>;
  static size_t granted = 48 * 1024;
  cudaError_t err = tiles::set_smem(kern, smem, granted);
  if (err != cudaSuccess) return err;
  kern<<<(N + G - 1) / G, threads, smem, stream>>>(B, L, N, d, m, sB, ldB, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_lq(const void* B, void* L, int N, int d, int m, long long sB, long long ldB,
              int threads, cudaStream_t stream) {
  const T* b = static_cast<const T*>(B);
  T* l = static_cast<T*>(L);
  if (d >= 1 && d <= 32 && m <= 32)
    return (int)launch_lq_warp<T, 32>(b, l, N, d, m, sB, ldB, threads, stream);
  if (d >= 1 && d <= 32 && m <= 64)
    return (int)launch_lq_warp<T, 64>(b, l, N, d, m, sB, ldB, threads, stream);
  const size_t smem = (size_t)(d * m + m + d + 2) * sizeof(T);
  auto kern = lq_block_kernel<T>;
  static size_t granted = 48 * 1024;
  cudaError_t err = tiles::set_smem(kern, smem, granted);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(b, l, d, m, sB, ldB);
  return (int)cudaGetLastError();
}

// d <= 32: G matrices (warps) per block; d > 32: one block of `threads` per matrix.
template <typename T, bool GRAM>
int launch_chol(const void* X, const void* Y, void* L, int N, int d, int mx, int my,
                long long sX, long long ldX, long long sY, long long ldY, int plus_eye,
                double eps_rel, int G, int threads, int vecX, int vecY,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(X);
  const T* y = static_cast<const T*>(Y);
  T* l = static_cast<T*>(L);
  cudaError_t err;
  if (d <= 32) {
    const int width = GRAM ? tiles::ceil4(mx) + tiles::ceil4(my) : d;
    const size_t smem =
        (size_t)G * (32 * tiles::row_pitch<T>(width > d ? width : d) + 64) * sizeof(T);
    auto kern = chol_warp_kernel<T, GRAM>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<(N + G - 1) / G, 32 * G, smem, stream>>>(x, y, l, N, d, mx, my, sX, ldX, sY, ldY,
                                                    plus_eye, (T)eps_rel, vecX, vecY);
  } else {
    size_t words = (size_t)d * (d + 1) + 2 * d;
    if (GRAM) words += (size_t)d * (mx + 1) + (size_t)d * (my + 1);
    const size_t smem = words * sizeof(T);
    auto kern = chol_block_kernel<T, GRAM>;
    static size_t granted = 48 * 1024;
    err = tiles::set_smem(kern, smem, granted);
    if (err != cudaSuccess) return (int)err;
    kern<<<N, threads, smem, stream>>>(x, y, l, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                       (T)eps_rel);
  }
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
// vecX / vecY: the operand's base address, batch stride and row stride are
// multiples of 16 bytes (16-byte staging; read for d <= 32 only).
extern "C" int physs_chol(int dtype, int gram, const void* X, const void* Y, void* L,
                          int N, int d, int mx, int my, long long sX, long long ldX,
                          long long sY, long long ldY, int plus_eye, double eps_rel,
                          int G, int threads, int vecX, int vecY, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (gram)
      return launch_chol<double, true>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                       eps_rel, G, threads, vecX, vecY, s);
    return launch_chol<double, false>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                      eps_rel, G, threads, vecX, vecY, s);
  }
  if (gram)
    return launch_chol<float, true>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                    eps_rel, G, threads, vecX, vecY, s);
  return launch_chol<float, false>(X, Y, L, N, d, mx, my, sX, ldX, sY, ldY, plus_eye,
                                   eps_rel, G, threads, vecX, vecY, s);
}
