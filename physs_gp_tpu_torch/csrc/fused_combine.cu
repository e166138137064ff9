// Fused associative combines of the parallel Kalman filter and smoother for
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of physs_gp_tpu/ops/pallas/fused_combine.py:
//   fused_filter_kernel  <- _combine_kernel   (fused_filtering_combine)
//   fused_smooth_kernel  <- _smoothing_kernel (fused_smoothing_combine)
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
// inverse and both symmetrisations run out of shared memory, and only the
// results go back to device memory: one launch per combine.
//
// What bounds them on this card: the scans call them at batch 256 (the
// sequential pass over the blocks) and 128 (the Sklansky levels), d = 32. That
// is 9.6 MB of operands and results and 0.15 GFLOP for the filtering combine,
// 3 us of bytes and 2 us of operations at the card's rates, but one block
// walks d pivots of two barriers each and then eight dependent d x d products,
// so the kernel is bound by that chain's latency (54 us on an H100 at 700 W),
// not by bytes or operations. The design keeps the chain short and simple:
// matrices live in shared memory with a row pitch of d + 1 words, so the
// column reads of the elimination and the transposed reads of the products
// and symmetrisations hit distinct banks; each elimination step touches
// exactly d columns (the live ones of M and of the growing inverse);
// independent products share a barrier interval. Register tiling and several
// pairs per block are later work.
//
// No pivoting and no pivot floor, exactly as on the TPU: I + C_i J_j is
// identity-dominated (it is exactly I for the identity element and for a
// chunk's first element).

#include <cuda_runtime.h>

namespace {

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
__device__ __forceinline__ void store_sym(T* G, const T* S, int d, int ld) {
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

// ---------------------------------------------------------------------------
// Filtering combine, one pair per block. Shared memory: nine [d][d + 1]
// matrices (the six inputs and three temporaries that are reused as their
// contents die) and four vectors: 9 d (d + 1) + 4 d words.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void fused_filter_kernel(const FilterArgs<T> args, int d) {
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

  store_sym(C_out, P, d, ld);
  mm<T, true, false>(Q, sCi, d, ld, [&](int i, int j, T acc) {
    X[i * ld + j] = acc + sJi[i * ld + j];
  });
  __syncthreads();  // X = J

  store_sym(J_out, X, d, ld);
}

// ---------------------------------------------------------------------------
// Smoothing combine, one pair per block. Shared memory: five [d][d + 1]
// matrices and one vector: 5 d (d + 1) + d words.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void fused_smooth_kernel(const SmoothArgs<T> args, int d) {
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

  store_sym(L_out, sEj, d, ld);
}

// Opt in to more than 48 KB of dynamic shared memory. `granted` is the
// caller's static record of the largest size its kernel was given, so the
// attribute is set when a launch first needs more, not on every launch.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <typename T>
int launch_filter(const void* const* in, const long long* strides, void* const* out,
                  int N, int d, int threads, cudaStream_t stream) {
  FilterArgs<T> args;
  for (int q = 0; q < 10; ++q) {
    args.in[q] = static_cast<const T*>(in[q]);
    args.sb[q] = strides[2 * q];
    args.sr[q] = strides[2 * q + 1];
  }
  for (int q = 0; q < 5; ++q) args.out[q] = static_cast<T*>(out[q]);
  const size_t smem = (size_t)(9 * d * (d + 1) + 4 * d) * sizeof(T);
  auto kern = fused_filter_kernel<T>;
  static size_t granted = 48 * 1024;
  cudaError_t err = set_smem(kern, smem, granted);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(args, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_smooth(const void* const* in, const long long* strides, void* const* out,
                  int N, int d, int threads, cudaStream_t stream) {
  SmoothArgs<T> args;
  for (int q = 0; q < 6; ++q) {
    args.in[q] = static_cast<const T*>(in[q]);
    args.sb[q] = strides[2 * q];
    args.sr[q] = strides[2 * q + 1];
  }
  for (int q = 0; q < 3; ++q) args.out[q] = static_cast<T*>(out[q]);
  const size_t smem = (size_t)(5 * d * (d + 1) + d) * sizeof(T);
  auto kern = fused_smooth_kernel<T>;
  static size_t granted = 48 * 1024;
  cudaError_t err = set_smem(kern, smem, granted);
  if (err != cudaSuccess) return (int)err;
  kern<<<N, threads, smem, stream>>>(args, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. `in` and `out` are host arrays of device
// pointers in the order of the argument structs; `strides` is a host array of
// (batch stride, row stride) per input, in elements (the row stride of a
// vector is ignored). Outputs are contiguous. Each entry point returns the
// cudaError_t of the launch (0 on success).
extern "C" int physs_fused_filter(int dtype, const void* const* in,
                                  const long long* strides, void* const* out, int N,
                                  int d, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_filter<double>(in, strides, out, N, d, threads, s);
  return launch_filter<float>(in, strides, out, N, d, threads, s);
}

extern "C" int physs_fused_smooth(int dtype, const void* const* in,
                                  const long long* strides, void* const* out, int N,
                                  int d, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_smooth<double>(in, strides, out, N, d, threads, s);
  return launch_smooth<float>(in, strides, out, N, d, threads, s);
}
