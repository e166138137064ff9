// Shared-memory tiles for the batched small-matrix kernels (sm_90a): the row
// pitch, 16-byte packs, cp.async staging of strided row-major operands and
// the opt-in above 48 KB of dynamic shared memory.
//
// The pitch settles two needs that pull against each other. A 16-byte load
// or cp.async needs every row to start 16-byte aligned, so the pitch is a
// multiple of 16 bytes; a pitch of d words with d = 32 puts a column, or the
// same 16 bytes of eight neighbouring rows, on one bank. A pitch that is
// 16 (mod 32) bytes keeps both: rows stay aligned, and the eight lanes of a
// quarter warp that read 16 bytes at the same column of eight neighbouring
// rows cover all 32 banks exactly once (consecutive rows start 4 banks
// apart). Scalar column reads then meet 4-way conflicts at worst, so the
// kernels read rows with 16-byte loads and never walk a column.

#pragma once

#include <cuda_runtime.h>

namespace tiles {

// 16 bytes of T: 4 floats or 2 doubles, one load or store instruction.
template <typename T>
struct alignas(16) Pack {
  static constexpr int W = 16 / (int)sizeof(T);
  T v[W];
};

__host__ __device__ inline int ceil4(int x) { return (x + 3) & ~3; }

// Row pitch in elements for `cols` columns: cols rounded up to 4, then to
// 16 (mod 32) bytes.
template <typename T>
__host__ __device__ inline int row_pitch(int cols) {
  int bytes = ceil4(cols) * (int)sizeof(T);
  if (bytes % 32 == 0) bytes += 16;
  return bytes / (int)sizeof(T);
}

// Asynchronous copy of BYTES (4, 8 or 16) from device to shared memory; only
// the first src_bytes are read, the rest of the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One 16-byte group of a tile row: the first `valid` elements from p (one
// 16-byte cp.async when `vec`, else one per element), the rest zero.
template <typename T>
__device__ __forceinline__ void stage_group(T* dst, const T* p, int valid, bool vec) {
  constexpr int W = Pack<T>::W;
  if (valid <= 0) {
    Pack<T> zero;
#pragma unroll
    for (int e = 0; e < W; ++e) zero.v[e] = T(0);
    *reinterpret_cast<Pack<T>*>(dst) = zero;
  } else if (vec) {
    cp_async<16>(dst, p, valid * (int)sizeof(T));
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (e < valid)
        cp_async<(int)sizeof(T)>(dst + e, p + e, (int)sizeof(T));
      else
        dst[e] = T(0);
    }
  }
}

// Stage G matrices [rows, cols] (members b0 .. b0 + G - 1 of a batch of N;
// batch stride sb and row stride ld in elements, unit stride along a row)
// into S: member g at S + g * slice, row r at + r * pitch, in the stored
// layout. Rows up to rows_p and columns up to ceil4(cols) are zero-filled,
// as are members past N, so that the arithmetic needs no masks. With LOWER,
// 16-byte groups that lie wholly above the diagonal are not read (zeros).
// `vec` says that base, batch stride and row stride are 16-byte aligned:
// then each group is one 16-byte cp.async, else one cp.async per element.
// The caller waits (cp_async_wait_all) and synchronises.
template <typename T, bool LOWER>
__device__ __forceinline__ void stage(T* S, int slice, int pitch, const T* __restrict__ src,
                                      long long sb, long long ld, int rows, int cols,
                                      int rows_p, int b0, int N, int G, bool vec, int tid,
                                      int nt) {
  constexpr int W = Pack<T>::W;
  const int groups = ceil4(cols) / W;  // 16-byte groups per row
  const int per = rows_p * groups;
  for (int idx = tid; idx < G * per; idx += nt) {
    const int g = idx / per, rem = idx - g * per;
    const int r = rem / groups, c0 = (rem - r * groups) * W;
    int valid = (b0 + g < N && r < rows) ? min(W, cols - c0) : 0;
    if (LOWER && c0 > r) valid = 0;
    stage_group(S + (size_t)g * slice + (size_t)r * pitch + c0,
                src + (long long)(b0 + g) * sb + (long long)r * ld + c0, valid, vec);
  }
}

// Stage one matrix [rows, cols] at src (row stride ld, unit stride along a
// row) into S [32][pitch] with NT threads (one warp by default; tid is the
// thread's index among them): WIDTH columns per row (a multiple of 4, at
// least cols), rows from `rows` on and columns from `cols` on zero-filled. A
// row is WIDTH / W 16-byte groups and NT is a multiple of that count, so a
// thread's group and first row come from shifts of its index, and a step of
// the loop covers NT / groups rows. `vec`: src and ld allow 16-byte copies.
// The caller waits and synchronises (__syncwarp for one warp).
template <typename T, int WIDTH, int NT = 32>
__device__ __forceinline__ void stage_warp(T* S, int pitch, const T* __restrict__ src,
                                           long long ld, int rows, int cols, bool vec,
                                           int tid) {
  constexpr int W = Pack<T>::W;
  constexpr int groups = WIDTH / W;
  static_assert(WIDTH % 4 == 0 && NT % groups == 0, "a step covers whole rows");
  const int c0 = (tid % groups) * W;
  for (int r = tid / groups; r < 32; r += NT / groups)
    stage_group(S + r * pitch + c0, src + (long long)r * ld + c0,
                r < rows ? min(W, cols - c0) : 0, vec);
}

// Opt in to more than 48 KB of dynamic shared memory. `granted` is the
// caller's static record of the largest size its kernel was given, so the
// attribute is set when a launch first needs more, not on every launch.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem, size_t& granted) {
  if (smem <= granted) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

}  // namespace tiles
