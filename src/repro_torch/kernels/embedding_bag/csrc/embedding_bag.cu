// Fused EmbeddingBag (gather + weighted reduce) on Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag/embedding_bag.py:20 ::_kernel
// (launched by embedding_bag_kernel, reached through ops.py
// ::embedding_bag_fused): for each bag n,
//     out[n, :] = sum_l w[n, l] * table[ids[n, l], :]
// accumulated in f32 in l order (acc + row * w, each rounded: no fused
// multiply-add, as the Pallas kernel's separate product and sum), rounded
// once to the table's dtype.  No (N, L, D) gathered intermediate exists.
// A stacked table (F, V, D) serves F fields in one launch: bag n belongs to
// field f = n % F and reads row f * V + id.  Ids follow jnp.take, as the
// reference's model path does: an id in [-V, 0) wraps to id + V, an id at or
// past V or below -V gives a NaN row (NaN under a zero weight too); an id is
// checked against its field's V, never the flattened F * V, so it never
// reads another field's row, and the kernel never reads outside the table.
// Addresses are 64-bit: Wide & Deep's deep tables hold 40 * 10^6 * 32 =
// 1.28e9 elements, 60 % of 2^31.
//
// Route: CUDA C++ built by nvcc with a plain C interface and loaded with
// ctypes, like the port's other kernels (Triton would be allowed for a
// gather-reduction; one toolchain keeps the build simple).
//
// Design: one thread per (bag n, column d), a grid-stride loop over the
// N * D outputs.  Neighbouring threads read neighbouring columns of one row,
// so a row's read coalesces; at D = 1 (the wide tables) neighbouring threads
// are neighbouring bags, so no lane idles as a warp-per-bag design would.
//
// Bound at the path's shapes (bytes over 3.35 TB/s; two or three operations
// per gathered element are nothing beside them): Wide & Deep serve_p99
// (512 x 40 bags of 4) reads 81,920 rows of 32 f32 (10.5 MB), the ids and
// weights (0.66 MB) and writes 2.6 MB, about 4 us; serve_bulk (10,485,760
// bags) about 7 GB, about 2.1 ms.  The wide bag's 4-byte rows cost a 32-byte
// sector each in practice.
//
// What this simple design leaves on the table: scalar 4-byte loads where a
// row could be read as 16-byte vectors, the ids and weights of a bag read
// again by each of its D threads (from L1), no prefetch of the next bag's
// ids, and a 64-bit division per output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // 32 blocks per SM, grid-stride above

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ w, T* __restrict__ out,
                     long long n_bags, int L, int F, long long V, int D) {
  const long long total = n_bags * D;
  const float nan = __int_as_float(0x7fc00000);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / D;
    const long long d = i - n * D;
    const long long field_row0 = (n % F) * V;
    const int* idn = ids + n * L;
    const float* wn = w + n * L;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      long long id = idn[l];
      if (id < 0) id += V;
      const float x = (id >= 0 && id < V)
                          ? to_f(table[(field_row0 + id) * D + d])
                          : nan;
      acc = __fadd_rn(acc, __fmul_rn(x, wn[l]));
    }
    store(out + i, acc);
  }
}

template <typename T>
int run(const void* table, const void* ids, const void* w, void* out,
        int n_bags, int L, int F, int V, int D, cudaStream_t stream) {
  const long long total = (long long)n_bags * D;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  embedding_bag_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<T*>(out), n_bags, L, F, V,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// table (F, V, D) (F = 1: a plain (V, D) table); ids and w (n_bags, L)
// int32 / f32 with bag n in field n % F; out (n_bags, D).  dtype 0 = f32,
// 1 = bf16.  Returns the CUDA error of the launch (0 = success).
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    const void* w, void* out, int n_bags,
                                    int L, int F, int V, int D, int dtype,
                                    void* stream) {
  if (n_bags < 1 || L < 0 || F < 1 || V < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run<float>(table, ids, w, out, n_bags, L, F, V, D, s)
             : run<__nv_bfloat16>(table, ids, w, out, n_bags, L, F, V, D,
                                  s);
}
