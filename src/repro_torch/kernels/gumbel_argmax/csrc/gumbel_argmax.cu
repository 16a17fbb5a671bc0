// Position-keyed Gumbel-argmax token choice on Hopper (sm_90a).
//
// Replaces the sampled branch of repro/serving/sampler.py:82
// ::choose_tokens_lanes — an XLA program in the reference, not a Pallas
// kernel: for each row (b, t) of the step's logits, the index
//     argmax_v  logits[b, t, v] / max(temp[b], 1e-6) + g[v],
// where g[v] = -log(-log(u[v])) and u[v] is jax.random.uniform's draw for
// vocab index v under the key fold_in(key(seed[b]), pos[b, t]), in the
// partitionable threefry2x32 layout of jax 0.9: the key is the words
// (0, seed); fold_in hashes the counter (0, p) under it; the bits of index v
// are y0 ^ y1 of the hash of the counter (0, v); u is the top 23 bits as the
// mantissa of a float in [1, 2), minus one, floored at FLT_MIN.  The hash is
// exact integer arithmetic, so the bits and uniforms equal the reference's;
// the two logf calls agree with torch.log (and with XLA to 2e-6).  Built
// without fast math: IEEE division and logf, as the plain version computes.
// Ties go to the first index, and a NaN wins, as in jnp.argmax and
// torch.argmax.  Rows of greedy lanes are skipped (their choice is the
// argmax, selected outside) and hold 0.
//
// Two launches from one entry point (a third entry, gumbel_noise_launch,
// writes the draw itself so a check can hold the generator bit for bit).  Pass 1 has one block per (row, chunk
// of kChunk vocab entries): each thread hashes, transforms and compares its
// entries in registers, and the block reduces to one (value, index) pair per
// chunk.  Pass 2 has one warp per row and reduces the row's chunk pairs.  The
// (B, T, V) noise never exists in memory.
//
// Bound at the serving path's shape (B, T, V) = (4, 33, 151936) in bf16 with
// two sampled lanes: the draw needs 66 rows x 151936 = 10.0 M hashes of
// about 82 32-bit ALU operations each (20 add/rotate/xor rounds, the key
// injections, the uniform, two logs, the division, the add and the compare),
// 0.82 G operations, 12 us at 67 TOP/s; reading the sampled rows' logits is
// 20 MB, 6 us at 3.35 TB/s — so the call is bound by operations.
//
// What this simple design leaves on the table: the logf pair goes through
// the accurate libm path (a fast __logf would break agreement with the
// plain version), one bf16 load per element instead of 16-byte vectors, and
// a second launch for the cross-chunk reduction where a last-block-done
// counter could fold it into pass 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;           // vocab entries per pass-1 block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds: (x0, x1) <- hash of the counter under (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;
#define TF_ROT0 TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROT1 TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0; x1 += k1;
  TF_ROT0 x0 += k1; x1 += k2 + 1u;
  TF_ROT1 x0 += k2; x1 += k0 + 2u;
  TF_ROT0 x0 += k0; x1 += k1 + 3u;
  TF_ROT1 x0 += k1; x1 += k2 + 4u;
  TF_ROT0 x0 += k2; x1 += k0 + 5u;
#undef TF_ROT1
#undef TF_ROT0
#undef TF_ROUND
}

// (a, ia) ranks above (b, ib): larger value, NaN above all, first index on
// a tie.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Vocab index v's raw bits and Gumbel value under the key (k0, k1).
__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, int v,
                                      uint32_t& bits) {
  uint32_t x0 = 0u, x1 = (uint32_t)v;
  threefry2x32(k0, k1, x0, x1);
  bits = x0 ^ x1;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(fmaxf(f, FLT_MIN)));
}

// fold_in(key(seed), p): the counter (0, p) under the key (0, seed).
__device__ __forceinline__ void row_key(long long seed, int p, uint32_t& k0,
                                        uint32_t& k1) {
  k0 = 0u;
  k1 = (uint32_t)p;
  threefry2x32(0u, (uint32_t)seed, k0, k1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gumbel_partial(const T* __restrict__ logits, const int* __restrict__ pos,
               const float* __restrict__ temp,
               const long long* __restrict__ seed,
               const uint8_t* __restrict__ greedy, float* __restrict__ pval,
               int* __restrict__ pidx, int n_t, int V, int n_chunks) {
  const int row = blockIdx.y, b = row / n_t;
  if (greedy[b]) return;
  uint32_t k0, k1, bits;
  row_key(seed[b], pos[row], k0, k1);
  const float tau = fmaxf(temp[b], 1e-6f);
  const T* lg = logits + (long)row * V;
  const int c = (int)blockIdx.x;
  const int v_end = min((c + 1) * kChunk, V);
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int v = c * kChunk + (int)threadIdx.x; v < v_end; v += kThreads) {
    const float val = to_f(lg[v]) / tau + draw(k0, k1, v, bits);
    if (better(val, v, best, bi)) { best = val; bi = v; }
  }
  warp_best(best, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { sv[warp] = best; si[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? sv[lane] : -INFINITY;
    bi = lane < kThreads / 32 ? si[lane] : INT_MAX;
    warp_best(best, bi);
    if (lane == 0) {
      pval[(long)row * n_chunks + c] = best;
      pidx[(long)row * n_chunks + c] = bi;
    }
  }
}

__global__ void __launch_bounds__(32)
gumbel_reduce(const float* __restrict__ pval, const int* __restrict__ pidx,
              const uint8_t* __restrict__ greedy, int* __restrict__ out,
              int n_t, int n_chunks) {
  const int row = blockIdx.x, lane = threadIdx.x;
  if (greedy[row / n_t]) {
    if (lane == 0) out[row] = 0;
    return;
  }
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < n_chunks; j += 32) {
    const float v = pval[(long)row * n_chunks + j];
    const int i = pidx[(long)row * n_chunks + j];
    if (better(v, i, best, bi)) { best = v; bi = i; }
  }
  warp_best(best, bi);
  if (lane == 0) out[row] = bi;
}

// The draw itself, for checking the generator: row r's raw bits and Gumbel
// values under fold_in(key(seed[r]), pos[r]) (one thread per entry).
__global__ void gumbel_noise(const long long* __restrict__ seed,
                             const int* __restrict__ pos,
                             uint32_t* __restrict__ bits,
                             float* __restrict__ g, int V) {
  const int row = blockIdx.y;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  uint32_t k0, k1, b;
  row_key(seed[row], pos[row], k0, k1);
  g[(long)row * V + v] = draw(k0, k1, v, b);
  bits[(long)row * V + v] = b;
}

}  // namespace

// logits (B, T, V) f32 (dtype 0) or bf16 (dtype 1); pos (B, T) int32;
// temp (B,) f32; seed (B,) int64 holding uint32 values; greedy (B,) bool;
// scratch pval / pidx (B * T, n_chunks) f32 / int32 with n_chunks =
// ceil(V / 4096); out (B, T) int32.  B * T is at most 65535 (the grid's y).
extern "C" int gumbel_argmax_launch(const void* logits, const void* pos,
                                    const void* temp, const void* seed,
                                    const void* greedy, void* pval,
                                    void* pidx, void* out, int B, int T,
                                    int V, int n_chunks, int dtype,
                                    void* stream) {
  if (B < 0 || T < 0 || V < 1 || dtype < 0 || dtype > 1 ||
      (long)B * T > 65535 || n_chunks != (V + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_chunks, B * T);
  const int* p = static_cast<const int*>(pos);
  const float* tp = static_cast<const float*>(temp);
  const long long* sd = static_cast<const long long*>(seed);
  const uint8_t* gr = static_cast<const uint8_t*>(greedy);
  float* pv = static_cast<float*>(pval);
  int* pi = static_cast<int*>(pidx);
  if (dtype == 0)
    gumbel_partial<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), p, tp, sd, gr, pv, pi, T, V,
        n_chunks);
  else
    gumbel_partial<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), p, tp, sd, gr, pv, pi, T,
        V, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gumbel_reduce<<<B * T, 32, 0, s>>>(pv, pi, gr, static_cast<int*>(out), T,
                                     n_chunks);
  return (int)cudaGetLastError();
}

// The generator alone: seed (R,) int64, pos (R,) int32 -> bits (R, V) uint32
// and Gumbel values (R, V) f32 — what pass 1 draws for those rows.
extern "C" int gumbel_noise_launch(const void* seed, const void* pos,
                                   void* bits, void* g, int R, int V,
                                   void* stream) {
  if (R < 0 || R > 65535 || V < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const dim3 grid((V + kThreads - 1) / kThreads, R);
  gumbel_noise<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(seed), static_cast<const int*>(pos),
      static_cast<uint32_t*>(bits), static_cast<float*>(g), V);
  return (int)cudaGetLastError();
}
