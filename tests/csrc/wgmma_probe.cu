// Probe: do Hopper's warpgroup products (wgmma) give mma.sync's f32 bits?
//
// One warpgroup (4 warps, 64 rows) computes the causal prefill kernel's two
// products at dh = 128 both ways, on the same inputs, through the functions
// the kernels call (attention_tile.cuh): S = Q.K^T of a 64-key tile into a
// zeroed accumulator (tile_scores against wg_scores_issue), and acc = C +
// P.V with P entering as bf16 hi + lo (tile_pv against wg_pv_issue).  The
// mma.sync side reads K and V from padded rows by ldmatrix, the wgmma side
// from the 128-byte-swizzled atoms the tensor memory accelerator writes (here
// written by plain stores) by descriptors.  Built and called by
// tests/test_torch_cuda.py::test_wgmma_gives_mma_sync_bits.
#include "attention_tile.cuh"

using namespace attn;

namespace {

constexpr int kND = 8, kW = 64, kCH = 16, kP = mma_pitch(kND);
constexpr size_t kSmem = 1024 + 4 * kAtomBytes + 3 * 64 * kP * 2;

// plain stores to shared memory made visible to the products' reads (the
// async proxy); then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the kernel's warpgroup products of one tile, each issued and waited for
// as the causal kernel issues and waits for them
__device__ __forceinline__ void wg_tile_scores(float (&sc)[8][4],
                                               const uint32_t (&qf)[8][4],
                                               uint32_t k_addr) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  wg_fence();
  wg_scores_issue(sc, qf, k_addr);
  wg_commit();
  wg_wait<0>();
  wg_fence_operand(sc);
}
__device__ __forceinline__ void wg_tile_pv(float (&acc)[16][4],
                                           const float (&sc)[8][4],
                                           uint32_t v_addr) {
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int kv = 0; kv < 4; ++kv) split_p<64>(sc, kv, ph[kv], pl[kv]);
  wg_fence();
  wg_pv_issue(acc, ph, pl, v_addr);
  wg_commit();
  wg_wait<0>();
  wg_fence_operand(acc);
}

__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ p, const float* __restrict__ c,
                   float* __restrict__ s_mma, float* __restrict__ s_wg,
                   float* __restrict__ o_mma, float* __restrict__ o_wg) {
  extern __shared__ __align__(16) unsigned char sm[];
  // the swizzled K and V tiles on 1024-byte boundaries, then padded rows
  unsigned char* kc = sm + ((1024 - (smem_addr(sm) & 1023)) & 1023);
  unsigned char* vc = kc + 2 * kAtomBytes;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(vc + 2 * kAtomBytes);
  __nv_bfloat16* ks = qs + 64 * kP;                           // 64 x kP
  __nv_bfloat16* vs = ks + 64 * kP;                           // 64 x kP
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = tid; i < 64 * kCH; i += 128) {
    const int j = i / kCH, cc = i % kCH;
    const long g = (long)j * 128 + cc * 8;
    *reinterpret_cast<uint4*>(qs + j * kP + cc * 8) =
        *reinterpret_cast<const uint4*>(q + g);
    *reinterpret_cast<uint4*>(ks + j * kP + cc * 8) =
        *reinterpret_cast<const uint4*>(k + g);
    *reinterpret_cast<uint4*>(vs + j * kP + cc * 8) =
        *reinterpret_cast<const uint4*>(v + g);
    *reinterpret_cast<uint4*>(kc + wg_chunk(j, cc)) =
        *reinterpret_cast<const uint4*>(k + g);
    *reinterpret_cast<uint4*>(vc + wg_chunk(j, cc)) =
        *reinterpret_cast<const uint4*>(v + g);
  }
  fence_async_smem();
  __syncthreads();

  const uint32_t q_base = smem_addr(qs + q_lane_off(lane, warp, kP));
  uint32_t qf[kND][4];
#pragma unroll
  for (int kk = 0; kk < kND; ++kk) ldsm_x4(q_base + 32 * kk, qf[kk]);
  float sa[8][4], sb[8][4];
  tile_scores<kND, kW, true, false>(sa, qf, q_base,
                                    smem_addr(ks) + 2 * k_lane_off(lane, kP));
  wg_tile_scores(sb, qf, smem_addr(kc));
  float pa[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gid + 8 * (e >> 1);
      const int col = 8 * j + 2 * tig + (e & 1);
      s_mma[r * 64 + col] = sa[j][e];
      s_wg[r * 64 + col] = sb[j][e];
      pa[j][e] = p[r * 64 + col];
    }
  float oa[16][4], ob[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gid + 8 * (e >> 1);
      oa[n][e] = ob[n][e] = c[r * 128 + 8 * n + 2 * tig + (e & 1)];
    }
  tile_pv<kND, kW, false>(oa, pa, smem_addr(vs) + 2 * v_lane_off(lane, kP));
  wg_tile_pv(ob, pa, smem_addr(vc));
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gid + 8 * (e >> 1);
      const int col = 8 * n + 2 * tig + (e & 1);
      o_mma[r * 128 + col] = oa[n][e];
      o_wg[r * 128 + col] = ob[n][e];
    }
}

}  // namespace

// q, k, v (64, 128) bf16; p (64, 64) f32; c (64, 128) f32; outputs s (64,
// 64) and o (64, 128) f32, each from mma.sync and from wgmma
extern "C" int wgmma_probe_launch(const void* q, const void* k, const void* v,
                                  const void* p, const void* c, void* s_mma,
                                  void* s_wg, void* o_mma, void* o_wg,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<<<1, 128, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(p),
      static_cast<const float*>(c), static_cast<float*>(s_mma),
      static_cast<float*>(s_wg), static_cast<float*>(o_mma),
      static_cast<float*>(o_wg));
  return (int)cudaGetLastError();
}
