// Shared body of the port's attention kernels (tree-verification decode
// attention on the dense and on the paged KV layout, and causal flash
// prefill): GQA attention of a tile of query rows against one KV head, with
// an online softmax carried in f32 registers.
//
// Layouts (the public layouts of the JAX wrappers; no grouped copy is made):
//   q, out  (B, n_q, H, dh)     H = K * G
//   k, v    dense: (B, S, K, dh); paged: the block pool (n_blocks, bs, K, dh)
//           shared by every lane, with S = bpl * bs logical positions a lane
//   mask    (B, n_q, S) bool    (tree kernels only; the causal kernel derives
//                                s <= t from the indices)
//   bt      (B, bpl) int32      (paged only: lane b's logical block j lives
//                                in physical block bt[b, j])
// The row-address hook (template parameter kPaged) is the one place the two
// layouts differ: key s of lane b is row b*S + s of k/v (dense) or row
// bt[b, s / bs] * bs + s % bs (paged, the lane's table row staged in shared
// memory at block start).  Key tiles stay on LOGICAL positions s0 = 0, 32,
// ... in both, so a row's arithmetic does not depend on the layout: the paged
// kernel gives the dense kernel's bits on the same logical K/V.
// A block owns (lane b, KV head kh, kRows consecutive grouped rows), where
// grouped row r = t * G + g is query position t of head kh * G + g: the G
// heads that share a KV head share every K/V tile the block stages.  The
// work-order hook (template parameter kLongestFirst, causal only) is how
// blocks map to those items: a 3-D grid (row tile fastest, then kh, then b),
// or a 1-D grid whose block i takes the row tile n_tiles - 1 - i / (K * B)
// — the causal row tiles in falling order of length, so the launch's tail
// is short blocks — at the same tile body and the same key tiles.
//
// Per key tile of kKeys = 32 rows the block stages K and V into shared memory
// as f32 (K with a padded pitch, so lane j reading key j is conflict-free),
// then each warp walks its kRowsPerWarp rows: lane j scores key j, the warp
// reduces max and sum with shuffles, and every lane accumulates its dh/32
// output columns.  Masked scores contribute exactly 0 (p is zeroed, as in
// tree_attention_ref), so a row with no visible key returns 0, and a tile
// that is fully masked for a row leaves that row's state bit-identical —
// which makes a row's result independent of which block computed it, of the
// batch and of the tree width (the serving path's losslessness relies on it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // grouped query rows per block
constexpr int kKeys = 32;                      // keys per tile: one per lane
constexpr float kNegInf = -1e30f;              // NEG_INF of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte vector load of kVec elements, converted to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    uint4 x = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Paged addressing: the block tables and the pool's geometry (unused, and
// left zero, on the dense layout).
struct Paged {
  const int* bt = nullptr;    // (B, bpl) int32
  int bpl = 0;                // table entries per lane
  int bs = 0;                 // KV rows per block
  int n_blocks = 0;           // pool size
};

inline size_t smem_bytes(int dh, int table_entries) {
  return sizeof(float) * (size_t)(kRows * dh + kKeys * (dh + 1) + kKeys * dh)
         + sizeof(int) * (size_t)table_entries + kRows * kKeys;
}

// NC = ceil(dh / 32) output columns per lane; kCausal selects the mask;
// kPaged the key-row address (see the top of this file).
template <typename T, int NC, bool kCausal, bool kPaged,
          bool kLongestFirst = false>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, int n_q, int S, int H, int K, int dh,
                 float scale, Paged pg) {
  static_assert(kCausal || !kLongestFirst, "work order: causal only");
  const int G = H / K;
  const int n_rows = n_q * G;
  int b, kh, tile;
  if (kLongestFirst) {
    const int n_tiles = (n_rows + kRows - 1) / kRows;
    const int items = (int)gridDim.x / n_tiles;   // K * B per row tile
    const int i = (int)blockIdx.x;
    tile = n_tiles - 1 - i / items;
    kh = i % K;
    b = (i % items) / K;
  } else {
    b = blockIdx.z;
    kh = blockIdx.y;
    tile = blockIdx.x;
  }
  const int row0 = tile * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* qs = smem;                          // kRows x dh
  float* ks = qs + kRows * dh;               // kKeys x (dh + 1)
  float* vs = ks + kKeys * (dh + 1);         // kKeys x dh
  int* bts = reinterpret_cast<int*>(vs + kKeys * dh);  // bpl (paged only)
  uint8_t* ms = reinterpret_cast<uint8_t*>(bts + (kPaged ? pg.bpl : 0));
                                             // kRows x kKeys

  if (kPaged) {
    // the lane's table row; an entry outside the pool is clamped into it
    // (memory safety only: the serving path never writes one)
    for (int i = threadIdx.x; i < pg.bpl; i += blockDim.x)
      bts[i] = min(max(pg.bt[(long)b * pg.bpl + i], 0), pg.n_blocks - 1);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kRows * dh; i += blockDim.x) {
    const int rl = i / dh, d = i - rl * dh, r = row0 + rl;
    float x = 0.f;
    if (r < n_rows) {
      const int t = r / G, h = kh * G + r % G;
      x = to_f(q[(((long)b * n_q + t) * H + h) * dh + d]);
    }
    qs[i] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  // Causal: the key loop stops at the diagonal of the block's last row.
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int s_end = kCausal ? last_row / G + 1 : S;
  constexpr int V = Vec<T>::kN;
  const int vecs = dh / V;

  for (int s0 = 0; s0 < s_end; s0 += kKeys) {
    if (!kCausal) {
      // stage the tile's mask; skip the tile when no row of the block sees
      // any of its keys (cache rows past every lane's visible prefix)
      int any = 0;
      for (int i = threadIdx.x; i < kRows * kKeys; i += blockDim.x) {
        const int rl = i / kKeys, s = s0 + i % kKeys, r = row0 + rl;
        uint8_t vis = 0;
        if (r < n_rows && s < S)
          vis = mask[((long)b * n_q + r / G) * S + s] ? 1 : 0;
        ms[i] = vis;
        any |= vis;
      }
      if (!__syncthreads_or(any)) continue;
    }
    for (int i = threadIdx.x; i < kKeys * vecs; i += blockDim.x) {
      const int j = i / vecs, d0 = (i - j * vecs) * V, s = s0 + j;
      float kx[V], vx[V];
      if (s < S) {
        const long row = kPaged ? (long)bts[s / pg.bs] * pg.bs + s % pg.bs
                                : (long)b * S + s;
        const long off = (row * K + kh) * dh + d0;
        Vec<T>::load(k + off, kx);
        Vec<T>::load(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * (dh + 1) + d0 + e] = kx[e];
        vs[j * dh + d0 + e] = vx[e];
      }
    }
    __syncthreads();

    const int s = s0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int rl = warp * kRowsPerWarp + rr, r = row0 + rl;
      if (r >= n_rows) break;                       // warp-uniform
      const bool vis = kCausal ? (s <= r / G) : ms[rl * kKeys + lane] != 0;
      float sc = kNegInf;
      if (vis) {
        const float* qr = qs + rl * dh;
        const float* kr = ks + lane * (dh + 1);
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      const float m_new = fmaxf(m[rr], warp_max(sc));
      const float p = vis ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = vs + j * dh;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) acc[rr][c] = fmaf(pj, vr[d], acc[rr][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + warp * kRowsPerWarp + rr;
    if (r >= n_rows) break;
    const int t = r / G, h = kh * G + r % G;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* o = out + (((long)b * n_q + t) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) store(o + d, acc[rr][c] / denom);
    }
  }
}

template <typename T, int NC, bool kCausal, bool kPaged, bool kLongestFirst>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* mask, void* out, int B, int n_q, int S, int H,
                int K, int dh, Paged pg, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh, kPaged ? pg.bpl : 0);
  auto kern = attention_kernel<T, NC, kCausal, kPaged, kLongestFirst>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_tiles = (n_q * (H / K) + kRows - 1) / kRows;
  const dim3 grid = kLongestFirst ? dim3(n_tiles * K * B)
                                  : dim3(n_tiles, K, B);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), n_q, S, H, K, dh, scale, pg);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  dh in [8, 256], a multiple of 8 (the
// wrappers of the dense kernels take dh >= 16, the paged one dh >= 8).
// Paged: S = pg.bpl * pg.bs, and pg.bt a (B, pg.bpl) table into a pool of
// pg.n_blocks blocks.
template <bool kCausal, bool kPaged, bool kLongestFirst = false>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* out, int B, int n_q, int S,
                     int H, int K, int dh, int dtype, cudaStream_t stream,
                     Paged pg = Paged()) {
  if (dh < 8 || dh > 256 || dh % 8 || K < 1 || H % K || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  if (kPaged && (pg.bt == nullptr || pg.bpl < 1 || pg.bs < 1 ||
                 pg.n_blocks < 1 || (long)pg.bpl * pg.bs != S))
    return cudaErrorInvalidValue;
  if (B == 0 || n_q == 0) return cudaSuccess;
#define ATTN_CASE(NC)                                                        \
  case NC:                                                                   \
    return dtype == 0                                                        \
               ? run<float, NC, kCausal, kPaged, kLongestFirst>(             \
                     q, k, v, mask, out, B, n_q, S, H, K, dh, pg, stream)    \
               : run<__nv_bfloat16, NC, kCausal, kPaged, kLongestFirst>(     \
                     q, k, v, mask, out, B, n_q, S, H, K, dh, pg, stream);
  switch ((dh + 31) / 32) {
    ATTN_CASE(1) ATTN_CASE(2) ATTN_CASE(3) ATTN_CASE(4)
    ATTN_CASE(5) ATTN_CASE(6) ATTN_CASE(7) ATTN_CASE(8)
  }
#undef ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace attn
