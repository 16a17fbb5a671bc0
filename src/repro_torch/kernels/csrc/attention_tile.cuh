// Shared body of the port's attention kernels (tree-verification decode
// attention on the dense and on the paged KV layout, and causal flash
// prefill): GQA attention of a tile of query rows against one KV head, with
// an online softmax carried in f32 registers.  Two arithmetics: bf16 inputs
// run on the tensor cores (mma_attention_kernel), f32 inputs on the CUDA
// cores (attention_kernel).
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
// memory at block start).  Key tiles stay on LOGICAL positions s0 = 0, w,
// 2w, ... in both, so a row's arithmetic does not depend on the layout: the
// paged kernel gives the dense kernel's bits on the same logical K/V.
// A block owns (lane b, KV head kh, a tile of consecutive grouped rows),
// where grouped row r = t * G + g is query position t of head kh * G + g:
// the G heads that share a KV head share every K/V tile the block stages.
// The work-order hook (template parameter kLongestFirst, causal only) is how
// blocks map to those items: a 3-D grid (row tile fastest, then kh, then b),
// or a 1-D grid whose block i takes the row tile n_tiles - 1 - i / (K * B)
// — the causal row tiles in falling order of length, so the launch's tail
// is short blocks — at the same tile body and the same key tiles.
//
// Masked scores contribute exactly 0 (p is zeroed, as in tree_attention_ref),
// so a row with no visible key returns 0, and a tile that is fully masked for
// a row leaves that row's (m, l, acc) bit-identical (p = 0, and the rescale
// factor is exactly 1) — which makes a row's result independent of which
// block computed it, of the batch, of the tree width and of which tiles a
// kernel skips.  The serving path's losslessness relies on it: the paged
// kernel gives the dense kernel's bits, the triangular-schedule prefill the
// plain prefill's, and the prefix cache's suffix prefill (the paged kernel
// at (1, bucket)) the uncached admission's (the causal kernel).
//
// bf16 (mma_attention_kernel): a block has mma_warps() row warps of 16
// grouped rows (one m16 tile each) times kKeyGroups key groups.  Key group g runs
// the logical key tiles i with i % kKeyGroups == g, so the warps of a row
// warp's groups walk the keys side by side; at the end the groups' states
// (m, l, acc) are merged in group order through shared memory.  Q is staged
// once in shared memory as bf16, zero-padded from dh to DP = 16 *
// ceil(dh / 16) (exact zeros in every product), and loaded into the mma's A
// fragments (held in registers for dh <= 128).  Key tiles of 64 keys (32 for
// dh > 128, 16 for dh > 192): a round of kKeyGroups consecutive tiles — K, V and the block's
// mask rows over them — is staged once per block, in bf16, into a ring of
// kStages shared-memory stages filled by 16-byte cp.async, the next round's
// copies in flight while this one's products run.  S = Q.K^T and acc += P.V
// run on mma.sync.m16n8k16 (bf16 products, f32 sums) with ldmatrix
// operands; the online softmax runs on the accumulator fragments, in the
// log2 domain on the special-function unit (ex2).  What the bits rest on,
// the same in all four kernels at a given dh:
//   - the key groups, the tile width w and the logical tile positions
//     s0 = 0, w, 2w, ...;
//   - the k-steps over dh in ascending order into a zeroed accumulator;
//   - a row's max and sum: over the thread's columns in column order, then
//     across its quad by xor-1 then xor-2 shuffles; every f32 add, multiply
//     and fma is an explicit round-to-nearest intrinsic, so no contraction
//     can differ between instantiations;
//   - P enters P.V as bf16 hi = bf16(p) plus bf16 lo = bf16(p - hi), for
//     each k16 step in ascending key order, hi before lo;
//   - a masked p is exactly 0 and the rescale factor of a max that holds
//     exactly 1;
//   - the merge of the key groups' states, in group order.
// What may vary and changes no bits: the row warps per block, the stages,
// the work order, and the skipping of tiles no row of a block (or of a
// warp) sees — causal: every tile past the diagonal of the block's last row;
// tree: the tiles a prologue scan of the block's mask rows finds empty.
//
// f32 (attention_kernel): per key tile of kKeys = 32 rows the block stages K
// and V into shared memory as f32 (K with a padded pitch, so lane j reading
// key j is conflict-free), then each warp walks its kRowsPerWarp rows: lane
// j scores key j, the warp reduces max and sum with shuffles, and every lane
// accumulates its dh/32 output columns.  TF32 would miss the f32 checks, so
// f32 stays on the CUDA cores.
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 16-byte vector load of kVec elements, converted to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
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

// ------------------------------------------------------------------ bf16
// The tensor-core body.  Every bf16 kernel (B1-B4) runs it, so the
// bit-equalities between them hold by construction; see the top of this
// file for what is fixed and what may vary.

// row warps (16 grouped rows each) a block, picked by measurement at the
// serving path's shapes (PERF.md): 2 for the dense tree kernel, 4 for the
// paged tree and the prefill kernels.  The row warps are the schedule: they
// move no bits.
__host__ __device__ constexpr int mma_warps(bool causal, bool paged) {
  return causal || paged ? 4 : 2;
}
// rounds in the cp.async ring: two (a third does not fit in shared memory
// beside two groups' 64-key tiles at dh = 128)
constexpr int kStages = 2;
// key groups: group g runs the logical key tiles i with i % kKeyGroups == g,
// and the groups' states are merged in group order at the end.  The key
// groups and the tile width are part of the arithmetic: the same in every
// kernel, so changing either moves all four kernels' bits together.
constexpr int kKeyGroups = 2;
// keys per tile: 64; 32 for dh > 128, where the ring of the groups' tiles
// would outgrow shared memory; 16 for dh > 192, where the scores' registers
// next to the dh / 2 accumulators would spill
__host__ __device__ constexpr int mma_keys(int nd) {
  return nd > 12 ? 16 : (nd > 8 ? 32 : 64);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy that bypasses the registers; nbytes = 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}
// d += a (16x16, row) * b (16x8, col): bf16 products, f32 sums.  kOrdered
// keeps the products in program order with the operand loads, which bounds
// the registers the compiler's schedule holds live (for dh > 192)
template <bool kOrdered = false>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (kOrdered)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x on the special-function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// the factor that takes a state from max m to max m_new >= m: exactly 1
// when the max holds (so a tile a row does not see leaves its state
// bit-identical), 0 from the initial -1e30
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == m_new ? 1.f : ex2(__fsub_rn(m, m_new));
}
// q = s / d and r = s % d for 0 <= s, 1 <= d, from d's reciprocal (one
// correction step below 2^22)
__device__ __forceinline__ void divmod(int s, int d, float inv, int& q,
                                       int& r) {
  q = __float2int_rz(__fmul_rn(__int2float_rn(s), inv));
  r = s - q * d;
  while (r < 0) {
    --q;
    r += d;
  }
  while (r >= d) {
    ++q;
    r -= d;
  }
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) = hi + lo with hi = bf16(x, y) and lo = bf16 of the remainder (the
// remainder itself is exact in f32), so P.V keeps ~16 bits of each p
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(x, f.x),
                                         __fsub_rn(y, f.y)));
}

inline size_t mma_smem_bytes(int nd, int table_entries, int n_key_tiles,
                             bool causal, bool paged) {
  const size_t pitch = 16 * nd + 8, rows = 16 * mma_warps(causal, paged);
  const size_t w = mma_keys(nd), n_rounds = (n_key_tiles + kKeyGroups - 1)
                                            / kKeyGroups;
  return 2 * pitch * (rows + kStages * kKeyGroups * 2 * w)
         + sizeof(int) * (size_t)table_entries
         + (causal ? 0 : kStages * kKeyGroups * rows * w
                         + sizeof(int) * (n_rounds + 1) + n_key_tiles);
}

// ND = ceil(dh / 16): the k-steps of Q.K^T and the pairs of 8-column output
// tiles of P.V.  Block: kKeyGroups x RW warps; warp w is row warp
// rw = w % RW (grouped rows row0 + 16 rw ... + 15) of key group kg = w / RW
// (the logical key tiles i with i % kKeyGroups == kg).
template <int ND, bool kCausal, bool kPaged, bool kLongestFirst>
__global__ void __launch_bounds__(kKeyGroups * mma_warps(kCausal, kPaged) * 32,
                                  1)
mma_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int n_q, int S, int H,
                     int K, int dh, float scale, Paged pg) {
  static_assert(kCausal || !kLongestFirst, "work order: causal only");
  constexpr int KG = kKeyGroups;
  constexpr int RW = mma_warps(kCausal, kPaged);
  constexpr int kRowsB = 16 * RW;
  constexpr int W = mma_keys(ND);
  constexpr int DP = 16 * ND;          // dh zero-padded to the k depth
  constexpr int PITCH = DP + 8;        // smem row pitch: rows 16 B apart in
                                       // the banks, so ldmatrix is
                                       // conflict-free
  constexpr int CH = DP / 8;           // 16-byte chunks of a padded row
  constexpr int NT = KG * RW * 32;
  constexpr bool kQRegs = ND <= 8;     // Q fragments kept in registers
  constexpr bool kOrdered = ND > 12;
  const int G = H / K;
  const int n_rows = n_q * G;
  int b, kh, tile;
  if (kLongestFirst) {
    const int n_tiles = (n_rows + kRowsB - 1) / kRowsB;
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
  const int row0 = tile * kRowsB;
  const int last_row = min(row0 + kRowsB, n_rows) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % RW, kg = warp / RW;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_kt = (S + W - 1) / W;                 // logical key tiles
  const int n_rt = (n_kt + KG - 1) / KG;            // rounds of KG tiles
  const float inv_bs = kPaged ? 1.f / pg.bs : 0.f;

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  // kStages x KG x (K, V) x W rows; after the loop, the partial states of
  // key groups 1 ...
  __nv_bfloat16* kvs = qs + kRowsB * PITCH;
  uint8_t* mks = reinterpret_cast<uint8_t*>(kvs + kStages * KG * 2 * W * PITCH);
                                            // kStages x KG x kRowsB x W (tree)
  int* bts = reinterpret_cast<int*>(
      mks + (kCausal ? 0 : kStages * KG * kRowsB * W));
  int* list = bts + (kPaged ? pg.bpl : 0);  // active rounds, in order
  int* n_list = list + n_rt;
  uint8_t* flags = reinterpret_cast<uint8_t*>(n_list + 1);

  // the block's query rows by cp.async (the first group), zero past n_rows
  // and past dh
  for (int i = tid; i < kRowsB * CH; i += NT) {
    const int rl = i / CH, c = i - rl * CH, r = row0 + rl;
    const bool ok = r < n_rows && c * 8 < dh;
    const __nv_bfloat16* src = q;
    if (ok) src = q + (((long)b * n_q + r / G) * H + kh * G + r % G) * dh
                  + c * 8;
    cp_async16(smem_addr(qs + rl * PITCH + c * 8), src, ok ? 16 : 0);
  }
  cp_async_commit();
  if (kPaged) {
    // the lane's table row; an entry outside the pool is clamped into it
    // (memory safety only: the serving path never writes one)
    for (int i = tid; i < pg.bpl; i += NT)
      bts[i] = min(max(pg.bt[(long)b * pg.bpl + i], 0), pg.n_blocks - 1);
  }
  // the k padding of every staged K/V row (dh % 16 == 8): exact zeros that
  // the copies never overwrite
  if (dh < DP)
    for (int i = tid; i < kStages * KG * 2 * W; i += NT)
      *reinterpret_cast<uint4*>(kvs + i * PITCH + dh) = make_uint4(0, 0, 0, 0);

  // the block's mask rows (query positions t_lo ... t_lo + nt - 1); read in
  // 16-byte chunks where every row starts on one
  const int t_lo = row0 / G, nt = last_row / G - t_lo + 1;
  const uint8_t* mb = kCausal ? mask : mask + ((long)b * n_q + t_lo) * S;
  const bool m16 = !kCausal && (S & 15) == 0
                   && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;

  // the key tiles the block runs: causal, every tile up to the diagonal of
  // its last row; tree, the tiles in which some row of the block sees a key.
  // Rounds of KG consecutive tiles with any such tile are run in order.
  const int n_ct = kCausal ? min(n_kt, (last_row / G) / W + 1) : 0;
  int n_act;
  if (kCausal) {
    n_act = (n_ct + KG - 1) / KG;
  } else {
    for (int i = tid; i < n_kt; i += NT) flags[i] = 0;
    __syncthreads();
    if (m16) {
      const int cpr = S >> 4;
#pragma unroll 4
      for (int i = tid; i < nt * cpr; i += NT) {
        const int t = i / cpr, c = i - t * cpr;
        const uint4 x =
            *reinterpret_cast<const uint4*>(mb + (long)t * S + 16 * c);
        if (x.x | x.y | x.z | x.w) flags[(16 * c) / W] = 1;
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < nt * S; i += NT) {
        const int t = i / S, s = i - t * S;
        if (mb[(long)t * S + s]) flags[s / W] = 1;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int base = 0; base < n_rt; base += 32) {
        const int r = base + lane;
        bool f = false;
#pragma unroll
        for (int g = 0; g < KG; ++g)
          f |= r < n_rt && KG * r + g < n_kt && flags[KG * r + g];
        const unsigned bal = __ballot_sync(kFull, f);
        if (f) list[count + __popc(bal & ((1u << lane) - 1))] = r;
        count += __popc(bal);
      }
      if (lane == 0) *n_list = count;
    }
  }
  __syncthreads();
  if (!kCausal) n_act = *n_list;
  // does the block run logical tile i (of an active round)?
  auto active = [&](int i) {
    return kCausal ? i < n_ct : i < n_kt && flags[i] != 0;
  };

  // active round a into ring stage a % kStages as one cp.async group (empty
  // past the last round, so every thread's group count stays in step): for
  // each of its tiles the block runs, the K and V rows, zero-filled past S,
  // and (tree) the block's mask rows over its keys
  auto issue = [&](int a) {
    if (a < n_act) {
      const int st = a % kStages, r = kCausal ? a : list[a];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const int it = KG * r + g, s0 = it * W;
        if (!active(it)) continue;
        __nv_bfloat16* ks = kvs + (st * KG + g) * 2 * W * PITCH;
        __nv_bfloat16* vs = ks + W * PITCH;
        for (int i = tid; i < W * CH; i += NT) {
          const int j = i / CH, c = i - j * CH, s = s0 + j;
          if (c * 8 >= dh) continue;
          long row = 0;
          if (s < S) {
            if (kPaged) {
              int blk, off;
              divmod(s, pg.bs, inv_bs, blk, off);
              row = (long)bts[blk] * pg.bs + off;
            } else {
              row = (long)b * S + s;
            }
          }
          const long off = (row * K + kh) * dh + c * 8;
          const int n = s < S ? 16 : 0;
          cp_async16(smem_addr(ks + j * PITCH + c * 8), k + off, n);
          cp_async16(smem_addr(vs + j * PITCH + c * 8), v + off, n);
        }
        if (kCausal) continue;
        uint8_t* mst = mks + (st * KG + g) * kRowsB * W;
        if (m16) {
          for (int i = tid; i < nt * (W / 16); i += NT) {
            const int t = i / (W / 16), c = i - t * (W / 16);
            const int s = s0 + 16 * c;
            cp_async16(smem_addr(mst + t * W + 16 * c),
                       s < S ? mb + (long)t * S + s : mb, s < S ? 16 : 0);
          }
        } else {
          // plain stores, seen after the __syncthreads of round a's turn
          for (int i = tid; i < nt * W; i += NT) {
            const int t = i / W, j = i - t * W, s = s0 + j;
            mst[t * W + j] = s < S ? mb[(long)t * S + s] : 0;
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int a = 0; a < kStages - 1; ++a) issue(a);

  // this thread's two rows of the warp's 16: ra = wrow0 + gid and rb = ra + 8
  const int wrow0 = row0 + 16 * rw;
  const bool warp_live = wrow0 < n_rows;
  const int w_last = min(wrow0 + 15, n_rows - 1);
  const int ra = wrow0 + gid, rb = ra + 8;
  const int ta = ra / G, tb = rb / G;
  const uint32_t q_base = smem_addr(qs + (16 * rw + (lane & 15)) * PITCH
                                    + (lane >> 4) * 8);
  uint32_t qf[kQRegs ? ND : 1][4];

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[2 * ND][4];
#pragma unroll
  for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int a = 0; a < n_act; ++a) {
    cp_async_wait<kStages - 2>();
    __syncthreads();           // round a staged; every warp done with a - 1
    issue(a + kStages - 1);
    if (kQRegs && a == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? ND : 1); ++kk)
        ldsm_x4(q_base + 32 * kk, qf[kk]);
    }
    const int st = a % kStages;
    const int it = KG * (kCausal ? a : list[a]) + kg, s0 = it * W;
    // visibility of this thread's 16 columns (j * 8 + 2 * tig + e, e < 2) of
    // each row: bit 2j + e
    uint32_t vm[2] = {0u, 0u};
    bool live;
    if (kCausal) {
      live = warp_live && it < n_ct && s0 <= w_last / G;
      const int lim_a = ta - s0 - 2 * tig, lim_b = tb - s0 - 2 * tig;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vm[0] |= (uint32_t)(8 * j + e <= lim_a) << (2 * j + e);
          vm[1] |= (uint32_t)(8 * j + e <= lim_b) << (2 * j + e);
        }
    } else {
      if (active(it)) {
        const uint8_t* mst = mks + (st * KG + kg) * kRowsB * W + 2 * tig;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if ((hr ? rb : ra) >= n_rows) continue;
          const uint8_t* mr = mst + ((hr ? tb : ta) - t_lo) * W;
#pragma unroll
          for (int j = 0; j < W / 8; ++j) {
            // byte loads: one 16-bit load split into its two bytes lost
            // the even columns of the fourth 8-key column tile on the card
            // (nvcc 12.8, sm_90a), while the byte loads are exact
            vm[hr] |= (uint32_t)(mr[8 * j] != 0) << (2 * j);
            vm[hr] |= (uint32_t)(mr[8 * j + 1] != 0) << (2 * j + 1);
          }
        }
      }
      live = __any_sync(kFull, (vm[0] | vm[1]) != 0);
    }
    if (!live) continue;       // no row of this warp sees the tile: its
                               // state would stay bit-identical
    const __nv_bfloat16* ks = kvs + (st * KG + kg) * 2 * W * PITCH;
    const __nv_bfloat16* vs = ks + W * PITCH;

    // S = Q.K^T: for each 8-key column tile, the k-steps over dh in order
    float sc[W / 8][4];
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint32_t k_base = smem_addr(
        ks + ((lane >> 4) * 8 + (lane & 7)) * PITCH + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qa[4];
      if (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kQRegs ? kk : 0][e];
      } else {
        ldsm_x4(q_base + 32 * kk, qa);
      }
#pragma unroll
      for (int jp = 0; jp < W / 16; ++jp) {
        uint32_t kb[4];
        ldsm_x4(k_base + 2 * (16 * jp * PITCH + 16 * kk), kb);
        mma_bf16<kOrdered>(sc[2 * jp], qa, kb[0], kb[1]);
        mma_bf16<kOrdered>(sc[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax on the fragments: element e of column tile j is row
    // (e < 2 ? ra : rb), key s0 + 8j + 2tig + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, bit = 2 * j + (e & 1);
        const float x = (vm[hr] >> bit) & 1 ? __fmul_rn(sc[j][e], scale)
                                            : kNegInf;   // log2 domain
        sc[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
      const float m_new = fmaxf(m_r[hr], mx[hr]);
      alpha[hr] = rescale(m_r[hr], m_new);
      m_r[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, bit = 2 * j + (e & 1);
        const float p = (vm[hr] >> bit) & 1
                            ? ex2(__fsub_rn(sc[j][e], m_r[hr])) : 0.f;
        sc[j][e] = p;
        rs[hr] = __fadd_rn(rs[hr], p);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] = __fadd_rn(rs[hr], __shfl_xor_sync(kFull, rs[hr], 1));
      rs[hr] = __fadd_rn(rs[hr], __shfl_xor_sync(kFull, rs[hr], 2));
      l_r[hr] = __fmaf_rn(l_r[hr], alpha[hr], rs[hr]);
    }
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fmul_rn(acc[n][e], alpha[e >> 1]);

    // acc += P.V, P from the score fragments straight into the A operand
    // (column tiles 2kv and 2kv + 1 are the k16 step kv), as bf16 hi + lo
    const uint32_t v_base = smem_addr(
        vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH + (lane >> 4) * 8);
#pragma unroll
    for (int kv = 0; kv < W / 16; ++kv) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kv][0], sc[2 * kv][1], ph[0], pl[0]);
      split_bf16(sc[2 * kv][2], sc[2 * kv][3], ph[1], pl[1]);
      split_bf16(sc[2 * kv + 1][0], sc[2 * kv + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kv + 1][2], sc[2 * kv + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < ND; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(v_base + 2 * (16 * kv * PITCH + 16 * np), vb);
        mma_bf16<kOrdered>(acc[2 * np], ph, vb[0], vb[1]);
        mma_bf16<kOrdered>(acc[2 * np], pl, vb[0], vb[1]);
        mma_bf16<kOrdered>(acc[2 * np + 1], ph, vb[2], vb[3]);
        mma_bf16<kOrdered>(acc[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // merge the key groups' states, group 0 first: the states of groups
  // 1 ... pass through shared memory (over the drained ring), in fragment
  // order, since warps rw of every group hold the same rows and elements
  cp_async_wait<0>();          // no copy outlives the block
  float* part = reinterpret_cast<float*>(kvs);
#pragma unroll
  for (int g = 1; g < KG; ++g) {
    __syncthreads();
    if (kg == g) {
      float* d = part + rw * 32 + lane;
      d[0] = m_r[0];
      d[RW * 32] = m_r[1];
      d[2 * RW * 32] = l_r[0];
      d[3 * RW * 32] = l_r[1];
#pragma unroll
      for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[(4 + 4 * n + e) * RW * 32] = acc[n][e];
    }
    __syncthreads();
    if (kg == 0) {
      const float* d = part + rw * 32 + lane;
      float a0[2], a1[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m1 = d[hr * RW * 32];
        const float l1 = d[(2 + hr) * RW * 32];
        const float m_new = fmaxf(m_r[hr], m1);
        a0[hr] = rescale(m_r[hr], m_new);
        a1[hr] = rescale(m1, m_new);
        l_r[hr] = __fadd_rn(__fmul_rn(l_r[hr], a0[hr]), __fmul_rn(l1, a1[hr]));
        m_r[hr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = __fadd_rn(
              __fmul_rn(acc[n][e], a0[e >> 1]),
              __fmul_rn(d[(4 + 4 * n + e) * RW * 32], a1[e >> 1]));
    }
  }
  static_assert((4 + 8 * ND) * RW * 32 * 4
                    <= kStages * KG * 2 * W * PITCH * 2,
                "the merge buffer fits in the ring");
  if (kg != 0 || !warp_live) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = hr ? rb : ra;
    if (r >= n_rows) continue;
    const int t = r / G, h = kh * G + r % G;
    const float inv = __frcp_rn(fmaxf(l_r[hr], 1e-30f));
    __nv_bfloat16* o = out + (((long)b * n_q + t) * H + h) * dh;
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n) {
      const int d = 8 * n + 2 * tig;
      if (d < dh)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            __fmul_rn(acc[n][2 * hr], inv), __fmul_rn(acc[n][2 * hr + 1], inv));
    }
  }
}

template <int ND, bool kCausal, bool kPaged, bool kLongestFirst>
cudaError_t run_mma(const void* q, const void* k, const void* v,
                    const void* mask, void* out, int B, int n_q, int S, int H,
                    int K, int dh, Paged pg, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(ND, kPaged ? pg.bpl : 0,
                                     (S + mma_keys(ND) - 1) / mma_keys(ND),
                                     kCausal, kPaged);
  auto kern = mma_attention_kernel<ND, kCausal, kPaged, kLongestFirst>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int RW = mma_warps(kCausal, kPaged);
  const int rows = 16 * RW;
  const int n_tiles = (n_q * (H / K) + rows - 1) / rows;
  const dim3 grid = kLongestFirst ? dim3(n_tiles * K * B)
                                  : dim3(n_tiles, K, B);
  // the softmax runs in the log2 domain: scores times dh^-0.5 * log2(e)
  const float scale = (float)(1.4426950408889634 / sqrt((double)dh));
  kern<<<grid, kKeyGroups * RW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      n_q, S, H, K, dh, scale, pg);
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
#define ATTN_F32(NC)                                                         \
  case NC:                                                                   \
    return run<float, NC, kCausal, kPaged, kLongestFirst>(                   \
        q, k, v, mask, out, B, n_q, S, H, K, dh, pg, stream);
#define ATTN_BF16(ND)                                                        \
  case ND:                                                                   \
    return run_mma<ND, kCausal, kPaged, kLongestFirst>(                      \
        q, k, v, mask, out, B, n_q, S, H, K, dh, pg, stream);
  if (dtype == 0) {
    switch ((dh + 31) / 32) {
      ATTN_F32(1) ATTN_F32(2) ATTN_F32(3) ATTN_F32(4)
      ATTN_F32(5) ATTN_F32(6) ATTN_F32(7) ATTN_F32(8)
    }
  } else {
    switch ((dh + 15) / 16) {
      ATTN_BF16(1) ATTN_BF16(2) ATTN_BF16(3) ATTN_BF16(4)
      ATTN_BF16(5) ATTN_BF16(6) ATTN_BF16(7) ATTN_BF16(8)
      ATTN_BF16(9) ATTN_BF16(10) ATTN_BF16(11) ATTN_BF16(12)
      ATTN_BF16(13) ATTN_BF16(14) ATTN_BF16(15) ATTN_BF16(16)
    }
  }
#undef ATTN_F32
#undef ATTN_BF16
  return cudaErrorInvalidValue;
}

}  // namespace attn
