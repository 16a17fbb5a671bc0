// Shared body of the port's attention kernels (tree-verification decode
// attention on the dense and on the paged KV layout, and causal flash
// prefill): GQA attention of a tile of query rows against one KV head, with
// an online softmax carried in f32 registers.  Two arithmetics: bf16 inputs
// run on the tensor cores (mma_attention_kernel for the tree kernels,
// prefill_kernel for the causal ones), f32 inputs on the CUDA cores
// (attention_kernel).
//
// Layouts (the public layouts of the JAX wrappers; no grouped copy is made):
//   q, out  (B, n_q, H, dh)     H = K * G
//   k, v    dense: (B, S, K, dh); paged: the block pool (n_blocks, bs, K, dh)
//           shared by every lane, with S = bpl * bs logical positions a lane
//   mask    (B, n_q, S) bool    (tree kernels only; the causal kernels derive
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
// The work-order hook (template parameter kLongestFirst, causal only) is
// how blocks map to those items: a 3-D grid (row tile fastest, then kh,
// then b), or a 1-D grid whose block i takes the row tile n_tiles - 1 - i /
// (K * B) — the causal row tiles in falling order of length, so the
// launch's tail is short blocks.  At dh = 128, where its blocks fill the
// card, the bf16 causal kernel has a schedule of its own (prefill_kernel,
// below).
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
// bf16: warps of 16 grouped rows (one m16 tile each).  Key group g runs the
// logical key tiles i with i % kKeyGroups == g, and at the end the groups'
// states (m, l, acc) are merged in group order.  Q is staged once in shared
// memory as bf16, zero-padded from dh to DP = 16 * ceil(dh / 16) (exact
// zeros in every product), and loaded into the mma's A fragments (held in
// registers for dh <= 128).  Key tiles of 64 keys (32 for dh > 128, 16 for
// dh > 192) are staged once per block, in bf16, into a ring of shared-memory
// stages filled by 16-byte cp.async, the next rounds' copies in flight while
// this one's products run (prefill_kernel: by the tensor memory
// accelerator).  S = Q.K^T and acc += P.V run on mma.sync.m16n8k16 (bf16
// products, f32 sums) with ldmatrix operands (prefill_kernel: on wgmma,
// whose f32 bits are mma.sync's); the
// online softmax runs on the accumulator fragments, in the log2 domain on
// the special-function unit (ex2).  What the bits rest on, the same in all
// four kernels at a given dh (and computed by the same functions: tile_scores,
// tile_softmax, tile_pv, merge_state, store_rows):
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
// the work order, which warp runs a key group and when (side by side on two
// warps, or in sequence on one, the first group's state parked in shared
// memory until the merge), the skipping of tiles no row of a block (or of a
// warp) sees — causal: every tile past the diagonal of the block's last row;
// tree: the tiles a prologue scan of the block's mask rows finds empty — and
// of the rescale multiplies of a warp whose factors are all exactly 1.
//
// f32 (attention_kernel): per key tile of kKeys = 32 rows the block stages K
// and V into shared memory as f32 (K with a padded pitch, so lane j reading
// key j is conflict-free), then each warp walks its kRowsPerWarp rows: lane
// j scores key j, the warp reduces max and sum with shuffles, and every lane
// accumulates its dh/32 output columns.  TF32 would miss the f32 checks, so
// f32 stays on the CUDA cores.
#pragma once

#include <cuda.h>
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
// The tensor-core body.  Every bf16 kernel (B1-B4) computes its tiles
// through the functions of this section (tile_scores, tile_softmax,
// tile_pv, the merge and store_rows), so the bit-equalities between them
// hold by construction; see the top of this file for what is fixed and what
// may vary.

// row warps (16 grouped rows each) a block of the mma.sync kernels, picked
// by measurement at the serving path's shapes (PERF.md): 2 for the dense
// tree kernel, 4 for the paged tree and the causal ones.  The row warps are
// the schedule: they move no bits.
__host__ __device__ constexpr int mma_warps(bool causal, bool paged) {
  return causal || paged ? 4 : 2;
}
// rounds in the mma.sync kernels' cp.async ring: two (a third does not fit in
// shared memory beside two groups' 64-key tiles at dh = 128)
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
// shared-memory row pitch in bf16 elements: dh padded to 16 * nd, plus 8 so
// that rows sit 16 bytes apart in the banks and ldmatrix is conflict-free
__host__ __device__ constexpr int mma_pitch(int nd) { return 16 * nd + 8; }

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

// A warp's online-softmax state over its 16 grouped rows; this thread holds
// rows ra and rb = ra + 8 (index hr = 0, 1): the running max m (log2
// domain), the sum l, and the output accumulator in mma fragment order
// (element e of 8-column tile n: row e < 2 ? ra : rb, column 8n + 2tig +
// (e & 1)).
template <int ND>
struct RowState {
  float m[2], l[2], acc[2 * ND][4];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = kNegInf;
      l[hr] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
};

// a lane's ldmatrix element offsets into staged tiles (pitch P): its Q rows
// at k-step 0 (row warp rw), its K rows for the B operand of S = Q.K^T, its
// V rows (transposed) for the B operand of P.V
__device__ __forceinline__ int q_lane_off(int lane, int rw, int P) {
  return (16 * rw + (lane & 15)) * P + (lane >> 4) * 8;
}
__device__ __forceinline__ int k_lane_off(int lane, int P) {
  return ((lane >> 4) * 8 + (lane & 7)) * P + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int v_lane_off(int lane, int P) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * P + (lane >> 4) * 8;
}

// S = Q.K^T of one W-key tile for a warp's 16 rows: for each 8-key column
// tile, the k-steps over dh in ascending order into a zeroed accumulator.
// Q's A fragments come from qf (kQRegs) or from shared memory at q_base;
// k_base is the lane's ldmatrix address of the tile's K rows.
template <int ND, int W, bool kQRegs, bool kOrdered>
__device__ __forceinline__ void tile_scores(
    float (&sc)[W / 8][4], const uint32_t (&qf)[kQRegs ? ND : 1][4],
    uint32_t q_base, uint32_t k_base) {
  constexpr int PITCH = mma_pitch(ND);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
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
}

// The online-softmax update of a warp's rows by one tile (tile_softmax_p:
// everything but the rescale of acc, which rescale_acc does); element e of
// column tile j is visible iff bit 2j + (e & 1) of vm[e >> 1] is set (every
// element when kMasked is false: a tile that all the warp's rows see whole,
// with the same bits as a full vm).  The
// visible scores times scale (the log2 domain), the row max over the
// thread's columns in column order then across its quad by xor-1 and xor-2
// shuffles, the rescale factor (exactly 1 while the max holds), p = 2^(x -
// m) (exactly 0 where masked), the row sums in the same order, l = l *
// alpha + sum, acc *= alpha.  sc becomes p.
template <int W, bool kMasked = true>
__device__ __forceinline__ void tile_softmax_p(float (&sc)[W / 8][4],
                                               const uint32_t (&vm)[2],
                                               float scale, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
  // bit 2j + (e & 1) of vm[e >> 1]
  auto seen = [&](int j, int e) {
    return !kMasked || ((vm[e >> 1] >> (2 * j + (e & 1))) & 1);
  };
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      const float x = seen(j, e) ? __fmul_rn(sc[j][e], scale) : kNegInf;
      sc[j][e] = x;
      mx[hr] = fmaxf(mx[hr], x);
    }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr]);
    alpha[hr] = rescale(m[hr], m_new);
    m[hr] = m_new;
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      const float p = seen(j, e) ? ex2(__fsub_rn(sc[j][e], m[hr])) : 0.f;
      sc[j][e] = p;
      rs[hr] = __fadd_rn(rs[hr], p);
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] = __fadd_rn(rs[hr], __shfl_xor_sync(kFull, rs[hr], 1));
    rs[hr] = __fadd_rn(rs[hr], __shfl_xor_sync(kFull, rs[hr], 2));
    l[hr] = __fmaf_rn(l[hr], alpha[hr], rs[hr]);
  }
}
// acc *= alpha; a factor of exactly 1 leaves acc as it is, so a warp whose
// rows' maxes all held skips the multiplies (the whole warp runs a tile or
// none)
template <int ND>
__device__ __forceinline__ void rescale_acc(float (&acc)[2 * ND][4],
                                            const float (&alpha)[2]) {
  if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fmul_rn(acc[n][e], alpha[e >> 1]);
  }
}
// the whole update: the tile's p, then the rescale of acc
template <int ND, int W, bool kMasked = true>
__device__ __forceinline__ void tile_softmax(float (&sc)[W / 8][4],
                                             const uint32_t (&vm)[2],
                                             float scale, RowState<ND>& s) {
  float alpha[2];
  tile_softmax_p<W, kMasked>(sc, vm, scale, s.m, s.l, alpha);
  rescale_acc<ND>(s.acc, alpha);
}

// acc += P.V, P from the score fragments straight into the A operand
// (column tiles 2kv and 2kv + 1 are the k16 step kv), as bf16 hi + lo, in
// ascending key order, hi before lo; v_base is the lane's ldmatrix address
// of the tile's V rows
// P's A fragments for k16 step kv (column tiles 2kv and 2kv + 1): bf16 hi
// and lo
template <int W>
__device__ __forceinline__ void split_p(const float (&sc)[W / 8][4], int kv,
                                        uint32_t (&ph)[4], uint32_t (&pl)[4]) {
  split_bf16(sc[2 * kv][0], sc[2 * kv][1], ph[0], pl[0]);
  split_bf16(sc[2 * kv][2], sc[2 * kv][3], ph[1], pl[1]);
  split_bf16(sc[2 * kv + 1][0], sc[2 * kv + 1][1], ph[2], pl[2]);
  split_bf16(sc[2 * kv + 1][2], sc[2 * kv + 1][3], ph[3], pl[3]);
}
template <int ND, int W, bool kOrdered>
__device__ __forceinline__ void tile_pv(float (&acc)[2 * ND][4],
                                        const float (&sc)[W / 8][4],
                                        uint32_t v_base) {
  constexpr int PITCH = mma_pitch(ND);
#pragma unroll
  for (int kv = 0; kv < W / 16; ++kv) {
    uint32_t ph[4], pl[4];
    split_p<W>(sc, kv, ph, pl);
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

// The merge of two consecutive key groups' states, the earlier (m0, l0, x0)
// and the later (m1, l1, x1), in that order whichever holds which:
// merge_factors gives the merged max and sum and each side's factor,
// merge_acc each merged accumulator element.
__device__ __forceinline__ void merge_factors(float m0, float l0, float m1,
                                              float l1, float& m, float& l,
                                              float& a0, float& a1) {
  m = fmaxf(m0, m1);
  a0 = rescale(m0, m);
  a1 = rescale(m1, m);
  l = __fadd_rn(__fmul_rn(l0, a0), __fmul_rn(l1, a1));
}
__device__ __forceinline__ float merge_acc(float x0, float a0, float x1,
                                           float a1) {
  return __fadd_rn(__fmul_rn(x0, a0), __fmul_rn(x1, a1));
}
// a state in memory, element i at d[i * stride]: m (2), l (2), acc (8 ND)
template <int ND>
__device__ __forceinline__ void park_state(const RowState<ND>& s, float* d,
                                           int stride) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    d[hr * stride] = s.m[hr];
    d[(2 + hr) * stride] = s.l[hr];
  }
#pragma unroll
  for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(4 + 4 * n + e) * stride] = s.acc[n][e];
}
// s <- merge(earlier, later): kLaterInMemory says which of the two is the
// state in memory at d (the other is s); d == nullptr stands for an empty
// later group (max -1e30, sum and accumulator 0), which is what a group
// that saw no key holds
template <int ND, bool kLaterInMemory>
__device__ __forceinline__ void merge_state(RowState<ND>& s, const float* d,
                                            int stride) {
  float a0[2], a1[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float md = d ? d[hr * stride] : kNegInf;
    const float ld = d ? d[(2 + hr) * stride] : 0.f;
    float m, l;
    if (kLaterInMemory)
      merge_factors(s.m[hr], s.l[hr], md, ld, m, l, a0[hr], a1[hr]);
    else
      merge_factors(md, ld, s.m[hr], s.l[hr], m, l, a0[hr], a1[hr]);
    s.m[hr] = m;
    s.l[hr] = l;
  }
#pragma unroll
  for (int n = 0; n < 2 * ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xd = d ? d[(4 + 4 * n + e) * stride] : 0.f;
      s.acc[n][e] = kLaterInMemory
                        ? merge_acc(s.acc[n][e], a0[e >> 1], xd, a1[e >> 1])
                        : merge_acc(xd, a0[e >> 1], s.acc[n][e], a1[e >> 1]);
    }
}

// the output rows ra and ra + 8 of a warp (those below n_rows): acc / l,
// rounded once to bf16
template <int ND>
__device__ __forceinline__ void store_rows(const RowState<ND>& s,
                                           __nv_bfloat16* __restrict__ out,
                                           int b, int kh, int G, int n_q,
                                           int H, int dh, int n_rows, int ra,
                                           int tig) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = ra + 8 * hr;
    if (r >= n_rows) continue;
    const int t = r / G, h = kh * G + r % G;
    const float inv = __frcp_rn(fmaxf(s.l[hr], 1e-30f));
    __nv_bfloat16* o = out + (((long)b * n_q + t) * H + h) * dh;
#pragma unroll
    for (int n = 0; n < 2 * ND; ++n) {
      const int d = 8 * n + 2 * tig;
      if (d < dh)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            __fmul_rn(s.acc[n][2 * hr], inv),
            __fmul_rn(s.acc[n][2 * hr + 1], inv));
    }
  }
}

// ------------------------------------------ warpgroup products (wgmma)
// Hopper's asynchronous warpgroup product for the causal kernel's key groups
// in sequence at dh = 128: the four warps of a warpgroup (64 grouped rows,
// warp i rows 16i ... 16i + 15) issue one product of their rows, A from
// registers in the mma.sync fragment layout (Q's fragments; P's hi and lo),
// B from shared memory, the f32 sums in registers in the mma.sync
// accumulator layout (element e of 8-column tile j: row e < 2 ? gid : gid +
// 8, column 8j + 2tig + (e & 1)).  A staged K or V tile (64 keys x 128
// columns) for them is what the tensor memory accelerator writes with
// 128-byte swizzling: two atoms of 64 rows x 128 bytes (columns 0-63 and
// 64-127), the 16-byte chunk c of row j of an atom at byte j * 128 + (c ^
// (j % 8)) * 16; K is read K-major (the k-step over dh), V transposed (the
// k-step over keys).  tests/test_torch_cuda.py probes these products
// against mma.sync's bits.
constexpr int kAtomBytes = 64 * 128;
__host__ __device__ constexpr int wg_chunk(int j, int c) {
  return (c / 8) * kAtomBytes + j * 128 + (((c % 8) ^ (j % 8)) << 4);
}
// shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, the byte offsets between atoms along the columns (lbo; K-major:
// unused) and between groups of 8 rows (sbo)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed product groups are in
// flight (they complete in order)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the accumulators as the completed products left them: no use of them is
// scheduled before the wait
template <int N>
__device__ __forceinline__ void wg_fence_operand(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
}
// the ring's barriers: one arrival (the copies' issuer) and the bytes the
// copies bring complete a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// named barriers among n threads: wait at, or only arrive at, barrier id
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
// one box of a 4-D tensor map into shared memory by the tensor memory
// accelerator, completing on barrier bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// d (16 rows x 64 columns a warp) += a (16 x 16) * B (16 x 64, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (16 rows x 128 columns a warp) += a (16 x 16) * B (16 x 128, B stored
// transposed: its columns contiguous)
__device__ __forceinline__ void wgmma_n128_t(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// tile_scores on the warpgroup (dh = 128, 64-key tiles), issued: the
// k-steps over dh in ascending order into a zeroed accumulator; k_addr is
// the shared address of the tile's K rows
__device__ __forceinline__ void wg_scores_issue(float (&sc)[8][4],
                                                const uint32_t (&qf)[8][4],
                                                uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_n64(sc, qf[kk], wg_desc(k_addr + (kk / 4) * kAtomBytes
                                  + (kk % 4) * 32, 16, 1024));
}
// tile_pv on the warpgroup (dh = 128, 64-key tiles), issued: for each k16
// step over the keys in ascending order, hi then lo; v_addr is the shared
// address of the tile's V rows
__device__ __forceinline__ void wg_pv_issue(float (&acc)[16][4],
                                            const uint32_t (&ph)[4][4],
                                            const uint32_t (&pl)[4][4],
                                            uint32_t v_addr) {
#pragma unroll
  for (int kv = 0; kv < 4; ++kv) {
    const uint64_t desc = wg_desc(v_addr + 2 * kv * 1024, kAtomBytes, 1024);
    wgmma_n128_t(acc, ph[kv], desc);
    wgmma_n128_t(acc, pl[kv], desc);
  }
}
// ----------------------------------------- mma.sync kernels (B1, B2; B3, B4)
// The tree kernels, and the causal kernels wherever the key groups in
// sequence (below) do not pay: a short prompt, or a head width other than
// 128.
inline size_t mma_smem_bytes(int nd, int table_entries, int n_key_tiles,
                             bool causal, bool paged) {
  const size_t pitch = mma_pitch(nd), rows = 16 * mma_warps(causal, paged);
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
// (the logical key tiles i with i % kKeyGroups == kg).  A 3-D grid (row
// tile, KV head, lane), or with kLongestFirst (causal) a 1-D grid whose
// block i takes the row tile n_tiles - 1 - i / (K * B).
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
  constexpr int PITCH = mma_pitch(ND);
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
      const int sg = a % kStages, r = kCausal ? a : list[a];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const int it = KG * r + g, s0 = it * W;
        if (!active(it)) continue;
        __nv_bfloat16* ks = kvs + (sg * KG + g) * 2 * W * PITCH;
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
        uint8_t* mst = mks + (sg * KG + g) * kRowsB * W;
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
  const uint32_t q_base = smem_addr(qs + q_lane_off(lane, rw, PITCH));
  uint32_t qf[kQRegs ? ND : 1][4];
  RowState<ND> st;
  st.clear();

  for (int a = 0; a < n_act; ++a) {
    cp_async_wait<kStages - 2>();
    __syncthreads();           // round a staged; every warp done with a - 1
    issue(a + kStages - 1);
    if (kQRegs && a == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? ND : 1); ++kk)
        ldsm_x4(q_base + 32 * kk, qf[kk]);
    }
    const int sg = a % kStages;
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
        const uint8_t* mst = mks + (sg * KG + kg) * kRowsB * W + 2 * tig;
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
    const uint32_t kb = smem_addr(kvs + (sg * KG + kg) * 2 * W * PITCH);
    float sc[W / 8][4];
    tile_scores<ND, W, kQRegs, kOrdered>(sc, qf, q_base,
                                         kb + 2 * k_lane_off(lane, PITCH));
    tile_softmax<ND, W>(sc, vm, scale, st);
    tile_pv<ND, W, kOrdered>(st.acc, sc,
                             kb + 2 * (W * PITCH + v_lane_off(lane, PITCH)));
  }

  // merge the key groups' states, group 0 first: the states of groups
  // 1 ... pass through shared memory (over the drained ring), in fragment
  // order, since warps rw of every group hold the same rows and elements
  cp_async_wait<0>();          // no copy outlives the block
  float* part = reinterpret_cast<float*>(kvs) + rw * 32 + lane;
#pragma unroll
  for (int g = 1; g < KG; ++g) {
    __syncthreads();
    if (kg == g) park_state(st, part, RW * 32);
    __syncthreads();
    if (kg == 0) merge_state<ND, true>(st, part, RW * 32);
  }
  static_assert((4 + 8 * ND) * RW * 32 * 4
                    <= kStages * KG * 2 * W * PITCH * 2,
                "the merge buffer fits in the ring");
  if (kg != 0 || !warp_live) return;
  store_rows<ND>(st, out, b, kh, G, n_q, H, dh, n_rows, ra, tig);
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

// ------------------------------------- causal prefill in sequence (B3, B4)
// The causal kernels' own schedule at dh = 128, where its 128-row blocks
// fill the card (one a streaming multiprocessor or more; a short prompt
// runs on mma_attention_kernel, whose two key-group warps a row run their
// dependent chains in parallel).  A block has kPrefillWarps = 8 warps in two
// warpgroups of 64 grouped rows, and every warp runs both key groups in
// sequence: group 0's (even) tiles, its state parked in shared memory, then
// group 1's (odd) tiles from a cleared state, merging the parked state in
// as the earlier group — so each staged tile serves twice the rows with
// half the warps a row.  The tensor memory accelerator stages one tile a
// round into a 3-stage ring (its four boxes complete on the stage's
// barrier; the last of the 8 warps done with a stage, counted in shared
// memory, refills it), and the products are wgmma.  The warpgroups take
// turns at the tensor cores (named barriers): a turn issues Q.K^T of round
// a and P.V of round a - 1, and while the other warpgroup's products run,
// this one runs round a's softmax (rescaling acc once round a - 1's P.V has
// landed).  Every turn issues both products, since ptxas serializes wgmma
// on a branch: a tile the warpgroup does not see has its scores computed
// and dropped, and a P.V with no round pending runs on P = 0, which leaves
// acc bit-identical.
// Work order: B3 (kPersistent false) a 3-D grid (row tile, KV head, lane)
// whose blocks take the row tiles in falling order of length; B4 a
// persistent grid of one block a streaming multiprocessor that takes
// (lane, KV head, row tile) items longest first from an atomic counter,
// which the host zeroes on the stream before the launch.  Each block runs
// the key tiles up to the diagonal of its last row; a warpgroup skips those
// past its own, and runs the softmax without the mask on a tile that its
// rows see whole.
constexpr int kPrefillWarps = 8;
constexpr int kPrefillRows = 16 * kPrefillWarps;
constexpr int kPrefillStages = 3;
// bytes of a staged K or V tile: two swizzled atoms
constexpr int kTileBytes = 2 * kAtomBytes;
// floats of a warp's parked state: m (2), l (2), acc (64)
constexpr int kPark = 4 + 8 * 8;

inline size_t prefill_smem_bytes() {
  // the ring (a K and a V tile a stage), the Q rows, the 8 warps' parked
  // states, the ring's barriers and counts and the work-item slots, and
  // 1024 to align the ring's atoms
  return kPrefillStages * 2 * kTileBytes + 2 * mma_pitch(8) * kPrefillRows
         + sizeof(float) * kPrefillWarps * 32 * kPark + 64 + 16 + 1024;
}

template <bool kPersistent>
__global__ void __launch_bounds__(kPrefillWarps * 32, 1)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               __nv_bfloat16* __restrict__ out, int B, int S, int H, int K,
               float scale, int* __restrict__ counter,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v) {
  constexpr int ND = 8, W = 64, dh = 128;
  constexpr int ROWS = kPrefillRows, ST = kPrefillStages;
  constexpr int PITCH = mma_pitch(ND);
  constexpr int CH = dh / 8;
  constexpr int NT = kPrefillWarps * 32;
  static_assert(mma_keys(ND) == W && kKeyGroups == 2,
                "key groups in sequence: two groups of 64-key tiles");
  const int G = H / K, n_rows = S * G;
  const int n_tiles = (n_rows + ROWS - 1) / ROWS;
  const int n_items = n_tiles * K * B;
  const int n_kt = (S + W - 1) / W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wgi = warp / 4;    // the warp's warpgroup

  // ring (ST x (K, V) tiles), Q rows, parked states, barriers, counts,
  // work-item slots
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* kvs = mma_smem + ((1024 - (smem_addr(mma_smem) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(kvs + ST * 2
                                                       * kTileBytes);
  float* park = reinterpret_cast<float*>(qs + ROWS * PITCH);
  uint64_t* bars = reinterpret_cast<uint64_t*>(park + kPrefillWarps * 32
                                                      * kPark);
  int* done = reinterpret_cast<int*>(bars + ST);  // warps done with stage i
  int* slot = done + ST;                           // two work-item slots
  const uint32_t q_base = smem_addr(qs + q_lane_off(lane, warp, PITCH));
  const uint32_t full = smem_addr(bars);   // stage i's barrier: full + 8i
  // this warp's parked group-0 state, element i at i * 32
  float* pk = park + warp * 32 * kPark + lane;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      done[i] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  // warpgroup 0 takes the first turn at the tensor cores (barrier 1 is its
  // turn, barrier 2 warpgroup 1's)
  if (wgi == 1) bar_arrive(1, NT);
  int rbase = 0;               // rounds of the block's earlier items
  // persistent: the next work item, fetched while the block runs the one
  // before it (into slot[i & 1] for the block's i-th item); a block fetches
  // until it draws past the items
  if (kPersistent && tid == 0) slot[0] = atomicAdd(counter, 1);

  for (int nth = 0;; ++nth) {
    int b, kh, tile;
    if (kPersistent) {
      __syncthreads();         // every warp is done with the last item, and
                               // slot[nth & 1] is written
      const int item = slot[nth & 1];
      if (item >= n_items) return;
      if (tid == 0) slot[(nth + 1) & 1] = atomicAdd(counter, 1);
      tile = n_tiles - 1 - item / (K * B);
      kh = item % K;
      b = (item % (K * B)) / K;
    } else {
      b = blockIdx.z;
      kh = blockIdx.y;
      tile = n_tiles - 1 - (int)blockIdx.x;
    }
    const int row0 = tile * ROWS;
    const int last_row = min(row0 + ROWS, n_rows) - 1;

    // the block's query rows by cp.async, zero past n_rows
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int rl = i / CH, c = i - rl * CH, r = row0 + rl;
      const bool ok = r < n_rows;
      const __nv_bfloat16* src = q;
      if (ok) src = q + (((long)b * S + r / G) * H + kh * G + r % G) * dh
                    + c * 8;
      cp_async16(smem_addr(qs + rl * PITCH + c * 8), src, ok ? 16 : 0);
    }
    cp_async_commit();

    // the key tiles up to the diagonal of the block's last row, a round
    // each: group 0's (even) tiles are the first n_ev rounds, group 1's the
    // rest
    const int n_ct = min(n_kt, (last_row / G) / W + 1);
    const int n_ev = (n_ct + 1) / 2;

    const int wrow0 = row0 + 16 * warp;
    const bool warp_live = wrow0 < n_rows;
    const int ra = wrow0 + gid;
    const int ta = ra / G, tb = (ra + 8) / G;
    uint32_t qf[ND][4];
    RowState<ND> st;
    st.clear();

    // the visibility of this thread's 16 columns of rows ra, rb in the tile
    // at key s0 (bit 2j + e: key s0 + 8j + 2tig + e), and the softmax's p
    // and factors; a tile below the diagonal of the warp's first row is
    // seen whole
    auto softmax_p = [&](float (&sc)[W / 8][4], int s0, float (&alpha)[2]) {
      uint32_t vm[2] = {0u, 0u};
      if (s0 + W - 1 <= wrow0 / G) {
        tile_softmax_p<W, false>(sc, vm, scale, st.m, st.l, alpha);
        return;
      }
      const int lim_a = ta - s0 - 2 * tig, lim_b = tb - s0 - 2 * tig;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vm[0] |= (uint32_t)(8 * j + e <= lim_a) << (2 * j + e);
          vm[1] |= (uint32_t)(8 * j + e <= lim_b) << (2 * j + e);
        }
      tile_softmax_p<W>(sc, vm, scale, st.m, st.l, alpha);
    };

    // round a (group 0's tiles, then group 1's) and its ring stage: the
    // barriers keep their phases across a persistent block's items
    auto tile_of = [&](int a) {
      return a < n_ev ? 2 * a : 2 * (a - n_ev) + 1;
    };
    auto stage = [&](int a) { return (rbase + a) % ST; };
    // round a into its stage by the accelerator (one thread); keys past S
    // arrive as zeros
    auto issue = [&](int a) {
      if (a >= n_ct) return;
      const uint32_t bar = full + 8 * stage(a);
      const uint32_t ks = smem_addr(kvs + stage(a) * 2 * kTileBytes);
      const int s0 = tile_of(a) * W;
      mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_load_4d(ks + h * kAtomBytes, &tm_k, 64 * h, kh, s0, b, bar);
        tma_load_4d(ks + kTileBytes + h * kAtomBytes, &tm_v, 64 * h, kh, s0,
                    b, bar);
      }
    };
    // this warp is done with round a's stage; the last warp refills it
    auto release = [&](int a) {
      if (lane == 0 && atomicAdd(done + stage(a), 1) == kPrefillWarps - 1) {
        done[stage(a)] = 0;
        issue(a + ST);
      }
    };
    if (tid == 0)
      for (int a = 0; a < ST; ++a) issue(a);   // the ring is free
    // the warpgroup's last row bounds the tiles it runs
    const int g_last = min(row0 + 64 * wgi + 63, n_rows - 1);
    const bool g_live = row0 + 64 * wgi < n_rows;
    bool pend = false;         // round pend_a's P.V is yet to land
    int pend_a = 0, pv_a = 0;
    uint32_t ph[4][4] = {}, pl[4][4] = {};   // the P of round pv_a
    auto turn = [&](float (&sc)[W / 8][4], int a) {
      bar_sync(1 + wgi, NT);
      wg_fence();
      wg_scores_issue(sc, qf, smem_addr(kvs + stage(a) * 2 * kTileBytes));
      wg_commit();
      wg_pv_issue(st.acc, ph, pl,
                  smem_addr(kvs + stage(pv_a) * 2 * kTileBytes + kTileBytes));
      wg_commit();
      bar_arrive(2 - wgi, NT);
    };
    for (int a = 0; a < n_ct; ++a) {
      if (a == 0) {
        cp_async_wait<0>();
        __syncthreads();       // the Q rows of every warp
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) ldsm_x4(q_base + 32 * kk, qf[kk]);
      }
      mbar_wait(full + 8 * stage(a), ((rbase + a) / ST) & 1);
      if (!pend) pv_a = a;     // a P.V on P = 0 reads a staged tile
      const int s0 = tile_of(a) * W;
      // a tile past the diagonal of the warpgroup's last row: no row of it
      // sees the tile, and its state would stay bit-identical
      const bool run = g_live && s0 <= g_last / G;
      float sc[W / 8][4] = {};
      turn(sc, a);
      wg_wait<1>();            // round a's Q.K^T
      wg_fence_operand(sc);
      if (a == n_ev) {
        // group 0 is done once its last P.V lands: park its state, run
        // group 1 from a cleared one
        wg_wait<0>();
        wg_fence_operand(st.acc);
        if (pend) release(pend_a);
        pend = false;
        park_state(st, pk, 32);
        st.clear();
      }
      float alpha[2];
      if (run) softmax_p(sc, s0, alpha);
      wg_wait<0>();            // round a - 1's P.V
      wg_fence_operand(st.acc);
      if (pend) release(pend_a);
      pend = run;
      pend_a = pv_a = a;
      if (run) {
        rescale_acc<ND>(st.acc, alpha);
#pragma unroll
        for (int kv = 0; kv < 4; ++kv) split_p<W>(sc, kv, ph[kv], pl[kv]);
      } else {
#pragma unroll
        for (int kv = 0; kv < 4; ++kv)
#pragma unroll
          for (int i = 0; i < 4; ++i) ph[kv][i] = pl[kv][i] = 0u;
        release(a);
      }
    }
    // the last turn: the last round's P.V (its scores dropped)
    float sc[W / 8][4] = {};
    turn(sc, pv_a);
    wg_wait<0>();
    wg_fence_operand(st.acc);
    if (pend) release(pend_a);

    // group 0's state is parked if the block ran group 1's tiles; else it
    // is the registers' and group 1's is empty
    if (warp_live) {
      if (n_ct > n_ev)
        merge_state<ND, false>(st, pk, 32);
      else
        merge_state<ND, true>(st, nullptr, 0);
      store_rows<ND>(st, out, b, kh, G, S, H, dh, n_rows, ra, tig);
    }
    rbase += n_ct;
    if (!kPersistent) return;
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the libraries link the CUDA runtime alone)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess
        && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}
// K or V (B, S, K, 128) bf16 as a 4-D tensor (128, K, S, B), boxes of (64
// columns, one head, 64 keys, one lane) with 128-byte swizzling; keys past
// S read as zeros
inline cudaError_t kv_tensor_map(CUtensorMap* map, const void* base, int B,
                                 int S, int K) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {128, (cuuint64_t)K, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {256ull, 256ull * K, 256ull * K * S};
  const cuuint32_t box[4] = {64, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Under CUDA-graph capture (the serving session captures each step): the
// tensor maps are encoded on the host from the K/V addresses at capture and
// passed by value, so every replay reads those addresses again -- valid
// only because a captured graph's buffers are static (the session copies
// each call's inputs into them).  cudaFuncSetAttribute, the entry-point
// query and the device queries are host calls that capture permits; the
// work counter's cudaMemsetAsync is a stream operation, captured with the
// launch, so each replay zeroes it again.
template <bool kPersistent>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int K, int n_items,
                           int n_sm, int* counter, cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes();
  auto kern = prefill_kernel<kPersistent>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  CUtensorMap tm_k = {}, tm_v = {};
  if (err == cudaSuccess) err = kv_tensor_map(&tm_k, k, B, S, K);
  if (err == cudaSuccess) err = kv_tensor_map(&tm_v, v, B, S, K);
  if (kPersistent && err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int n_tiles = n_items / (K * B);
  const dim3 grid = kPersistent ? dim3(min(n_items, n_sm))
                                : dim3(n_tiles, K, B);
  const float scale = (float)(1.4426950408889634 / sqrt(128.0));
  kern<<<grid, kPrefillWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), B, S, H, K, scale, counter, tm_k,
      tm_v);
  return cudaGetLastError();
}

// the key groups in sequence where their 128-row blocks fill the card (at
// dh = 128), else the mma.sync kernel
template <int ND, bool kPersistent>
cudaError_t run_prefill(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int K, int dh,
                        int* counter, cudaStream_t stream) {
  if constexpr (ND == 8) {
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    const int n_items = (S * (H / K) + kPrefillRows - 1) / kPrefillRows * K
                        * B;
    if (dh == 128 && n_items >= n_sm)
      return launch_prefill<kPersistent>(q, k, v, out, B, S, H, K, n_items,
                                         n_sm, counter, stream);
  }
  return run_mma<ND, true, false, kPersistent>(
      q, k, v, nullptr, out, B, S, S, H, K, dh, Paged(), stream);
}

// dtype: 0 = float32, 1 = bfloat16.  dh in [8, 256], a multiple of 8 (the
// wrappers of the dense kernels take dh >= 16, the paged one dh >= 8).
// Paged: S = pg.bpl * pg.bs, and pg.bt a (B, pg.bpl) table into a pool of
// pg.n_blocks blocks.  Causal bf16 with kLongestFirst (B4): counter, one
// int32 of scratch on the device, which the launch zeroes where it uses it.
template <bool kCausal, bool kPaged, bool kLongestFirst = false>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* out, int B, int n_q, int S,
                     int H, int K, int dh, int dtype, cudaStream_t stream,
                     Paged pg = Paged(), int* counter = nullptr) {
  static_assert(kCausal || !kLongestFirst, "work order: causal only");
  if (dh < 8 || dh > 256 || dh % 8 || K < 1 || H % K || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  if (kPaged && (pg.bt == nullptr || pg.bpl < 1 || pg.bs < 1 ||
                 pg.n_blocks < 1 || (long)pg.bpl * pg.bs != S))
    return cudaErrorInvalidValue;
  if (kCausal && (n_q != S || (kLongestFirst && dtype == 1 && !counter)))
    return cudaErrorInvalidValue;
  if (B == 0 || n_q == 0) return cudaSuccess;
#define ATTN_F32(NC)                                                         \
  case NC:                                                                   \
    return run<float, NC, kCausal, kPaged, kLongestFirst>(                   \
        q, k, v, mask, out, B, n_q, S, H, K, dh, pg, stream);
#define ATTN_BF16(ND)                                                        \
  case ND:                                                                   \
    if constexpr (kCausal)                                                   \
      return run_prefill<ND, kLongestFirst>(q, k, v, out, B, S, H, K, dh,    \
                                            counter, stream);                \
    else                                                                     \
      return run_mma<ND, false, kPaged, false>(                              \
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
