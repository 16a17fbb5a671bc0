// Fused EmbeddingBag (gather + weighted reduce) on Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag/embedding_bag.py:20 ::_kernel
// (launched by embedding_bag_kernel, reached through ops.py
// ::embedding_bag_fused): for each bag n,
//     out[n, :] = sum_l w[n, l] * table[ids[n, l], :]
// accumulated in f32 in l order from 0 (acc + row * w, each rounded: no
// fused multiply-add, as the Pallas kernel's separate product and sum),
// rounded once to the table's dtype.  The slot weight is formed here as the
// wrapper's fold_weights forms it: w[n, l] = weights[n, l] * mask[n, l],
// either factor 1 where it is not given, so a negative weight under a
// masked slot is -0.0 as there.  No (N, L, D) gathered intermediate and no
// folded weight array exist.  A stacked table (F, V, D) serves F fields in
// one launch: bag n belongs to field f = n % F and reads row f * V + id.
// Ids follow jnp.take, as the reference's model path does: an id in [-V, 0)
// wraps to id + V, an id at or past V or below -V gives a NaN row (NaN under
// a zero weight too); an id is checked against its field's V, never the
// flattened F * V, so it never reads another field's row, and the kernel
// never reads outside the table.  A masked slot still reads its row and
// multiplies it by 0, so a NaN or Inf in the table gives NaN as jnp.take's
// path does.
//
// A row window (embedding_bag_window_launch): the table is one rank's
// block of rows [row_start, row_start + Vl) of a table of V rows split over
// the ranks (a recommender's table_rows over the model axis).  An id wraps
// by the global V as above; an id in the window reads row id - row_start of
// the block; an id in [0, V) outside the window reads nothing and adds a
// zero row (0 * w), so the ranks' partial bags sum to the whole bag and
// none of them is NaN for an id that another rank holds; an id out of the
// global range gives the NaN row on every rank, as the reference's mesh
// program gives NaN after its masked gather and all-reduce.  Without a
// window (row_start 0, Vl = V) no id falls outside it, and the kernel does
// what it did before, bit for bit.
//
// Route: CUDA C++ built by nvcc with a plain C interface and loaded with
// ctypes, like the port's other kernels.
//
// Bound: bytes.  Wide & Deep serve_bulk (10,485,760 bags of 4 over 40 x 10^6
// rows) reads ~26 M distinct rows: 3.3 GB of 128-byte deep rows, plus the
// ids and mask (0.21 GB) and the output (1.34 GB), ~1.45 ms at 3.35 TB/s;
// every gather is a random row of a 5.1 GB table, so it comes from HBM.  A
// wide (D = 1) row is 4 bytes, but a read moves its whole 32-byte sector:
// the ~26 M distinct wide rows lie in ~5.0 M distinct sectors, nearly the
// whole 160 MB table, ~0.12 ms with the ids, mask and output.  Two
// operations per gathered element are nothing beside that.
//
// Design, for bytes in flight and few instructions per byte:
// - A group of lanes per bag, each lane owning 16 bytes of the output row
//   (4 f32 or 8 bf16): at D = 32 f32, 8 lanes a bag and 4 bags a warp, and
//   a row's 128 bytes are one coalesced read by its group.  Rows wider than
//   32 vectors loop over column chunks.  D = 1, widths that are not a
//   multiple of the vector, and tables whose storage is not 16-byte aligned
//   take the scalar slice (one element a lane, the same code); at D = 1 one
//   thread owns a whole bag, its L gathers in flight together.
// - Index arithmetic once a bag, in 32 bits: the bag and its field from
//   the group's place (one division by the tile's field count), the id
//   checks; only the row address is 64-bit.  No 64-bit division.
// - All of a bag's row loads (L at a time up to kSlots) are issued before
//   the first add, as read-only loads; at L = 4 a bag's ids, mask bytes and
//   weights are read once a lane as one vector each.  The ids, mask,
//   weights and output stream through with evict-first hints.
// - One bag a group and no loop over bags.  A stacked table whose fields
//   fit in L2 several times over (the wide tables: 4 MB a field) is walked
//   a tile of fields at a time (grid (x, tiles), x fastest; kTileBytes of
//   tables a tile), so the blocks in flight gather from rows that L2
//   holds, where bag order would spread them over all F fields (160 MB),
//   and a tile's bags of one row of ids still lie side by side.  Larger
//   fields (the deep tables: 128 MB) keep bag order (one tile of all F).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;              // row loads in flight before the adds
constexpr unsigned kNanF32 = 0x7fc00000u;
// A stacked table's bags go a tile of fields at a time where the tile's
// tables take at most this many bytes: the blocks in flight then gather
// from rows that stay in the 50 MB L2, not from all F fields' at once.
constexpr size_t kTileBytes = 16u << 20;

struct Args {
  const void* table;
  const int* ids;
  const uint8_t* mask;                 // null: every slot valid
  const float* w;                      // null: weight 1
  void* out;
  int n_bags, L, F, V, D;
  int row_start, Vl;                   // the block's rows of the V: window
  int group_log2;                      // lanes per bag = 1 << group_log2
  int n_chunks;                        // column chunks of a row (D / kVec)
  int per_field;                       // bags of one field (n_bags / F)
  int tile;                            // fields a tile: blockIdx.y's
};

// One lane's slice of a row, kVec elements of T kept as their raw words.
template <typename T, int kVec>
struct Slice;

template <>
struct Slice<float, 4> {
  uint4 u;
  __device__ __forceinline__ void load(const float* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void set_nan() {
    u = make_uint4(kNanF32, kNanF32, kNanF32, kNanF32);
  }
  __device__ __forceinline__ void set_zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int k) const {
    return __uint_as_float(k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w);
  }
};

template <>
struct Slice<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void set_nan() {
    u = make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);
  }
  __device__ __forceinline__ void set_zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int k) const {   // bf16 -> f32 exactly
    const int j = k >> 1;
    const unsigned w = j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Slice<float, 1> {
  unsigned u;
  __device__ __forceinline__ void load(const float* p) {
    u = __float_as_uint(__ldg(p));
  }
  __device__ __forceinline__ void set_nan() { u = kNanF32; }
  __device__ __forceinline__ void set_zero() { u = 0u; }
  __device__ __forceinline__ float at(int) const { return __uint_as_float(u); }
};

template <>
struct Slice<__nv_bfloat16, 1> {
  unsigned u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void set_nan() { u = 0x7fc0u; }
  __device__ __forceinline__ void set_zero() { u = 0u; }
  __device__ __forceinline__ float at(int) const {
    return __uint_as_float(u << 16);
  }
};

// The streams (ids, mask, weights, output), each read or written once:
// cache-streaming loads and stores (evict first), so that L2 keeps the
// table rows of a tile of fields instead.
template <typename V>
__device__ __forceinline__ V ld_stream(const V* p) {
  return __ldcs(p);
}
template <typename V>
__device__ __forceinline__ void st_stream(V* p, V v) {
  __stcs(p, v);
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <int kVec>
__device__ __forceinline__ void store(float* p, const float (&acc)[kVec]) {
  if constexpr (kVec == 4)
    st_stream(reinterpret_cast<float4*>(p),
              make_float4(acc[0], acc[1], acc[2], acc[3]));
  else
    st_stream(p, acc[0]);
}

template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* p,
                                      const float (&acc)[kVec]) {
  if constexpr (kVec == 8)
    st_stream(reinterpret_cast<uint4*>(p),
              make_uint4(bf16_pair(acc[0], acc[1]), bf16_pair(acc[2], acc[3]),
                         bf16_pair(acc[4], acc[5]), bf16_pair(acc[6], acc[7])));
  else
    st_stream(reinterpret_cast<unsigned short*>(p),
              __bfloat16_as_ushort(__float2bfloat16(acc[0])));
}

// Slot (n, l)'s weight from its weight and mask byte, as fold_weights.
__device__ __forceinline__ float fold(const Args& a, float w, unsigned m) {
  return a.mask ? __fmul_rn(a.w ? w : 1.f, (float)m) : (a.w ? w : 1.f);
}

// The element offset of id's row in field row0's block, -1 for an id out
// of the global range (jnp.take: NaN row), -2 for one in range that another
// rank's window holds (a zero row, nothing read).
__device__ __forceinline__ long long row_offset(int id, long long row0,
                                                const Args& a) {
  if (id < 0) id += a.V;
  if ((unsigned)id >= (unsigned)a.V) return -1;
  id -= a.row_start;
  return (unsigned)id < (unsigned)a.Vl ? (row0 + id) * a.D : -2;
}

template <typename T, int kVec>
__device__ __forceinline__ void gather(Slice<T, kVec>& x, const T* table,
                                       long long off) {
  if (off >= 0)
    x.load(table + off);
  else if (off == -1)
    x.set_nan();
  else
    x.set_zero();
}

template <int kVec, typename S>
__device__ __forceinline__ void add_row(float (&acc)[kVec], const S& x,
                                        float w) {
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    acc[k] = __fadd_rn(acc[k], __fmul_rn(x.at(k), w));
}

// kL4: the bag size is 4 and the ids, mask and weights are aligned for
// one vector load each a bag; otherwise any L, kSlots rows at a time.
template <typename T, int kVec, bool kL4>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const Args a) {
  const T* __restrict__ table = static_cast<const T*>(a.table);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int G = 1 << a.group_log2;
  const int lane = (int)(threadIdx.x & (G - 1));
  // this group's place in its field tile: bag b of field f
  const unsigned j = blockIdx.x * (kThreads >> a.group_log2) +
                     (threadIdx.x >> a.group_log2);
  const unsigned b = j / (unsigned)a.tile;
  const unsigned f = blockIdx.y * a.tile + (j - b * a.tile);
  // idle lanes of a narrow row's group, and the grid's ragged ends
  if (lane >= a.n_chunks || b >= (unsigned)a.per_field ||
      f >= (unsigned)a.F)
    return;
  const unsigned n = b * a.F + f;
  const long long row0 = (long long)f * a.Vl;
  T* dst = out + (size_t)n * a.D;
  if constexpr (kL4) {
    const size_t s0 = (size_t)n * 4;
    const int4 id = ld_stream(reinterpret_cast<const int4*>(a.ids + s0));
    const float4 w4 =
        a.w ? ld_stream(reinterpret_cast<const float4*>(a.w + s0))
            : make_float4(1.f, 1.f, 1.f, 1.f);
    const unsigned m4 =
        a.mask ? ld_stream(reinterpret_cast<const unsigned*>(a.mask + s0))
               : 0u;
    const long long off[4] = {row_offset(id.x, row0, a),
                              row_offset(id.y, row0, a),
                              row_offset(id.z, row0, a),
                              row_offset(id.w, row0, a)};
    const float wt[4] = {fold(a, w4.x, m4 & 0xff),
                         fold(a, w4.y, (m4 >> 8) & 0xff),
                         fold(a, w4.z, (m4 >> 16) & 0xff),
                         fold(a, w4.w, m4 >> 24)};
    for (int c = lane; c < a.n_chunks; c += G) {
      Slice<T, kVec> x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gather(x[j], table + c * kVec, off[j]);
      float acc[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) add_row(acc, x[j], wt[j]);
      store(dst + c * kVec, acc);
    }
  } else {
    const int L = a.L;
    const size_t s0 = (size_t)n * L;
    for (int c = lane; c < a.n_chunks; c += G) {
      float acc[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
      for (int l0 = 0; l0 < L; l0 += kSlots) {
        long long off[kSlots];
        float wt[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          if (l0 + j < L) {
            const size_t s = s0 + l0 + j;
            off[j] = row_offset(ld_stream(a.ids + s), row0, a);
            wt[j] = fold(a, a.w ? ld_stream(a.w + s) : 1.f,
                         a.mask ? ld_stream(a.mask + s) : 0u);
          }
        }
        Slice<T, kVec> x[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          if (l0 + j < L) gather(x[j], table + c * kVec, off[j]);
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          if (l0 + j < L) add_row(acc, x[j], wt[j]);
      }
      store(dst + c * kVec, acc);
    }
  }
}

template <typename T, int kVec, bool kL4>
int launch(Args a, cudaStream_t stream) {
  a.n_chunks = a.D / kVec;
  a.group_log2 = 0;
  while ((1 << a.group_log2) < a.n_chunks && a.group_log2 < 5)
    ++a.group_log2;
  const size_t field_bytes = (size_t)a.Vl * a.D * sizeof(T);
  a.tile = field_bytes > kTileBytes
               ? a.F
               : (int)(kTileBytes / field_bytes < (size_t)a.F
                           ? kTileBytes / field_bytes
                           : a.F);
  if ((a.F + a.tile - 1) / a.tile > 65535) a.tile = a.F;   // grid's y
  a.per_field = a.n_bags / a.F;
  const int bags_a_block = kThreads >> a.group_log2;
  const long long tile_bags = (long long)a.per_field * a.tile;
  const dim3 grid((unsigned)((tile_bags + bags_a_block - 1) / bags_a_block),
                  (a.F + a.tile - 1) / a.tile);
  embedding_bag_kernel<T, kVec, kL4><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const Args& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.D % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(a.table) % 16 == 0;
  const bool l4 = a.L == 4 && reinterpret_cast<uintptr_t>(a.ids) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.mask) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (vec)
    return l4 ? launch<T, kVec, true>(a, stream)
              : launch<T, kVec, false>(a, stream);
  return l4 ? launch<T, 1, true>(a, stream) : launch<T, 1, false>(a, stream);
}

}  // namespace

// table (F, Vl, D) (F = 1: a plain (Vl, D) table), any alignment: rows
// [row_start, row_start + Vl) of each field's V; ids (n_bags, L) int32 with
// bag n in field n % F; mask (n_bags, L) uint8 or null; w (n_bags, L) f32
// or null; out (n_bags, D), 16-byte aligned.  dtype 0 = f32, 1 = bf16.
// Returns the CUDA error of the launch (0 = success).
extern "C" int embedding_bag_window_launch(const void* table, const void* ids,
                                           const void* mask, const void* w,
                                           void* out, int n_bags, int L, int F,
                                           int V, int row_start, int Vl, int D,
                                           int dtype, void* stream) {
  if (n_bags < 1 || L < 0 || F < 1 || V < 1 || D < 1 || n_bags % F ||
      Vl < 1 || row_start < 0 || row_start > V - Vl || dtype < 0 ||
      dtype > 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{table, static_cast<const int*>(ids),
               static_cast<const uint8_t*>(mask),
               static_cast<const float*>(w), out, n_bags, L, F, V, D,
               row_start, Vl, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run<float>(a, s) : run<__nv_bfloat16>(a, s);
}

// The whole table: (F, V, D), every id's row on this call.
extern "C" int embedding_bag_launch(const void* table, const void* ids,
                                    const void* mask, const void* w,
                                    void* out, int n_bags, int L, int F,
                                    int V, int D, int dtype, void* stream) {
  return embedding_bag_window_launch(table, ids, mask, w, out, n_bags, L, F,
                                     V, 0, V, D, dtype, stream);
}
