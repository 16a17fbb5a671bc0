// Causal GQA flash attention for prefill on Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_prefill/flash_prefill.py
// ::_kernel (launched by flash_prefill_grouped through ops.py
// ::flash_prefill): FlashAttention-2 style causal attention whose mask comes
// from the indices (key s visible to query t iff s <= t), so no (S, S) mask
// exists.  The TPU version walks the kv blocks as a sequential grid axis and
// masks the blocks above the diagonal; here the key loop runs inside one
// block (attention_tile.cuh) and stops at the diagonal of the block's last
// query row.  Not carried over: the TPU layout shims (dh padded to 128 with
// a sqrt(dh_p/dh) fix on q, S padded to a block multiple).
//
// Bound at the serving path's cohort prefill, (B,S,H,K,dh) = (4,128,12,2,
// 128) in bf16: the causal products are 4*B*H*dh*S*(S+1)/2 = 0.2 GFLOP,
// about 0.2 us at 989 TFLOP/s; q and the output are 3.1 MB and K+V 0.5 MB,
// about 1.1 us at 3.35 TB/s — so the call is bound by bytes.
//
// At a long prompt, (1,4096,12,2,128): 51.5 GFLOP of causal products (52 us
// at 989 TFLOP/s) against 29.4 MB (8.8 us) — bound by operations.  P enters
// P.V as bf16 hi + lo (below), so the tensor cores run 1.5x the products
// the bound counts.
//
// Arithmetic: the shared bf16 functions of attention_tile.cuh (tile_scores,
// tile_softmax, tile_pv, the key groups' merge) — the tree kernels'
// arithmetic, which is what gives the prefix cache's suffix prefill (the
// paged tree kernel) this kernel's bits; in f32 the CUDA-core body.
//
// Schedule: a 3-D grid of (row tile, KV head, lane) blocks, each running
// the key tiles up to the diagonal of its last row.  Where 128-row blocks
// fill the card (a long prompt) at dh = 128, prefill_kernel, the causal
// kernels' own: blocks of 8 warps that take the row tiles in falling order
// of length, so the launch does not end on its longest tiles, and every
// warp runs both key groups in sequence — group 0's tiles, its state parked
// in shared memory, then group 1's, merged in group order — so one staged
// K/V tile serves 128 grouped rows; the tensor memory accelerator stages
// the tiles, the products run on wgmma (whose f32 bits are mma.sync's:
// tests/test_torch_cuda.py::test_wgmma_gives_mma_sync_bits), and the two
// warpgroups take turns at the tensor cores so one's softmax runs under the
// other's products.  A short prompt, or another head width, runs on the
// tree kernels' mma_attention_kernel: 4 row warps x 2 key-group warps (64
// rows a block) on mma.sync, whose two dependent chains a row then run in
// parallel.
//
// Measured (PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W): at (1,4096) about
// 0.195 ms against the previous design's 0.41, sdpa's 0.115 and the
// bound's 0.052; at (4,128) about 0.0083 ms.
//
// What it still leaves: the products alone run the tensor cores at about
// half their peak (Q.K^T at N = 64 keys, the tile width the bits rest on)
// and the softmax (ex2, P's hi/lo conversions, one instruction per
// rounded f32 step) is bound by instruction issue, the two hiding each
// other only in part; the hi + lo P.V; wgmma and TMA at other head widths.
#include "attention_tile.cuh"

extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int K, int dh, int dtype,
                                    void* stream) {
  return (int)attn::dispatch<true, false>(q, k, v, nullptr, out, B, S, S, H,
                                          K, dh, dtype, (cudaStream_t)stream);
}
