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
// Arithmetic: the shared body of attention_tile.cuh — in bf16 the
// tensor-core body of the tree kernels (2 key groups over 64-key tiles
// through a cp.async ring, mma.sync products, the softmax on the
// fragments), which is what gives the prefix cache's suffix prefill (the
// paged tree kernel) this kernel's bits; in f32 the CUDA-core body.  The
// schedule is unchanged: a 3-D grid of (row tile, KV head, lane) blocks of
// 64 grouped rows (16 in f32), each stopping at the diagonal of its last
// row (a warp skips the tiles past its own).
//
// What it still leaves: its own schedule — for a long prompt the work is
// operations-bound, where wgmma from TMA-staged tiles and a persistent grid
// would pay — and K/V re-read from L2 by every row tile of a (lane, KV head).
#include "attention_tile.cuh"

extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int K, int dh, int dtype,
                                    void* stream) {
  return (int)attn::dispatch<true, false>(q, k, v, nullptr, out, B, S, S, H,
                                          K, dh, dtype, (cudaStream_t)stream);
}
