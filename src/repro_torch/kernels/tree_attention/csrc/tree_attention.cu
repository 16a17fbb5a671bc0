// Tree-verification decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/tree_attention/tree_attention.py
// ::_kernel (launched by tree_attention_grouped through ops.py
// ::tree_attention): the T draft slots of each lane attend to the lane's KV
// cache under a (B, T, S) bool mask (committed prefix + the draft tree's
// ancestor closure), softmax in f32, output in q's dtype.  The TPU version
// walks S as a sequential grid axis carrying (m, l, acc) in VMEM; here the
// S loop runs inside one block (attention_tile.cuh).  Not carried over: the
// TPU layout shims (dh padded to 128 with a sqrt(dh_p/dh) fix on q, S padded
// to a block multiple) — the scale is dh**-0.5 and the ragged S edge is
// masked in the kernel.
//
// Bound at the serving path's shapes, (B,T,H,K,dh,S) = (4,33,12,2,128,512)
// in bf16, per call: K and V are 4*512*2*128*2 B = 1 MiB each, 2 MiB
// together, about 0.63 us at 3.35 TB/s; the two products are
// 4*B*T*H*S*dh = 0.42 GFLOP, about 0.42 us at 989 TFLOP/s — and less for
// the keys a run actually sees (rows past each lane's prefix + tree are
// masked, and tiles that no row of a block sees are skipped without being
// read).  So nothing the card does at its peak rates limits a call: the fill
// of the card and the latency of each tile's chain do.
//
// Design (attention_tile.cuh, bf16): blocks of 2 row warps (32 grouped
// rows) times 2 key groups, so the 198 rows of a (lane, KV head) take 7
// blocks (56 at the path) and each row's keys are walked by two warps side
// by side (even and odd 64-key tiles), merged at the end; a block stages
// each round of two tiles of its lane's K/V (and its mask rows) once, in
// bf16, through a two-stage cp.async ring, so the next round's copies
// overlap this round's products; Q.K^T and P.V run on mma.sync (bf16 in,
// f32 sums), the softmax on the accumulator fragments in the log2 domain,
// and P goes from the score registers into P.V's operand as bf16 hi + lo.
// Tiles no row of a block sees are neither copied nor computed (a prologue
// scan of the block's mask rows lists them).  f32 inputs run the CUDA-core
// body, which TF32 could not replace within the f32 checks.
//
// What it still leaves: at decode a warp's chain of rounds (two to four,
// with the lane's length) is latency-bound on one or two warps per SM
// sub-partition; the tiles are staged by cp.async chunk by chunk, where a
// TMA copy would free the threads; and mma.sync, where the long-prompt
// prefill would want wgmma.
#include "attention_tile.cuh"

extern "C" int tree_attention_launch(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int B, int T, int S, int H,
                                     int K, int dh, int dtype,
                                     void* stream) {
  return (int)attn::dispatch<false, false>(q, k, v, mask, out, B, T, S, H, K,
                                           dh, dtype, (cudaStream_t)stream);
}
