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
// together, about 0.63 us at 3.35 TB/s; the two products are 4*B*T*H*S*dh = 0.42 GFLOP,
// about 0.42 us at 989 TFLOP/s — and less for the keys a run actually sees
// (rows past each lane's prefix + tree are masked, and tiles that no row of
// a block sees are skipped without being read).
//
// What this simple design leaves on the table: the products run on the f32
// CUDA cores (no mma/wgmma), so it is bound by issue rate, not by the bound
// above; every block of kRows rows re-reads its lane's K/V from L2 (the 198
// grouped rows of a (lane, KV head) make 13 blocks, 104 in all on the path);
// the score loop reads two shared-memory operands per FMA; and the next
// tile is not prefetched (no cp.async/TMA pipeline).
#include "attention_tile.cuh"

extern "C" int tree_attention_launch(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int B, int T, int S, int H,
                                     int K, int dh, int dtype,
                                     void* stream) {
  return (int)attn::dispatch<false, false>(q, k, v, mask, out, B, T, S, H, K,
                                           dh, dtype, (cudaStream_t)stream);
}
