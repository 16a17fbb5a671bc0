// Tree-verification attention over the paged KV layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/tree_attention/paged.py
// ::_paged_kernel (launched by paged_tree_attention_grouped through the
// wrapper paged_tree_attention): the T query slots of each lane attend to
// the lane's keys under a (B, T, bpl*bs) bool mask, where K and V live in
// the block pool (n_blocks, bs, K, dh) shared by every lane and lane b's
// logical block j is physical block bt[b, j].  Unallocated table entries
// point at the NULL block 0, whose keys are read like any other and masked.
// The TPU version walks a lane's logical blocks as a sequential grid axis
// and scalar-prefetches the table into the DMA index map; here each block
// stages its lane's table row in shared memory and takes the address of
// every 16-byte chunk its cp.async copies from it (attention_tile.cuh,
// kPaged), where the dense kernel takes row b*S + s: the staged tile, the
// key tiles on logical positions and the arithmetic are the same, so the
// output is the dense kernel's (tree_attention.cu) bit for bit on the same
// logical K/V, and any block size works.  The T axis is tiled by the grid's
// row tiles, so the prefix cache's suffix prefill (T up to prefill_len, 768
// grouped rows at T = 128) runs on the same kernel as decode (T = 33), and
// its rows are the causal prefill kernel's bits (the same bf16 body).
//
// Bound at the serving path's decode shape, (B,T,H,K,dh) = (4,33,12,2,128),
// bpl*bs = 8*64 = 512 logical keys a lane, bf16, per call: the K and V rows
// of the 4 lanes are 2 MiB, about 0.63 us at 3.35 TB/s; the products are
// 4*B*T*H*512*dh = 0.42 GFLOP, about 0.42 us at 989 TFLOP/s — and less for
// the keys a run actually sees (tiles that no row of a block sees are
// skipped without being read).
//
// Design: the dense kernel's (tree_attention.cu) body and arithmetic, with
// 4 row warps a block (64 grouped rows; measured faster here than 2), the
// block's table row in shared memory and each key's block found by a
// reciprocal-based divide.  What it
// still leaves: what the dense kernel leaves, plus a gather whose addresses
// are computed per 16-byte chunk instead of once per block of the pool (a
// TMA gather of whole blocks would do it).
#include "attention_tile.cuh"

extern "C" int paged_tree_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* mask, void* out, int B, int T,
    int n_blocks, int bs, int bpl, int H, int K, int dh, int dtype,
    void* stream) {
  attn::Paged pg;
  pg.bt = static_cast<const int*>(block_tables);
  pg.bpl = bpl;
  pg.bs = bs;
  pg.n_blocks = n_blocks;
  return (int)attn::dispatch<false, true>(q, k_pool, v_pool, mask, out, B, T,
                                          bpl * bs, H, K, dh, dtype,
                                          (cudaStream_t)stream, pg);
}
