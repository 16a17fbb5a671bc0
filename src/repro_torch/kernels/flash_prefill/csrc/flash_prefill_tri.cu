// Causal GQA flash attention for prefill on a triangular schedule, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_prefill/flash_prefill.py
// ::_kernel_tri (with its helper _tri_qi, launched by
// flash_prefill_grouped_tri through ops.py::flash_prefill(...,
// triangular=True)): the causal attention of flash_prefill.cu on a grid that
// never schedules work above the diagonal.  The TPU version enumerates the
// (query block, key block) pairs with kj <= qi as one sequential grid axis
// through a triangular index and carries the softmax state across it in
// scratch.  Here a block owns a whole row tile and runs its key loop up to
// the diagonal (attention_tile.cuh, as flash_prefill.cu does), so no tile
// above the diagonal exists in either kernel; what this kernel changes is
// the schedule: its work items — (lane, KV head, row tile of grouped rows),
// the row tiles' costs growing linearly along the diagonal — go out longest
// first, so the blocks still running at the launch's end are the
// shortest.  Not carried over: the TPU shims (dh padded to 128, S a
// multiple of the block): ragged S is masked.
//
// Bound at the serving path's cohort prefill, (B,S,H,K,dh) = (4,128,12,2,
// 128) in bf16: 0.2 GFLOP of causal products (0.2 us at 989 TFLOP/s) against
// 3.7 MB of q, K, V and output (1.1 us at 3.35 TB/s) — bound by bytes.  At a
// long prompt, (1,4096,12,2,128): 51.5 GFLOP (52 us) against 29.4 MB (8.8
// us) — bound by operations.
//
// Arithmetic and tile body: flash_prefill.cu's (attention_tile.cuh; f32 on
// the CUDA cores), with the same choice between mma_attention_kernel and
// the key groups in sequence (prefill_kernel), so this kernel gives
// flash_prefill.cu's bits on the same inputs.
//
// Schedule: on mma_attention_kernel, a 1-D grid whose blocks take the row
// tiles longest first.  On prefill_kernel, a persistent grid of one block a
// streaming multiprocessor (at most the work items) whose blocks take
// (lane, KV head, row tile) items longest first from an atomic counter (the
// wrapper's int32, zeroed on the stream by the launch), each fetching its
// next item while it runs the current one, so blocks that run at uneven
// speeds still finish together.  Measured (PERF.md §6): within a few
// percent of flash_prefill.cu's grid, whose blocks the hardware hands out
// in the same falling order.
//
// What it still leaves: everything flash_prefill.cu leaves, and each item's
// ring starts cold (the next item's first tiles are not fetched during the
// last one's final rounds).
#include "attention_tile.cuh"

extern "C" int flash_prefill_tri_launch(const void* q, const void* k,
                                        const void* v, void* out,
                                        void* counter, int B, int S, int H,
                                        int K, int dh, int dtype,
                                        void* stream) {
  return (int)attn::dispatch<true, false, true>(
      q, k, v, nullptr, out, B, S, S, H, K, dh, dtype, (cudaStream_t)stream,
      attn::Paged(), static_cast<int*>(counter));
}
