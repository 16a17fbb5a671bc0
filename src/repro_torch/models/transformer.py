"""Config-driven decoder-only transformer, dense FFN or MoE
(``models/moe.py``) (PyTorch port of ``repro.models.transformer``), on
the dense and the paged KV layout.

  * ``train_logits`` / ``lm_loss`` — the training forward (no cache,
    ``cfg.remat`` checkpoints each layer and the loss head).
  * ``prefill`` / ``prefill_into_slot`` — causal forward that fills a KV
    cache (all lanes / one lane) and returns the logits of each sequence's
    last real token.
  * ``tree_step`` — the Lookahead step: T = 1+decoding_length slots with a
    tree-structured attention mask attend to the cache; their KV rows are
    written at cache_len + slot.
  * ``commit_cache`` / ``verify_accept_device`` / ``pack_step_result`` —
    the device epilogue of the fused decode step.
  * the paged twins (``init_paged_cache``, ``prefill_paged``,
    ``prefill_into_slot_paged``, ``tree_step_paged``,
    ``commit_paged_cache``, ``reset_blocks``), whose KV lives in a block
    pool shared by every lane and is reached through per-lane block
    tables, and the prefix cache's device surface
    (``prefill_from_offset_paged``, ``copy_paged_block``).

Parameters keep the JAX package's layout: per-layer weights stacked along a
leading ``(L, ...)`` axis and ``x @ W`` orientation (``wq`` is
``(L, d, H*dh)``).  A Python loop over layers takes the place of
``lax.scan``.  The cache dict ``{"k", "v"}`` of ``(L, B, S, K, dh)`` tensors
(paged: ``(L, n_blocks, block_size, K, dh)`` plus ``block_tables``) is
updated in place where JAX donates the buffer and returns a new one;
every function that writes it also returns it, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_backends
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ACTS, apply_rope, rms_norm,
                                       rope_angles, swiglu)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]
Index = Union[int, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "tiny"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 128
    vocab_size: int = 256
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # MoE (models/moe.py); on one device "auto" resolves to "ref", "local"
    # runs the capacity dispatch, "ep" waits for ROADMAP A16
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.5
    moe_impl: str = "auto"
    # execution
    dtype: str = "float32"                  # activation dtype
    param_dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = True
    q_chunk: int = 0
    max_seq_len: int = 512                  # KV cache allocation length
    # per-phase attention backends, resolved from the registry in
    # repro_torch.models.attention: "dense" | "cuda"
    prefill_backend: str = "cuda"
    decode_backend: str = "cuda"
    attn_score_f32: bool = True
    kv_layout: str = "dense"
    kv_block_size: int = 64

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def n_params(self) -> int:
        """Total parameter count."""
        return self._count(self.n_experts)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        return self._count(self.top_k)

    def _count(self, routed: int) -> int:
        """Parameters with ``routed`` of the MoE's experts counted (the
        reference's two formulas)."""
        d, dh, V = self.d_model, self.dh, self.vocab_size
        qkvo = d * (self.n_heads * dh) * 2 + d * (self.n_kv_heads * dh) * 2
        if self.moe:
            ffn = (3 * d * self.moe_d_ff * (routed + self.n_shared_experts)
                   + d * self.n_experts)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = qkvo + ffn + 2 * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


# ------------------------------------------------------------------- layer fwd
def _qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T, _ = h.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(B, T, H, dh), k.reshape(B, T, K, dh),
            v.reshape(B, T, K, dh))


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    act = ACTS[cfg.act]
    if not cfg.moe:
        return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], act)
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    impl = cfg.moe_impl
    if impl == "ep":
        raise NotImplementedError(
            "expert-parallel MoE (moe_impl='ep'): not yet ported to "
            "repro_torch (ROADMAP A16, multi-GPU); use 'auto', 'ref' or "
            "'local'")
    if impl == "local":
        y = moe_lib.moe_local(x, lp["router"], lp["we_gate"], lp["we_up"],
                              lp["we_down"], cfg.top_k, cfg.capacity_factor,
                              act)
    else:       # "auto" on one device (the port has no mesh) and "ref"
        y = moe_lib.moe_ref(x, lp["router"], lp["we_gate"], lp["we_up"],
                            lp["we_down"], cfg.top_k, act)
    y = y.reshape(B, T, d)
    if cfg.n_shared_experts:
        y = y + swiglu(h, lp["ws_gate"], lp["ws_up"], lp["ws_down"], act)
    return y


def _layer_self(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                positions: torch.Tensor, len_mask: torch.Tensor,
                want_kv: bool = True):
    """Self-attention layer over the full sequence (train / prefill).
    Returns new hidden states and the (k, v) tensors for cache filling
    (None with ``want_kv=False``: training keeps no cache)."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, hn)
    cos, sin = rope_angles(positions, cfg.dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    backend = attn_backends.get_backend(cfg.prefill_backend)
    attn = backend.prefill_attention(cfg, q, k, v, positions, len_mask)
    B, T, H, dh = attn.shape
    h = h + attn.reshape(B, T, H * dh) @ lp["wo"]
    h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
    return h, ((k, v) if want_kv else None)


def _layer_tree(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, attend: Callable) -> torch.Tensor:
    """Tree-decode layer: T slots attend to cache + tree siblings.
    ``attend`` (from ``make_tree_attend``) writes the slots' KV into
    ``k_cache``/``v_cache`` in place, then attends."""
    B, T, _ = h.shape
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, hn)
    cos, sin = rope_angles(positions, cfg.dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v, k_cache, v_cache)
    H, dh = cfg.n_heads, cfg.dh
    h = h + attn.reshape(B, T, H * dh) @ lp["wo"]
    return h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))


def _layer_params(cfg: TransformerConfig, params: Params, i: int) -> Params:
    """Layer i's weights, floating ones cast to the activation dtype (a
    no-op when the parameter and activation dtypes agree)."""
    return {name: (a[i].to(cfg.adtype) if a.is_floating_point() else a[i])
            for name, a in params["layers"].items()}


# ----------------------------------------------------------------- full models
def _embed(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    return params["embed"].to(cfg.adtype)[tokens.long()]


def _unembed(cfg: TransformerConfig, params: Params, h: torch.Tensor
             ) -> torch.Tensor:
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _self_forward(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, write_kv: Callable
                  ) -> torch.Tensor:
    """Causal forward over padded prompts; ``write_kv(i, k, v)`` stores
    layer i's (B, S, K, dh) KV.  Returns the last real token's logits."""
    B, S = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    len_mask = positions < lens[:, None]
    for i in range(cfg.n_layers):
        h, (k, v) = _layer_self(cfg, _layer_params(cfg, params, i), h,
                                positions, len_mask)
        write_kv(i, k, v)
    h_last = h[torch.arange(B, device=h.device), lens.long() - 1]
    return _unembed(cfg, params, h_last)


def _tree_forward(cfg: TransformerConfig, params: Params, cache: Cache,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  attend: Callable) -> torch.Tensor:
    """Embed ``tokens`` and run every tree-decode layer against the cache's
    per-layer K/V through ``attend``; returns the last hidden states."""
    h = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        h = _layer_tree(cfg, _layer_params(cfg, params, i), h, positions,
                        cache["k"][i], cache["v"][i], attend)
    return h


def _train_hidden(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Embed and run every layer causally over (B, S) tokens, no padding,
    no cache.  Each stacked weight is unbound once, so its gradient is one
    stack of the layers' gradients; with ``cfg.remat`` each layer's body
    is checkpointed (the reference's ``jax.checkpoint``) and recomputed in
    the backward pass."""
    B, S = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    len_mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    names = list(params["layers"])
    per_layer = [a.unbind(0) for a in params["layers"].values()]

    def layer(h, *weights):
        lp = {n: (w.to(cfg.adtype) if w.is_floating_point() else w)
              for n, w in zip(names, weights)}
        return _layer_self(cfg, lp, h, positions, len_mask,
                           want_kv=False)[0]

    for i in range(cfg.n_layers):
        weights = [w[i] for w in per_layer]
        if cfg.remat:       # no layer draws random numbers: no RNG state
            h = checkpoint(layer, h, *weights, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer(h, *weights)
    return h


def train_logits(cfg: TransformerConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V); plain causal, no padding mask."""
    return _unembed(cfg, params, _train_hidden(cfg, params, tokens))


def lm_loss(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Mean next-token NLL from f32 log-softmax (over ``loss_mask``'s
    weights when given).  The attention is ``cfg.prefill_backend``'s: train
    through ``dense`` (the CUDA kernels have no backward and refuse inputs
    that require grad).  With ``cfg.remat`` the loss head is checkpointed
    too: the (B, S, V) f32 logits are recomputed in the backward pass, not
    kept."""
    h = _train_hidden(cfg, params, tokens)

    def head(h, labels, mask):
        logits = _unembed(cfg, params, h)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
        if mask is None:
            return nll.mean()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)

    if cfg.remat:
        return checkpoint(head, h, labels, loss_mask, use_reentrant=False,
                          preserve_rng_state=False)
    return head(h, labels, loss_mask)


def init_cache(cfg: TransformerConfig, batch: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None) -> Cache:
    L, S, K, dh = cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.dh
    dt = dtype or cfg.adtype
    return {"k": torch.zeros((L, batch, S, K, dh), dtype=dt, device=device),
            "v": torch.zeros((L, batch, S, K, dh), dtype=dt, device=device)}


def prefill(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            lens: torch.Tensor, cache: Optional[Cache] = None
            ) -> Tuple[Cache, torch.Tensor]:
    """Causal forward over padded prompts; fills cache[:, :, :S] in place.

    cache=None allocates the cache (S must be max_seq_len).  Returns
    (cache, last_logits (B, V)) at position lens-1 of each row.
    """
    B, S = tokens.shape
    if cache is None:
        assert S == cfg.max_seq_len, (S, cfg.max_seq_len)
        cache = init_cache(cfg, B, device=tokens.device)

    def write_kv(i, k, v):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v

    logits = _self_forward(cfg, params, tokens, lens, write_kv)
    return cache, logits


def lane_index(index: Index, device: torch.device) -> torch.Tensor:
    """A lane or block index as a (1,) int64 device tensor: a Python int,
    or a (1,) integer tensor already holding it (a runtime input, as the
    reference's traced scalar is, so one captured step serves every
    lane)."""
    if isinstance(index, torch.Tensor):
        return index.to(device=device, dtype=torch.long).reshape(1)
    return torch.tensor([int(index)], dtype=torch.long, device=device)


def prefill_into_slot(cfg: TransformerConfig, params: Params, cache: Cache,
                      slot: Index, tokens: torch.Tensor, lens: torch.Tensor
                      ) -> Tuple[Cache, torch.Tensor]:
    """Prefill ONE request into batch lane ``slot`` (an int or a (1,) int
    tensor) of an existing cache.

    tokens (1, S) padded prompt; lens (1,) — or (B, S) / (B,) holding the
    request in row ``slot`` and padding in the other rows, computed
    alongside so the forward runs at the cohort prefill's batch shape (on
    the card a row's rounding depends on it).  Writes KV for positions
    [0, S) of that lane only (other lanes untouched).  Returns (cache,
    last_logits (1, V))."""
    B, S = tokens.shape
    slot = lane_index(slot, tokens.device)
    row = slot if B > 1 else torch.zeros_like(slot)

    def write_kv(i, k, v):
        for name, new in (("k", k), ("v", v)):
            buf = cache[name][i, :, :S]
            buf.index_copy_(0, slot, new.index_select(0, row).to(buf.dtype))

    logits = _self_forward(cfg, params, tokens, lens, write_kv)
    return cache, logits.index_select(0, row)


def reset_slot(cache: Cache, slot: Index) -> Cache:
    """Zero one batch lane (an int or a (1,) int tensor) of the KV cache in
    place.  Hygiene only: correctness never depends on it (rows >=
    cache_len are never attended)."""
    for buf in cache.values():
        buf.index_fill_(1, lane_index(slot, buf.device), 0)
    return cache


def tree_step(cfg: TransformerConfig, params: Params, cache: Cache,
              cache_lens: torch.Tensor, tokens: torch.Tensor,
              positions: torch.Tensor, tree_mask: torch.Tensor
              ) -> Tuple[Cache, torch.Tensor]:
    """Lookahead VA forward.

    tokens (B, T), positions (B, T), tree_mask (B, T, T) ancestor-closure.
    Writes the slots' KV at cache_len + slot (in place) and returns
    (cache, logits (B, T, V)).
    """
    S_max = cache["k"].shape[2]
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_tree_attend(cfg, cache_lens, tree_mask, S_max)
    h = _tree_forward(cfg, params, cache, tokens, positions, attend)
    return cache, _unembed(cfg, params, h)


def commit_cache(cache: Cache, cache_lens: torch.Tensor,
                 gather_idx: torch.Tensor, n_accept: torch.Tensor
                 ) -> Tuple[Cache, torch.Tensor]:
    """Compact accepted slots in place: new position m+j takes KV from
    m+gather[j].

    gather_idx (B, T) slot indices (monotone increasing over valid j);
    n_accept (B,).  Rows beyond n_accept keep garbage (never attended).
    Every source row is gathered into its own tensor before any row is
    written, as JAX's functional update does: row m+j may be the source of
    a later row (gather[j'] = j for j' > j) and must be read first.
    """
    k, v = cache["k"], cache["v"]
    B, T = gather_idx.shape
    lens = cache_lens.long()
    bidx = torch.arange(B, device=k.device)[:, None]
    src = lens[:, None] + gather_idx.long()                      # (B, T)
    dst = lens[:, None] + torch.arange(T, device=k.device)[None, :]
    kg = k[:, bidx, src]                                         # (L,B,T,K,dh)
    vg = v[:, bidx, src]
    k[:, bidx, dst] = kg
    v[:, bidx, dst] = vg
    return cache, cache_lens + n_accept


# ------------------------------------------------------------ paged KV cache
def blocks_per_lane(cfg: TransformerConfig) -> int:
    """Block-table width: blocks covering max_seq_len logical positions."""
    return -(-cfg.max_seq_len // cfg.kv_block_size)


def init_paged_cache(cfg: TransformerConfig, lanes: int,
                     n_blocks: Optional[int] = None,
                     dtype: Optional[torch.dtype] = None,
                     device: Optional[torch.device] = None) -> Cache:
    """Block-pool KV cache: k/v (L, n_blocks, block_size, K, dh) plus the
    per-lane block tables (lanes, blocks_per_lane) int32.

    ``n_blocks`` defaults to the dense-equivalent worst case (every lane can
    hold max_seq_len rows) plus the reserved NULL block 0; serving stacks
    pass a smaller pool sized to the workload.  Table entries start at 0
    (the NULL block), where never-attended scatters land harmlessly.
    """
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    bs, bpl = cfg.kv_block_size, blocks_per_lane(cfg)
    nb = int(n_blocks) if n_blocks else 1 + lanes * bpl
    dt = dtype or cfg.adtype
    return {"k": torch.zeros((L, nb, bs, K, dh), dtype=dt, device=device),
            "v": torch.zeros((L, nb, bs, K, dh), dtype=dt, device=device),
            "block_tables": torch.zeros((lanes, bpl), dtype=torch.int32,
                                        device=device)}


def paged_row_index(block_tables: torch.Tensor, positions: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Logical positions -> physical flat cache rows through block tables.

    block_tables (B, blocks_per_lane) int; positions (B, N) logical token
    positions.  Returns (B, N) int64 rows into the (n_blocks*block_size,
    ...) flat view.  Positions inside the table's span but past a lane's
    allocation resolve through table entries 0 to the NULL block (garbage
    rows, never attended).  Block indices past the table CLIP to its last
    entry, as the reference's do: a position at or past
    blocks_per_lane*block_size aliases a row of the lane's last block, so
    callers that can produce one (the suffix prefill's pad slots) redirect
    it through ``slot_valid``."""
    pos = positions.long()
    blk = (pos // block_size).clamp(0, block_tables.shape[-1] - 1)
    phys = block_tables.long().gather(-1, blk)
    return phys * block_size + pos % block_size


def _scatter_paged_rows(cache: Cache, layer: int, rows: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write layer ``layer``'s KV (B, N, K, dh) at flat physical ``rows``
    (B, N) of the paged pool, in place.  Duplicate rows only ever arise on
    NULL-block garbage, where any write order is fine."""
    _, nb, bs, K, dh = cache["k"].shape
    flat = rows.reshape(-1)
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name][layer].view(nb * bs, K, dh)
        buf[flat] = new.reshape(-1, K, dh).to(buf.dtype)


def prefill_paged(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, cache: Cache
                  ) -> Tuple[Cache, torch.Tensor]:
    """Batched causal prefill into a paged cache: row p of lane b lands at
    the physical row its block table maps p to.  Rows past a lane's
    allocated coverage (prompt padding, lanes without a request) resolve to
    the NULL block — garbage, never attended (I3)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    rows = paged_row_index(cache["block_tables"], positions,
                           cfg.kv_block_size)
    logits = _self_forward(
        cfg, params, tokens, lens,
        lambda i, k, v: _scatter_paged_rows(cache, i, rows, k, v))
    return cache, logits


def prefill_into_slot_paged(cfg: TransformerConfig, params: Params,
                            cache: Cache, slot: Index, tokens: torch.Tensor,
                            lens: torch.Tensor
                            ) -> Tuple[Cache, torch.Tensor]:
    """Paged twin of ``prefill_into_slot`` (the same (1, S) or padded
    (B, S) batch): one request's KV scatters through lane ``slot``'s block
    table; every other lane's blocks are untouched (block ownership is
    exclusive)."""
    B, S = tokens.shape
    slot = lane_index(slot, tokens.device)
    row = slot if B > 1 else torch.zeros_like(slot)
    bt_row = cache["block_tables"].index_select(0, slot)
    positions = torch.arange(S, device=tokens.device)[None, :]
    rows = paged_row_index(bt_row, positions, cfg.kv_block_size)
    logits = _self_forward(
        cfg, params, tokens, lens,
        lambda i, k, v: _scatter_paged_rows(cache, i, rows,
                                            k.index_select(0, row),
                                            v.index_select(0, row)))
    return cache, logits.index_select(0, row)


def prefill_from_offset_paged(cfg: TransformerConfig, params: Params,
                              cache: Cache, slot: Index, tokens: torch.Tensor,
                              offset: torch.Tensor, lens: torch.Tensor,
                              prefill_len: Optional[int] = None
                              ) -> Tuple[Cache, torch.Tensor]:
    """Suffix prefill for prefix-cache hits: prefill only the uncached tail
    of one request's prompt, attending the shared prefix blocks through
    lane ``slot``'s block table.

    tokens (1, Sb): the prompt suffix padded to a fixed bucket length;
    offset (1,): cached prefix length (absolute position of tokens[0]);
    lens (1,): real (un-padded) suffix length; prefill_len: the width the
    uncached admission pads a prompt to (None: ``max_seq_len``).

    A causally masked paged tree step at cache_lens = offset: the decode
    backend scatters the suffix KV at rows offset+i through the table and
    masks attention to past or causal-within-suffix — what a full prefill
    computes for those positions.  Pad slots scatter to the NULL block
    (``slot_valid``) and are causally invisible to real queries.

    The row-wise work (norms, the QKV, output and FFN products, the
    unembedding) runs at the uncached admission's shapes, with each suffix
    token in the row the admission gives it: row ``slot`` of a (lanes,
    prefill_len) block at column offset+i, and the last token's hidden state
    in row ``slot`` of a (lanes, d) block.  On the card a product's rounding
    depends on its shape, so only this gives the tail's K/V and logits the
    admission's bits (a sampled draw can rest on them); attention alone runs
    on the (1, Sb) suffix slots.
    """
    B, Sb = tokens.shape
    assert B == 1, "prefill_from_offset admits one request at a time"
    dev = tokens.device
    slot = lane_index(slot, dev)
    lanes = cache["block_tables"].shape[0]
    Sp = int(prefill_len or cfg.max_seq_len)
    n_rows = lanes * Sp
    bt_row = cache["block_tables"].index_select(0, slot)
    ar = torch.arange(Sb, device=dev)
    positions = offset.int()[:, None] + ar.int()[None, :]        # (1, Sb)
    causal = torch.ones((Sb, Sb), dtype=torch.bool,
                        device=dev).tril().expand(B, Sb, Sb)
    valid = ar[None, :] < lens.long()[:, None]
    # suffix slot i <-> flat row slot*Sp + offset + i of the padded block;
    # pad slots read the row of column Sp-1 (their results are discarded)
    # and write to a spare row past the block
    col = positions[0].long()
    src = slot * Sp + col.clamp(max=Sp - 1)
    dst = torch.where(valid[0], slot * Sp + col, n_rows)
    block = torch.zeros((n_rows + 1,), dtype=tokens.dtype, device=dev)
    block[dst] = tokens[0]
    block_pos = torch.arange(Sp, device=dev)[None, :]    # as the admission's
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_paged_tree_attend(cfg, bt_row, offset, causal,
                                            valid)

    def attend_suffix(q, k, v, k_cache, v_cache):
        out = attend(*(x.reshape(n_rows, *x.shape[2:])[src][None]
                       for x in (q, k, v)), k_cache, v_cache)
        full = out.new_zeros((n_rows + 1,) + tuple(out.shape[2:]))
        full[dst] = out[0]
        return full[:n_rows].view(q.shape)

    h = _tree_forward(cfg, params, cache, block[:n_rows].view(lanes, Sp),
                      block_pos.expand(lanes, Sp), attend_suffix)
    last = slot * Sp + offset.long() + lens.long() - 1              # (1,)
    h_last = torch.zeros((lanes, h.shape[-1]), dtype=h.dtype, device=dev)
    h_last.index_copy_(0, slot, h.reshape(n_rows, -1)[last])
    return cache, _unembed(cfg, params, h_last).index_select(0, slot)


def copy_paged_block(cache: Cache, src: Index, dst: Index) -> Cache:
    """Device copy of one physical block (all layers, K and V), in place —
    the copy-on-write fork of a partially filled boundary block that a
    prefix-cache hit must extend.  ``src`` / ``dst`` are ints or (1,) int
    tensors.  Rows past the valid prefix are garbage in ``src`` and stay
    garbage in ``dst`` until the suffix prefill overwrites them."""
    for name in ("k", "v"):
        buf = cache[name]
        buf.index_copy_(1, lane_index(dst, buf.device),
                        buf.index_select(1, lane_index(src, buf.device)))
    return cache


def tree_step_paged(cfg: TransformerConfig, params: Params, cache: Cache,
                    cache_lens: torch.Tensor, tokens: torch.Tensor,
                    positions: torch.Tensor, tree_mask: torch.Tensor
                    ) -> Tuple[Cache, torch.Tensor]:
    """Lookahead VA forward over the paged cache: the decode backend's
    ``make_paged_tree_attend`` scatters draft-slot KV through the block
    tables and attends against the blocks (dense: a gather; cuda: the
    paged kernel)."""
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_paged_tree_attend(cfg, cache["block_tables"],
                                            cache_lens, tree_mask)
    h = _tree_forward(cfg, params, cache, tokens, positions, attend)
    return cache, _unembed(cfg, params, h)


def commit_paged_cache(cfg: TransformerConfig, cache: Cache,
                       cache_lens: torch.Tensor, gather_idx: torch.Tensor,
                       n_accept: torch.Tensor
                       ) -> Tuple[Cache, torch.Tensor]:
    """Paged twin of ``commit_cache``: logical src/dst positions resolve
    through the block tables; every source row is gathered before any row
    is written (a row may be the source of a later one)."""
    k, v, bt = cache["k"], cache["v"], cache["block_tables"]
    L, nb, bs, K, dh = k.shape
    T = gather_idx.shape[1]
    lens = cache_lens.long()[:, None]
    src = lens + gather_idx.long()                               # (B, T)
    dst = lens + torch.arange(T, device=k.device)[None, :]
    src_rows = paged_row_index(bt, src, cfg.kv_block_size).reshape(-1)
    dst_rows = paged_row_index(bt, dst, cfg.kv_block_size).reshape(-1)
    kf = k.view(L, nb * bs, K, dh)
    vf = v.view(L, nb * bs, K, dh)
    kg = kf[:, src_rows]                                    # (L, B*T, K, dh)
    vg = vf[:, src_rows]
    kf[:, dst_rows] = kg
    vf[:, dst_rows] = vg
    return cache, cache_lens + n_accept


def reset_blocks(cache: Cache, block_ids: torch.Tensor) -> Cache:
    """Zero the given physical blocks of a paged cache in place (hygiene
    scrub).  ``block_ids`` (N,) — pad with 0: scrubbing the NULL block is
    harmless.  Called on blocks at free time, BEFORE the allocator can hand
    them to a newly admitted request (a lane- or table-keyed scrub after
    re-allocation would destroy the new request's KV)."""
    ids = block_ids.long()
    for name in ("k", "v"):
        cache[name].index_fill_(1, ids, 0)
    return cache


def verify_accept_device(tree_tokens: torch.Tensor, parent: torch.Tensor,
                         n_live: torch.Tensor, chosen: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device twin of ``repro_torch.core.verify.verify_accept`` (the host
    accept walk), batched over lanes — the fused-step epilogue.

    tree_tokens (B, T) draft-slot tokens; parent (B, T) slot parents
    (root = -1); n_live (B,) live slot count per lane (0 marks an idle
    lane); chosen (B, T) the model's prediction at each slot.

    Returns (n_acc (B,), acc_tokens (B, T), kv_slots (B, T)) int32.  The
    walk starts at the root (acc_tokens[0] = chosen[0], kv_slots[0] = 0) and
    T-1 times steps to the smallest slot c with ``parent[c] == cur and
    tree_tokens[c] == chosen[cur] and 0 < c < n_live``.  Entries past n_acc
    are zero; idle lanes return n_acc == 0.  A loop of T-1 batched tensor
    ops: nothing leaves the device.
    """
    B, T = tree_tokens.shape
    dev = tree_tokens.device
    tok = tree_tokens.long()
    par = parent.long()
    nl = n_live.long()
    ch = chosen.long()
    slots = torch.arange(T, device=dev)[None, :]
    live = (slots < nl[:, None]) & (slots > 0)
    acc = torch.zeros((B, T), dtype=torch.long, device=dev)
    acc[:, 0] = ch[:, 0]
    kvs = torch.zeros((B, T), dtype=torch.long, device=dev)
    cur = torch.zeros((B, 1), dtype=torch.long, device=dev)
    n = torch.ones((B, 1), dtype=torch.long, device=dev)
    done = (nl <= 0)[:, None]
    for _ in range(max(T - 1, 0)):
        want = ch.gather(1, cur)
        ok = (par == cur) & (tok == want) & live & ~done
        nxt = ok.to(torch.int32).argmax(dim=1, keepdim=True)  # first max
        found = ok.gather(1, nxt)
        acc.scatter_(1, n, torch.where(found, ch.gather(1, nxt),
                                       acc.gather(1, n)))
        kvs.scatter_(1, n, torch.where(found, nxt, kvs.gather(1, n)))
        cur = torch.where(found, nxt, cur)
        n = torch.where(found, n + 1, n)
        done = done | ~found
    n = torch.where(nl[:, None] > 0, n, torch.zeros_like(n))[:, 0]
    return n.int(), acc.int(), kvs.int()


def pack_step_result(n_acc: torch.Tensor, acc_tokens: torch.Tensor,
                     kv_slots: torch.Tensor) -> torch.Tensor:
    """Pack the fused-step outputs into the ONE (B, 1+2T) int32 tensor that
    crosses to the host per decode step:
    ``[n_acc | acc_tokens (T) | kv_slots (T)]`` per lane."""
    return torch.cat([n_acc[:, None].int(), acc_tokens.int(),
                      kv_slots.int()], dim=1)


__all__ = ["TransformerConfig", "Params", "lane_index", "init_cache", "prefill",
           "prefill_into_slot", "reset_slot", "tree_step", "commit_cache",
           "verify_accept_device", "pack_step_result", "blocks_per_lane",
           "init_paged_cache", "paged_row_index", "prefill_paged",
           "prefill_into_slot_paged", "prefill_from_offset_paged",
           "copy_paged_block", "tree_step_paged", "commit_paged_cache",
           "reset_blocks", "train_logits", "lm_loss"]
