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
  * under a mesh (``repro_torch.distributed``): GSPMD's placement written
    out (``Layout``).  Each rank computes on its parameter blocks
    (``distributed.sharding.placement``): this rank's query and KV heads
    (column-parallel ``wq``/``wk``/``wv``), a row-parallel ``wo`` and
    ``w_down`` followed by an all-reduce over ``model``, a layer's
    "fsdp" blocks gathered over ``data`` before its products, a
    vocab-parallel embedding lookup and vocab-sharded logits.  The dense
    KV cache is this rank's ``batch`` × ``kv_heads`` block
    (``cache_logical_axes``; the ``flash_decode`` backend's is its block
    of ``cache_partition_spec``) and the step runs on this rank's lanes.
    The paged pool is this rank's ``kv_heads`` block, whole over ``data``
    (the prefix cache shares blocks between lanes); a paged call runs
    this rank's lanes too, and the ranks of the lanes' axes then exchange
    the pool rows each wrote, so their pools stay alike.
    Inputs are global (every rank passes the same); the cache and the
    logits that come back are this rank's blocks (``cache_sharding``,
    ``Layout.logits``).  ``moe_impl`` "auto" runs the expert-parallel
    ``moe_ep``.  ``lm_loss`` under a mesh takes this rank's lanes (all of
    them where the batch does not split) and sums the loss over the lanes'
    ranks; under rules that map ``residual_seq`` to live axes (the
    reference's train cells) the residual between the products is this
    rank's sequence block (sequence parallelism).  Every move has its
    transpose, so each rank gets the gradient of its parameter blocks.
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

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.flash_decode import (cache_partition_spec,
                                                  seq_offset, write_rows)
from repro_torch.distributed.sharding import (NamedSharding, P, active_mesh,
                                              active_rules, dim_axes,
                                              gather_blocks, logical_spec,
                                              placement, reduce_scatter,
                                              reduce_sum, shard, sum_grad,
                                              unshard)
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
    # MoE (models/moe.py): "auto" resolves to "ep" under a mesh with a
    # model axis, else "ref"; "local" runs the capacity dispatch on one rank
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


def param_logical_axes(cfg: TransformerConfig) -> Params:
    """Logical-axis names per param (the reference's; checkpoints record
    them, and ``restore(mesh=)`` places each leaf by them)."""
    layers = {
        "ln1": (None, None), "ln2": (None, None),
        "wq": (None, "fsdp", "tensor"), "wk": (None, "fsdp", "tensor"),
        "wv": (None, "fsdp", "tensor"), "wo": (None, "tensor", "fsdp"),
    }
    if cfg.qkv_bias:
        layers.update({"bq": (None, "tensor"), "bk": (None, "tensor"),
                       "bv": (None, "tensor")})
    if cfg.moe:
        layers.update({
            "router": (None, "fsdp", None),
            "we_gate": (None, "expert", "fsdp", None),
            "we_up": (None, "expert", "fsdp", None),
            "we_down": (None, "expert", None, "fsdp"),
        })
        if cfg.n_shared_experts:
            layers.update({"ws_gate": (None, "fsdp", "tensor"),
                           "ws_up": (None, "fsdp", "tensor"),
                           "ws_down": (None, "tensor", "fsdp")})
    else:
        layers.update({"w_gate": (None, "fsdp", "tensor"),
                       "w_up": (None, "fsdp", "tensor"),
                       "w_down": (None, "tensor", "fsdp")})
    out = {"embed": ("tensor", "fsdp"), "ln_f": (None,), "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("fsdp", "tensor")
    return out


def param_shapes(cfg: TransformerConfig) -> Params:
    """The global shape of every parameter, in ``param_logical_axes``'
    structure."""
    d, dh, H, K, L = (cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads,
                      cfg.n_layers)
    layers = {"ln1": (L, d), "ln2": (L, d), "wq": (L, d, H * dh),
              "wk": (L, d, K * dh), "wv": (L, d, K * dh),
              "wo": (L, H * dh, d)}
    if cfg.moe:
        E, F = cfg.n_experts, cfg.moe_d_ff
        layers.update(router=(L, d, E), we_gate=(L, E, d, F),
                      we_up=(L, E, d, F), we_down=(L, E, F, d))
        if cfg.n_shared_experts:
            Fs = F * cfg.n_shared_experts
            layers.update(ws_gate=(L, d, Fs), ws_up=(L, d, Fs),
                          ws_down=(L, Fs, d))
    else:
        layers.update(w_gate=(L, d, cfg.d_ff), w_up=(L, d, cfg.d_ff),
                      w_down=(L, cfg.d_ff, d))
    if cfg.qkv_bias:
        layers.update(bq=(L, H * dh), bk=(L, K * dh), bv=(L, K * dh))
    out = {"embed": (cfg.vocab_size, d), "ln_f": (d,), "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


# ----------------------------------------------------------- placement (SPMD)
def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _block_index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's block index along a dim split over ``axes``."""
    return NamedSharding(mesh, P(axes or None))._index(1)[0]


class Layout:
    """How one call of the model lies on the active mesh for a batch of
    ``batch`` lanes: GSPMD's partitioning of the reference, written out.
    Without a mesh every method is the identity and every count whole.

    The compute follows the parameters' ``placement`` under the active
    rules.  The query heads split where ``wq``'s columns split over the
    "tensor" axes and H divides; the KV heads where ``wk``'s do and K
    divides as well.  Where ``wk``'s block would split a head (``model``
    divides K·dh but not K), ``wk``/``wv`` are gathered whole and every
    rank computes all K heads (the cache's ``kv_heads`` dim is then whole
    by the same rule).  A rank's query heads then read the KV heads
    ``kv_runs`` names: runs of local heads that read one KV head each
    (global query head i reads KV head i // G, so a rank's heads may span
    two KV heads), each run attending on its own (``per_kv_head``; the
    kernels map head i to KV head i // G within a call); the
    ``flash_decode`` backend, whose sequence shards combine every head,
    gathers q over ``q_block`` inside its attend and keeps this rank's
    heads of the output.  Where H does not divide (a rank's ``wq``
    columns hold a part of a head), the rank's columns of q are
    all-gathered over ``q_gather`` for every call (the transpose a
    reduce-scatter): every rank attends with all H heads, and
    ``attn_out`` takes the columns of the output that its rows of ``wo``
    multiply, as GSPMD partitions the reference.  A
    row-parallel product (``wo``, ``w_down``, the embedding lookup over a
    vocab block) is followed by ``rows`` (``reduce_sum`` in float32),
    and the input of a product whose ranks do different work passes
    ``columns`` (``fan_in``, whose transpose sums its gradient over
    them: Megatron's f and g).
    ``weight`` turns a leaf into what this rank multiplies: its "tensor"
    block (sliced from a whole leaf, or gathered where the compute keeps
    the dim whole) with its "fsdp" dims gathered — the per-layer FSDP
    gather.  A leaf may be whole or this rank's block under the active
    rules; anything else raises.  Under autograd a weight's gradient is
    summed over the lanes' ranks (the FSDP gather's transpose, a
    reduce-scatter, sums it over ``data``).  Where the lanes are not split
    over an axis that gathers a weight (a batch or microbatch that
    ``data`` does not divide), every rank along it computes the same
    lanes and the same gradient: the transpose takes it once there, as
    GSPMD's partitioning of the replicated batch does, instead of adding
    the replicas' copies.  The MoE's router and experts under ``moe_ep``
    are summed by ``moe_ep`` alone; under ``moe_ref`` or ``moe_local``
    every rank holds every expert (gathered), runs them on its tokens and
    sums their gradients over the axes that split the tokens, and
    ``moe_local``, whose capacity couples the tokens, routes every token
    of the call (gathered over ``tokens``) and keeps its own.

    A train call (``seq``, the sequence length, given) takes its lanes
    from the "batch" axes and splits the residual stream along the
    sequence over the live ``residual_seq`` axes where they divide
    ``seq`` (Megatron's sequence parallelism, the reference's
    ``constrain(h, "batch", "residual_seq", None)`` hooks): between the
    products a rank keeps its (B_l, S/m, d) block (``residual``, what
    remat saves), the norms run on it, ``columns`` all-gathers the normed
    block before the column-parallel products (its transpose a
    reduce-scatter) and ``rows`` reduce-scatters the row-parallel partial
    sums along the sequence (its transpose an all-gather).  Over a whole
    vocab the embedding looks up the rank's token block and the loss head
    runs on the residual's block (``head_seq``).  ``moe_ep`` takes the
    reference's token groups, not the residual's blocks: the normed
    residual is all-gathered along the sequence, ``moe_ep`` splits this
    rank's lanes' (lane, position)-ordered tokens over the mesh axes the
    lanes do not split, and the rank keeps its sequence block of the
    output.  It needs the row-parallel products (``wo``, a dense or
    shared-expert FFN) and a vocab block to split over the residual's
    axes, and raises otherwise (ROADMAP A16b).  A serving call under
    rules with a live ``residual_seq`` raises (ROADMAP A16b).

    The lanes of a serving call: the dense layout splits them as the
    cache's ``batch`` dim (``cache_sharding``), the paged layout as
    ``logical_spec(("batch",), (batch,))`` (its pool has no lane dim), and
    ``local`` / ``gather`` move a global lane-major array to this rank's
    lanes and back.  A batch the lanes' axes do not divide (one lane)
    stays whole: every rank then computes every lane.
    ``logits`` is the sharding of the (B, T, V) logits a call returns
    (lanes, the sequence block where the head runs on it, then the vocab
    block), None where nothing is split."""

    def __init__(self, cfg: TransformerConfig, batch: int,
                 paged: bool = False, seq: Optional[int] = None):
        self.mesh, rules = active_mesh(), active_rules()
        H, K = cfg.n_heads, cfg.n_kv_heads
        self.q_heads, self.kv_heads = H, K
        # (first local query head, end, the KV head they read) a run
        self.kv_runs: Optional[Tuple[Tuple[int, int, int], ...]] = None
        self.q_gather: Tuple[str, ...] = ()     # q gathered, all H heads
        self.q_block: Tuple[str, ...] = ()      # whole heads, every KV head
        self.wo_axes = self.ffn_axes = self.vocab_axes = ()
        self.lane_axes: Tuple[str, ...] = ()
        self.seq_axes: Tuple[str, ...] = ()     # the residual's split
        self.head_seq: Tuple[str, ...] = ()     # the loss head's rows' split
        self.v0 = 0
        self.lanes = self.cache = self.logits = self.residual = None
        self.tokens: Optional[NamedSharding] = None   # (lanes, sequence)
        self._token_weights: frozenset = frozenset()
        self._ep_weights: frozenset = frozenset()
        self._whole: Dict[str, torch.Tensor] = {}
        if self.mesh is None:
            return
        mesh = self.mesh
        # the MoE's leaves: moe_ep sums their gradients itself; the other
        # impls run on this rank's tokens with every expert (gathered)
        moe_w = frozenset({"router", "we_gate", "we_up", "we_down"}
                          if cfg.moe else ())
        ep = bool(moe_w) and moe_impl(cfg, mesh) == "ep"
        self._ep_weights = moe_w if ep else frozenset()
        self._token_weights = frozenset() if ep else moe_w
        split_res = tuple(a for a in dim_axes(logical_spec(
            ("residual_seq",), None, mesh, rules)[0]) if mesh.shape[a] > 1)
        if seq is None and split_res:
            raise NotImplementedError(
                f"a serving call under rules that split the residual over "
                f"{split_res} (residual_seq): sequence parallelism is "
                "ported for the train path only (ROADMAP A16b)")
        axes, shapes = param_logical_axes(cfg), param_shapes(cfg)
        flat_axes = dict(axes["layers"], **{k: v for k, v in axes.items()
                                            if k != "layers"})
        flat_shapes = dict(shapes["layers"], **{
            k: v for k, v in shapes.items() if k != "layers"})
        stored = {n: placement(mesh, flat_axes[n], flat_shapes[n],
                               rules).spec for n in flat_axes}

        def live(entry):                # the entry's axes of size > 1
            return tuple(a for a in dim_axes(entry) if mesh.shape[a] > 1)

        def split(name, dim):
            return live(stored[name][dim]) if name in stored else ()

        qa, ka = split("wq", 2), split("wk", 2)
        n_q = _axes_size(mesh, qa)
        kv_local = bool(qa) and ka == qa and K % n_q == 0
        if kv_local:
            self.q_heads, self.kv_heads = H // n_q, K // n_q
        elif qa and H % n_q:
            self.q_gather = qa               # every rank attends with all H
        elif qa:
            self.q_heads, self.q_block = H // n_q, qa
            self.kv_runs = _kv_runs(_block_index(mesh, qa) * self.q_heads,
                                    self.q_heads, H // K)
        self.wo_axes = split("wo", 1)
        self.ffn_axes = split("ws_down" if cfg.moe else "w_down", 1)
        head = "embed" if cfg.tie_embeddings else "lm_head"
        self.vocab_axes = split(head, 0 if cfg.tie_embeddings else 1)
        if self.vocab_axes:
            self.v0 = _block_index(mesh, self.vocab_axes) * (
                cfg.vocab_size // _axes_size(mesh, self.vocab_axes))
        heads_split = {"wq": bool(qa), "bq": bool(qa), "wk": kv_local,
                       "bk": kv_local, "wv": kv_local, "bv": kv_local}
        self._prep = {}
        for n, ax in flat_axes.items():
            lead = 1 if n in axes["layers"] else 0
            keep = tuple(
                () if a == "fsdp" or (a == "tensor"
                                      and not heads_split.get(n, True))
                or (a == "expert" and not ep)
                else live(e) for a, e in zip(ax, stored[n]))
            self._prep[n] = (flat_shapes[n][lead:], stored[n][lead:],
                             keep[lead:], ax[lead:], bool(lead))
        if seq is not None:             # a train call: no cache
            self.lane_axes, self.seq_axes = (live(e) for e in logical_spec(
                ("batch", "residual_seq"), (batch, seq), mesh, rules))
        else:
            self.cache = (paged_sharding(cfg) if paged
                          else cache_sharding(cfg, batch))
            cache_heads = live(self.cache.spec[3])
            if cache_heads != (ka if kv_local else ()):
                raise NotImplementedError(
                    f"the cache's heads lie on {cache_heads} and wk's on "
                    f"{ka if kv_local else ()} under these rules: a layout "
                    "that moves heads between them is not ported")
            self.lane_axes = live(
                logical_spec(("batch",), (batch,), mesh, rules)[0] if paged
                else self.cache.spec[1])
        if self.seq_axes:
            sp = set(self.seq_axes)
            dense_ffn = not cfg.moe or cfg.n_shared_experts
            if (set(self.wo_axes) != sp
                    or dense_ffn and set(self.ffn_axes) != sp
                    or self.vocab_axes and set(self.vocab_axes) != sp):
                raise NotImplementedError(
                    f"the residual split over {self.seq_axes} "
                    f"(residual_seq), the row-parallel products over wo "
                    f"{self.wo_axes}, FFN {self.ffn_axes}, vocab "
                    f"{self.vocab_axes}: sequence parallelism is ported "
                    "for row-parallel products split over the residual's "
                    "axes (ROADMAP A16b)")
            self.residual = NamedSharding(mesh, P(None, self.seq_axes))
            self.head_seq = () if self.vocab_axes else self.seq_axes
            self._token_weights |= frozenset(
                {"ln1", "ln2", "ln_f"}
                | (set() if self.vocab_axes else {"embed", "lm_head"}))
        if self.lane_axes:
            self.lanes = NamedSharding(mesh, P(self.lane_axes))
        if self.lane_axes or self.seq_axes:
            self.tokens = NamedSharding(mesh, P(self.lane_axes or None,
                                                self.seq_axes or None))
        if self.lane_axes or self.vocab_axes or self.head_seq:
            self.logits = NamedSharding(mesh, P(
                self.lane_axes or None, self.head_seq or None,
                self.vocab_axes or None))

    # ------------------------------------------------------------ lanes
    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's lanes of a global (batch, ...) array."""
        return x if self.lanes is None else self.lanes.local(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global (batch, ...) array from every rank's lanes."""
        return x if self.lanes is None else unshard(x, self.lanes)

    def head_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence block of a (B_l, S, ...) array where the
        embedding and the loss head run on the residual's blocks
        (``head_seq``); ``x`` itself otherwise."""
        return x if not self.head_seq else self.residual.local(x)

    def logits_sharding(self, ndim: int) -> Optional[NamedSharding]:
        """The sharding of the (batch, [T,] V) logits a call returns."""
        if self.logits is None or ndim == 3:
            return self.logits
        return NamedSharding(self.mesh, P(self.lane_axes or None,
                                          self.vocab_axes or None))

    # ----------------------------------------------------------- weights
    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """Leaf ``name`` (one layer of a stacked leaf) as this rank
        multiplies it.  A leaf that is not per layer is prepared once a
        call (the embedding's FSDP gather serves the lookup and the tied
        unembedding)."""
        if self.mesh is None:
            return w
        if name in self._whole:
            return self._whole[name]
        glob, stored, keep, names, layered = self._prep[name]
        gat, cut, fsdp = [], [], set()
        for j, (g, s, k) in enumerate(zip(glob, stored, keep)):
            n = _axes_size(self.mesh, dim_axes(s))
            if w.shape[j] == g:                         # whole along j
                gat.append(None)
                cut.append(k or None)
            elif n > 1 and w.shape[j] * n == g:         # the stored block
                gat.append(None if k else tuple(
                    a for a in dim_axes(s) if self.mesh.shape[a] > 1))
                cut.append(None)
                if names[j] == "fsdp":
                    fsdp.update(gat[-1])
            else:
                raise ValueError(
                    f"parameter {name!r} has shape {tuple(w.shape)} (per "
                    f"layer): neither whole {tuple(glob)} nor this rank's "
                    f"block under the active rules ({P(*stored)!r}); place "
                    "parameters inside the sharding_ctx they are served "
                    "in (init_params(mesh=) / shard_params)")
        # moe_ep's weights: its transpose sums their gradients over every
        # axis that splits the tokens, so each rank's is already the total
        total = name in self._ep_weights
        # a weight used on this rank's tokens (its lanes and, under SP, its
        # sequence block), the same work on the ranks of the other axes
        if name in self._token_weights:
            split = set(self.lane_axes) | set(self.seq_axes)
            fsdp = {a for g in gat if g for a in g}     # every gathered axis
        else:
            split = set(self.lane_axes)
        if any(gat):
            # the transpose sums over the gathered axes but the replicas'
            # (the ranks that do the same work)
            sh = NamedSharding(self.mesh, P(*gat))
            same = set(self.mesh.axis_names) if total else fsdp - split
            w = gather_blocks(w, sh, [a for a in sh.axes() if a not in same])
        if any(cut):
            w = shard(w, NamedSharding(self.mesh, P(*cut)))
        if w.requires_grad and torch.is_grad_enabled() and not total:
            # each rank's share of the work (a gather sums those itself)
            w = sum_grad(w, self.mesh, [a for a in self.mesh.axis_names
                                        if a in split and a not in fsdp])
        if not layered:
            self._whole[name] = w
        return w

    def columns(self, x: torch.Tensor, axes: Tuple[str, ...]
                ) -> torch.Tensor:
        """``x``, the (B, T, d) residual, as the input of column-parallel
        work that differs between the ranks of ``axes``: the identity,
        whose transpose sums the gradient over them; under sequence
        parallelism the all-gather of the ranks' sequence blocks, whose
        transpose is the reduce-scatter of that sum."""
        if self.mesh is None or not axes:
            return x
        if self.residual is not None:
            return gather_blocks(x, self.residual)
        return sum_grad(x, self.mesh, axes)

    def rows(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """Row-parallel partial sums over ``axes`` summed; under sequence
        parallelism reduce-scattered, this rank keeping its sequence
        block."""
        if self.mesh is None or not axes:
            return x
        if self.residual is not None:
            return reduce_scatter(x, self.residual)
        return reduce_sum(x, self.mesh, axes)

    def reduce(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """Partial sums over ``axes`` (a row-parallel product) summed."""
        if self.mesh is None or not axes:
            return x
        return reduce_sum(x, self.mesh, axes)

    def attn_out(self, attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        """(B, T, heads, dh) attention output through this rank's rows of
        ``wo``, summed over the ranks.  Where every rank attended with all
        H heads (``q_gather``), the columns its rows multiply."""
        B, T = attn.shape[:2]
        x = attn.reshape(B, T, -1)
        if self.q_gather and self.wo_axes:
            n = x.shape[-1] // _axes_size(self.mesh, self.wo_axes)
            i = _block_index(self.mesh, self.wo_axes)
            x = x[..., i * n:(i + 1) * n]
        return self.rows(x @ wo, self.wo_axes)

    def gather_q(self, q: torch.Tensor) -> torch.Tensor:
        """(B, T, columns) of this rank's ``wq`` block as the (B, T, H·dh)
        of every query head where ``q_gather`` says so (the transpose sums
        the ranks' gradients, each from its own output columns, and keeps
        this rank's block); ``q`` itself otherwise."""
        if not self.q_gather:
            return q
        return gather_blocks(q, NamedSharding(self.mesh,
                                              P(None, None, self.q_gather)))

    def attend_kw(self) -> Dict[str, "Layout"]:
        """The backends' ``layout=`` keyword: under a mesh only, so that
        a backend written for one device needs none."""
        return {} if self.mesh is None else {"layout": self}

    def per_kv_head(self, attend: Callable, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
        """``attend(q, k, v)`` of this rank's query heads (dim 2 of q)
        against the K/V heads (dim -2 of k and v) they read: one call, or
        where ``kv_runs`` says so one call a run on the run's KV head,
        the outputs concatenated along the heads."""
        if self.kv_runs is None:
            return attend(q, k, v)
        outs = [attend(q[:, :, a:b].contiguous(),
                       k[..., kv:kv + 1, :].contiguous(),
                       v[..., kv:kv + 1, :].contiguous())
                for a, b, kv in self.kv_runs]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _kv_runs(h0: int, n: int, G: int) -> Tuple[Tuple[int, int, int], ...]:
    """Query heads h0 .. h0+n-1 (global; head i reads KV head i // G) as
    runs (first local head, end, KV head) that read one KV head each."""
    runs, i = [], 0
    while i < n:
        kv = (h0 + i) // G
        j = min(n, (kv + 1) * G - h0)
        runs.append((i, j, kv))
        i = j
    return tuple(runs)


# ------------------------------------------------------------------- layer fwd
def _qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         lay: Optional[Layout] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's query and KV heads (``lay.q_heads``, ``lay.kv_heads``;
    ``lay`` defaults to the call's ``Layout``, as in every function
    below)."""
    lay = lay or Layout(cfg, h.shape[0])
    dh = cfg.dh
    h = lay.columns(h, lay.wo_axes)        # the whole sequence under SP
    B, T, _ = h.shape
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = lay.gather_q(q)
    K = lay.kv_heads
    return (q.reshape(B, T, lay.q_heads, dh), k.reshape(B, T, K, dh),
            v.reshape(B, T, K, dh))


def moe_impl(cfg: TransformerConfig, mesh=None) -> str:
    """``cfg.moe_impl`` with "auto" resolved: ``moe_ep`` under a mesh with
    a ``model`` axis, ``moe_ref`` otherwise."""
    if cfg.moe_impl != "auto":
        return cfg.moe_impl
    return "ep" if mesh is not None and "model" in mesh.shape else "ref"


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         lay: Optional[Layout] = None) -> torch.Tensor:
    act = ACTS[cfg.act]
    lay = lay or Layout(cfg, h.shape[0])
    if not cfg.moe:
        return lay.rows(swiglu(lay.columns(h, lay.ffn_axes), lp["w_gate"],
                               lp["w_up"], lp["w_down"], act), lay.ffn_axes)
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    mesh = active_mesh()
    impl = moe_impl(cfg, mesh)
    if impl == "ep":
        if mesh is None or "model" not in mesh.shape:
            raise ValueError("moe_impl='ep' needs an active mesh with a "
                             "'model' axis (sharding_ctx); without a mesh "
                             "use 'auto', 'ref' or 'local'")
        # the reference's token groups: under SP this rank's lanes' whole
        # sequence (the rank keeps its block of the output), split by
        # moe_ep in (lane, position) order
        sp = lay.residual
        x = h if sp is None else unshard(h, sp)
        y = moe_lib.moe_ep(x.reshape(-1, d), lp["router"], lp["we_gate"],
                           lp["we_up"], lp["we_down"], cfg.top_k,
                           cfg.capacity_factor, mesh, act,
                           lanes=lay.lane_axes).reshape(x.shape)
        if sp is not None:
            y = shard(y, sp)
    elif impl == "local":
        # capacity couples the tokens: the reference's one group is every
        # token of the call, of which this rank keeps its own
        tok = lay.tokens
        xs = h if tok is None else gather_blocks(h, tok)
        y = moe_lib.moe_local(xs.reshape(-1, d), lp["router"], lp["we_gate"],
                              lp["we_up"], lp["we_down"], cfg.top_k,
                              cfg.capacity_factor, act).reshape(xs.shape)
        if tok is not None:
            y = tok.local(y)
    else:
        y = moe_lib.moe_ref(x, lp["router"], lp["we_gate"], lp["we_up"],
                            lp["we_down"], cfg.top_k, act).reshape(B, T, d)
    if cfg.n_shared_experts:
        y = y + lay.rows(swiglu(lay.columns(h, lay.ffn_axes), lp["ws_gate"],
                                lp["ws_up"], lp["ws_down"], act),
                         lay.ffn_axes)
    return y


def _layer_self(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                positions: torch.Tensor, len_mask: torch.Tensor,
                lay: Optional[Layout] = None, want_kv: bool = True):
    """Self-attention layer over the full sequence (train / prefill).
    Returns new hidden states and the (k, v) tensors for cache filling
    (None with ``want_kv=False``: training keeps no cache)."""
    lay = lay or Layout(cfg, h.shape[0])
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, hn, lay)
    cos, sin = rope_angles(positions, cfg.dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    backend = attn_backends.get_backend(cfg.prefill_backend)
    attn = lay.per_kv_head(lambda q, k, v: backend.prefill_attention(
        cfg, q, k, v, positions, len_mask), q, k, v)
    h = h + lay.attn_out(attn, lp["wo"])
    h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), lay)
    return h, ((k, v) if want_kv else None)


def _layer_tree(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, attend: Callable,
                lay: Optional[Layout] = None) -> torch.Tensor:
    """Tree-decode layer: T slots attend to cache + tree siblings.
    ``attend`` (from ``make_tree_attend``) writes the slots' KV into
    ``k_cache``/``v_cache`` in place, then attends."""
    lay = lay or Layout(cfg, h.shape[0])
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, hn, lay)
    cos, sin = rope_angles(positions, cfg.dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v, k_cache, v_cache)
    h = h + lay.attn_out(attn, lp["wo"])
    return h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), lay)


def _layer_params(cfg: TransformerConfig, params: Params, i: int,
                  lay: Optional[Layout] = None) -> Params:
    """Layer i's weights as this rank multiplies them (``Layout.weight``),
    floating ones cast to the activation dtype (a no-op when the
    parameter and activation dtypes agree)."""
    lay = lay or Layout(cfg, 1)
    out = {}
    for name, a in params["layers"].items():
        w = lay.weight(name, a[i])
        out[name] = w.to(cfg.adtype) if w.is_floating_point() else w
    return out


# ----------------------------------------------------------------- full models
def _embed(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
           lay: Optional[Layout] = None) -> torch.Tensor:
    """The embedding lookup; over a vocab block, rows outside it give 0
    and the ranks' lookups are summed (under sequence parallelism
    reduce-scattered to the rank's sequence block; over a whole vocab the
    rank looks up its token block)."""
    lay = lay or Layout(cfg, tokens.shape[0])
    emb = lay.weight("embed", params["embed"]).to(cfg.adtype)
    if not lay.vocab_axes:
        return emb[lay.head_block(tokens).long()]
    ids = tokens.long() - lay.v0
    inside = (ids >= 0) & (ids < emb.shape[0])
    x = emb[ids.clamp(0, emb.shape[0] - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return lay.rows(x, lay.vocab_axes)


def _unembed(cfg: TransformerConfig, params: Params, h: torch.Tensor,
             lay: Optional[Layout] = None) -> torch.Tensor:
    """Logits over this rank's vocab block (the whole vocab without a
    mesh; under sequence parallelism over a vocab block, of the gathered
    sequence, else of the residual's block)."""
    lay = lay or Layout(cfg, h.shape[0])
    h = lay.columns(rms_norm(h, lay.weight("ln_f", params["ln_f"]),
                             cfg.norm_eps), lay.vocab_axes)
    if cfg.tie_embeddings:
        w = lay.weight("embed", params["embed"]).t()
    else:
        w = lay.weight("lm_head", params["lm_head"])
    return h @ w.to(h.dtype)


def _self_forward(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, write_kv: Callable,
                  lay: Layout) -> torch.Tensor:
    """Causal forward over padded prompts; ``write_kv(i, k, v)`` stores
    layer i's (B, S, K, dh) KV.  Returns the last real token's logits."""
    B, S = tokens.shape
    h = _embed(cfg, params, tokens, lay)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    len_mask = positions < lens[:, None]
    for i in range(cfg.n_layers):
        h, (k, v) = _layer_self(cfg, _layer_params(cfg, params, i, lay), h,
                                positions, len_mask, lay)
        write_kv(i, k, v)
    h_last = h[torch.arange(B, device=h.device), lens.long() - 1]
    return _unembed(cfg, params, h_last, lay)


def _tree_forward(cfg: TransformerConfig, params: Params, cache: Cache,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  attend: Callable, lay: Layout) -> torch.Tensor:
    """Embed ``tokens`` and run every tree-decode layer against the cache's
    per-layer K/V through ``attend``; returns the last hidden states."""
    h = _embed(cfg, params, tokens, lay)
    for i in range(cfg.n_layers):
        h = _layer_tree(cfg, _layer_params(cfg, params, i, lay), h,
                        positions, cache["k"][i], cache["v"][i], attend, lay)
    return h


def _train_hidden(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor, lay: Optional[Layout] = None
                  ) -> torch.Tensor:
    """Embed and run every layer causally over (B, S) tokens (this rank's
    lanes under a mesh), no padding, no cache; returns the last hidden
    states (under sequence parallelism this rank's (B, S/m, d) block of
    them, as between the layers).  Each stacked weight is unbound once,
    so its gradient is one stack of the layers' gradients; with
    ``cfg.remat`` each layer's body is checkpointed (the reference's
    ``jax.checkpoint``) and recomputed in the backward pass, its FSDP
    gathers with it."""
    B, S = tokens.shape
    lay = lay or Layout(cfg, B, seq=S)
    h = _embed(cfg, params, tokens, lay)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    len_mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    names = list(params["layers"])
    per_layer = [a.unbind(0) for a in params["layers"].values()]

    def layer(h, *weights):
        lp = {}
        for n, w in zip(names, weights):
            w = lay.weight(n, w)
            lp[n] = w.to(cfg.adtype) if w.is_floating_point() else w
        return _layer_self(cfg, lp, h, positions, len_mask, lay,
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
    """tokens (B, S) -> logits (B, S, V); plain causal, no padding mask.
    Under a mesh: this rank's block of them (``Layout.logits``)."""
    lay = Layout(cfg, tokens.shape[0], seq=tokens.shape[1])
    return _unembed(cfg, params, _train_hidden(cfg, params,
                                               lay.local(tokens), lay), lay)


def lm_loss(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Mean next-token NLL from f32 log-softmax (over ``loss_mask``'s
    weights when given).  The attention is ``cfg.prefill_backend``'s: train
    through ``dense`` (the CUDA kernels have no backward and refuse inputs
    that require grad).  With ``cfg.remat`` the loss head is checkpointed
    too: the (B, S, V) f32 logits are recomputed in the backward pass, not
    kept.

    Under a mesh each rank runs its lanes (every rank the whole batch
    where the "batch" axes do not divide it), gathers its rows' logits
    over the vocab, and the NLL sum and the weight over the ranks of the
    rows (``reduce_sum``: the lanes' and, where the head runs on the
    residual's sequence blocks, theirs): every rank returns the global
    loss, and backward gives each rank the gradient of its parameter
    blocks."""
    B, S = tokens.shape
    lay = Layout(cfg, B, seq=S)
    h = _train_hidden(cfg, params, lay.local(tokens), lay)
    labels = lay.head_block(lay.local(labels))
    if loss_mask is not None:
        loss_mask = lay.head_block(lay.local(loss_mask))
    vocab = (None if not lay.vocab_axes else NamedSharding(
        lay.mesh, P(None, None, lay.vocab_axes)))

    def head(h, labels, mask):
        logits = _unembed(cfg, params, h, lay)
        if vocab is not None:
            logits = unshard(logits, vocab)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
        if lay.mesh is None:
            if mask is None:
                return nll.mean()
            return (nll * mask).sum() / mask.sum().clamp_min(1.0)
        if mask is None:
            mask = torch.ones_like(nll)
        total, weight = (lay.reduce(x.reshape(1),
                                    lay.lane_axes + lay.head_seq)
                         for x in ((nll * mask).sum(), mask.sum().float()))
        return (total / weight.clamp_min(1.0))[0]

    if cfg.remat:
        return checkpoint(head, h, labels, loss_mask, use_reentrant=False,
                          preserve_rng_state=False)
    return head(h, labels, loss_mask)


def cache_sharding(cfg: TransformerConfig, batch: int
                   ) -> Optional[NamedSharding]:
    """How the dense (L, B, S, K, dh) cache lies on the active mesh: the
    ``flash_decode`` backend's block of ``cache_partition_spec``, else the
    ``batch`` × ``kv_heads`` block of ``cache_logical_axes`` under the
    active rules (an axis that does not divide its dim dropped); None
    without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return None
    if cfg.decode_backend == "flash_decode":
        spec = cache_partition_spec(mesh, batch, cfg.max_seq_len,
                                    cfg.n_kv_heads, cfg.n_heads)
    else:
        spec = logical_spec((None, "batch", None, "kv_heads", None),
                            (cfg.n_layers, batch, cfg.max_seq_len,
                             cfg.n_kv_heads, cfg.dh), mesh, active_rules())
    return NamedSharding(mesh, spec)


def paged_sharding(cfg: TransformerConfig) -> Optional[NamedSharding]:
    """How the paged (L, n_blocks, block_size, K, dh) pool lies on the
    active mesh: its ``kv_heads`` block (the pool is lane-agnostic, so
    every rank holds every block); None without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_spec(
        cache_logical_axes(dataclasses.replace(cfg, kv_layout="paged"))["k"],
        (1, 1, 1, cfg.n_kv_heads, 1), mesh, active_rules()))


def cache_logical_axes(cfg: TransformerConfig) -> Dict[str, Tuple]:
    """Logical-axis names of the cache's leaves (the reference's)."""
    if cfg.kv_layout == "paged":
        # block pool is lane-agnostic: only the head axis is shardable
        return {"k": (None, None, None, "kv_heads", None),
                "v": (None, None, None, "kv_heads", None),
                "block_tables": (None, None)}
    if cfg.decode_backend == "flash_decode":
        return {"k": (None, None, "kv_seq", "kv_heads", None),
                "v": (None, None, "kv_seq", "kv_heads", None)}
    return {"k": (None, "batch", None, "kv_heads", None),
            "v": (None, "batch", None, "kv_heads", None)}


class CacheBlock(dict):
    """A dense-layout cache ``{"k", "v"}`` made under a mesh: this rank's
    block of the global (L, ``batch``, S, K, dh) K and V under
    ``sharding``.  A block alone cannot tell its global lane count (one
    lane a rank may be 1 lane whole or ``data`` lanes split), which the
    calls that take a single lane (``prefill_into_slot`` on one row,
    ``reset_slot``) need."""

    def __init__(self, tensors: Cache, batch: int, sharding: NamedSharding):
        super().__init__(tensors)
        self.batch, self.sharding = batch, sharding


def cache_batch(cache: Cache) -> int:
    """The global lane count of a cache: its block table's rows (paged), a
    ``CacheBlock``'s ``batch``, else its own lanes (a whole cache)."""
    if "block_tables" in cache:
        return cache["block_tables"].shape[0]
    if isinstance(cache, CacheBlock):
        return cache.batch
    if active_mesh() is not None:
        raise ValueError("under a mesh this call needs the cache that "
                         "init_cache or prefill made there (a CacheBlock, "
                         "which knows its global lane count)")
    return cache["k"].shape[1]


def init_cache(cfg: TransformerConfig, batch: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None) -> Cache:
    """Zeroed (L, batch, max_seq_len, K, dh) K and V, or this rank's block
    of them (``cache_sharding``) in a ``CacheBlock``."""
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.dh)
    sh = cache_sharding(cfg, batch)
    dt = dtype or cfg.adtype
    local = shape if sh is None else sh.shard_shape(shape)
    out = {"k": torch.zeros(local, dtype=dt, device=device),
           "v": torch.zeros(local, dtype=dt, device=device)}
    return out if sh is None else CacheBlock(out, batch, sh)


def _seq_rows(cache: Cache, sh: Optional[NamedSharding], S: int
              ) -> Tuple[int, int]:
    """(first global row of this rank's cache block, how many of the rows
    [0, S) lie in it)."""
    if sh is None:
        return 0, S
    Sl = cache["k"].shape[2]
    off = seq_offset(sh.mesh, dim_axes(sh.spec[2]), Sl)
    return off, max(0, min(Sl, S - off))


def _local_lane(lanes: Optional[NamedSharding], batch: int,
                slot: torch.Tensor):
    """(this rank's lane index of global lane ``slot``, clamped into its
    block; a (1,) bool that the lane is this rank's, None where every
    rank holds every lane)."""
    if lanes is None:
        return slot, None
    Bl = lanes.shard_shape((batch,))[0]
    local = slot - lanes._index(1)[0] * Bl
    return local.clamp(0, Bl - 1), (local >= 0) & (local < Bl)


def _lane_write(buf: torch.Tensor, dim: int, lane: torch.Tensor,
                mine: Optional[torch.Tensor], new: torch.Tensor) -> None:
    """``buf``'s lane ``lane`` along ``dim`` set to ``new`` in place, where
    ``mine`` (the lane is this rank's; None: always)."""
    new = new.to(buf.dtype)
    if mine is not None:
        keep = mine.view((1,) * dim + (1,) + (1,) * (buf.dim() - dim - 1))
        new = torch.where(keep, new, buf.index_select(dim, lane))
    buf.index_copy_(dim, lane, new)


def prefill(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            lens: torch.Tensor, cache: Optional[Cache] = None
            ) -> Tuple[Cache, torch.Tensor]:
    """Causal forward over padded prompts; fills cache[:, :, :S] in place
    (of a cache block, the rows of that range in this rank's block).

    cache=None allocates the cache (S must be max_seq_len).  Returns
    (cache, last_logits (B, V)) at position lens-1 of each row: this
    rank's lanes and vocab block under a mesh (``Layout.logits``).
    """
    B, S = tokens.shape
    if cache is None:
        assert S == cfg.max_seq_len, (S, cfg.max_seq_len)
        cache = init_cache(cfg, B, device=tokens.device)
    lay = Layout(cfg, B)
    off, n = _seq_rows(cache, lay.cache, S)

    def write_kv(i, k, v):
        cache["k"][i, :, :n] = k[:, off:off + n]
        cache["v"][i, :, :n] = v[:, off:off + n]

    logits = _self_forward(cfg, params, lay.local(tokens), lay.local(lens),
                           write_kv, lay)
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
    the card a row's rounding depends on it; under a mesh each rank runs
    its lanes, as the cohort prefill does).  Writes KV for positions
    [0, S) of that lane only (other lanes untouched; under a mesh the rank
    that holds the lane writes it).  Returns (cache, last_logits (1, V)),
    the vocab block under a mesh."""
    rows, S = tokens.shape
    B = rows if rows > 1 else cache_batch(cache)
    lay = Layout(cfg, B)
    slot = lane_index(slot, tokens.device)
    lane, mine = _local_lane(lay.lanes, B, slot)
    split = lay.lanes is not None and rows > 1
    row = (lane if split else slot) if rows > 1 else torch.zeros_like(slot)
    off, n = _seq_rows(cache, lay.cache, S)

    def write_kv(i, k, v):
        for name, new in (("k", k), ("v", v)):
            _lane_write(cache[name][i, :, :n], 0, lane, mine,
                        new.index_select(0, row)[:, off:off + n])

    if split:
        tokens, lens = lay.local(tokens), lay.local(lens)
    logits = _self_forward(cfg, params, tokens, lens, write_kv, lay)
    if split:
        logits = lay.gather(logits)
    return cache, logits.index_select(0, slot if rows > 1 else row)


def reset_slot(cache: Cache, slot: Index) -> Cache:
    """Zero one batch lane (an int or a (1,) int tensor) of the KV cache in
    place (of a ``CacheBlock``, on the rank that holds it).  Hygiene only:
    correctness never depends on it (rows >= cache_len are never
    attended)."""
    sh = getattr(cache, "sharding", None)
    lanes = None
    if sh is not None and any(sh.mesh.shape[a] > 1
                              for a in dim_axes(sh.spec[1])):
        lanes = NamedSharding(sh.mesh, P(sh.spec[1]))
    batch = cache_batch(cache) if lanes is not None else 0
    for buf in cache.values():
        lane, mine = _local_lane(lanes, batch, lane_index(slot, buf.device))
        _lane_write(buf, 1, lane, mine,
                    torch.zeros_like(buf.index_select(1, lane)))
    return cache


def tree_step(cfg: TransformerConfig, params: Params, cache: Cache,
              cache_lens: torch.Tensor, tokens: torch.Tensor,
              positions: torch.Tensor, tree_mask: torch.Tensor
              ) -> Tuple[Cache, torch.Tensor]:
    """Lookahead VA forward.

    tokens (B, T), positions (B, T), tree_mask (B, T, T) ancestor-closure.
    Writes the slots' KV at cache_len + slot (in place) and returns
    (cache, logits (B, T, V)): this rank's lanes and vocab block under a
    mesh (``Layout.logits``).
    """
    lay = Layout(cfg, tokens.shape[0])
    cache_lens, tokens, positions, tree_mask = (
        lay.local(x) for x in (cache_lens, tokens, positions, tree_mask))
    S_max = cache["k"].shape[2]
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_tree_attend(cfg, cache_lens, tree_mask, S_max,
                                      **lay.attend_kw())
    h = _tree_forward(cfg, params, cache, tokens, positions, attend, lay)
    return cache, _unembed(cfg, params, h, lay)


def fused_step(cfg: TransformerConfig, params: Params, cache: Cache,
               cache_lens: torch.Tensor, tokens: torch.Tensor,
               positions: torch.Tensor, tree_mask: torch.Tensor,
               parent: torch.Tensor, n_live: torch.Tensor,
               choose: Callable) -> Tuple[Cache, torch.Tensor]:
    """The fused decode step on ``cfg.kv_layout``: the tree step, token
    choice ``choose(logits, tokens, positions, layout)`` (on this rank's
    lanes and logits block under a mesh), the device accept walk and the
    commit.  Returns (cache, packed (B, 1+2T) int32), the packed result
    gathered over the lanes, so every rank's host reads the same."""
    paged = cfg.kv_layout == "paged"
    T = tokens.shape[1]
    lay = Layout(cfg, tokens.shape[0], paged)
    if paged:
        logits = _tree_step_paged(cfg, params, cache, lay, cache_lens,
                                  tokens, positions, tree_mask)
    else:
        cache, logits = tree_step(cfg, params, cache, cache_lens, tokens,
                                  positions, tree_mask)
    tok = lay.local(tokens)
    chosen = choose(logits, tok, lay.local(positions), lay)
    n_acc, acc_tok, kv_slots = verify_accept_device(
        tok, lay.local(parent), lay.local(n_live), chosen)
    packed = lay.gather(pack_step_result(n_acc, acc_tok, kv_slots))
    n_acc, kv_slots = packed[:, 0], packed[:, 1 + T:]
    if paged:
        # the draft rows and the commit's land on the same T rows a lane:
        # one exchange after both
        _share_paged_rows(cache, lay, _commit_paged(cfg, cache, lay,
                                                    cache_lens, kv_slots))
    else:
        cache, _ = commit_cache(cache, cache_lens, kv_slots, n_acc, lay.cache)
    return cache, packed


def commit_cache(cache: Cache, cache_lens: torch.Tensor,
                 gather_idx: torch.Tensor, n_accept: torch.Tensor,
                 sharding: Optional[NamedSharding] = None
                 ) -> Tuple[Cache, torch.Tensor]:
    """Compact accepted slots in place: new position m+j takes KV from
    m+gather[j].

    gather_idx (B, T) slot indices (monotone increasing over valid j);
    n_accept (B,).  Rows beyond n_accept keep garbage (never attended).
    Every source row is gathered into its own tensor before any row is
    written, as JAX's functional update does: row m+j may be the source of
    a later row (gather[j'] = j for j' > j) and must be read first.

    ``sharding`` (``cache_sharding``; a ``CacheBlock``'s own by default)
    says the cache is this rank's block: the rank takes its lanes of the
    global inputs, and an accepted row may lie in another rank's range, so
    each rank contributes the source rows in its range, zeros elsewhere,
    one all-reduce (SUM, on the rows' bits as int32: a sum of one row and
    zeros, exact) over the sequence axes gathers them, and each rank
    writes the rows that land in its own range.
    """
    if sharding is None:
        sharding = getattr(cache, "sharding", None)
    if sharding is not None:
        return _commit_sharded(cache, cache_lens, gather_idx, n_accept,
                               sharding)
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


def _commit_sharded(cache: Cache, cache_lens: torch.Tensor,
                    gather_idx: torch.Tensor, n_accept: torch.Tensor,
                    sharding: NamedSharding) -> Tuple[Cache, torch.Tensor]:
    mesh = sharding.mesh
    _, ba, sa, _, _ = sharding.spec
    seq_axes = dim_axes(sa)
    k = cache["k"]
    Bl, Sl = k.shape[1], k.shape[2]
    lens = NamedSharding(mesh, P(ba)).local(cache_lens).long()
    gi = NamedSharding(mesh, P(ba, None)).local(gather_idx).long()
    off = seq_offset(mesh, seq_axes, Sl)
    src = lens[:, None] + gi - off                      # local source rows
    have = ((src >= 0) & (src < Sl))[None, :, :, None, None]
    bidx = torch.arange(Bl, device=k.device)[:, None]
    rows = []
    for name in ("k", "v"):
        g = cache[name][:, bidx, src.clamp(0, Sl - 1)]      # (L,Bl,T,Kl,dh)
        if seq_axes:
            bits = torch.where(have, g.contiguous().view(torch.int32), 0)
            g = mesh.all_reduce(bits, "sum", seq_axes).view(g.dtype)
        rows.append(g)
    for name, g in zip(("k", "v"), rows):
        write_rows(cache[name], lens - off, g, lead=1)
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
    Under a mesh the pool is this rank's ``kv_heads`` block
    (``paged_sharding``) and the tables are whole.
    """
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    bs, bpl = cfg.kv_block_size, blocks_per_lane(cfg)
    nb = int(n_blocks) if n_blocks else 1 + lanes * bpl
    dt = dtype or cfg.adtype
    shape = (L, nb, bs, K, dh)
    sh = paged_sharding(cfg)
    if sh is not None:                  # this rank's kv_heads block
        shape = sh.shard_shape(shape)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
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


def _share_paged_rows(cache: Cache, lay: Layout, rows: torch.Tensor
                      ) -> None:
    """After a paged call that ran this rank's lanes: every rank of the
    lanes' axes writes the pool rows each of them wrote into its own pool,
    so that theirs stay alike.  ``rows`` holds the flat rows this rank
    wrote (a NULL-block row where it wrote nothing); their K and V, read
    back from the pool, are all-gathered with them and written in the
    ranks' order, which is the lanes' order.  Only NULL-block garbage
    differs between the ranks after it.  Nothing happens where the lanes
    are whole."""
    if not lay.lane_axes:
        return
    mesh = lay.mesh
    L, nb, bs, K, dh = cache["k"].shape
    flat = rows.reshape(-1)
    mine = torch.stack([cache[n].view(L, nb * bs, K, dh)[:, flat]
                        for n in ("k", "v")])               # (2, L, N, K, dh)
    idx = mesh.all_gather(flat, lay.lane_axes).reshape(-1)
    kv = mesh.all_gather(mine, lay.lane_axes).movedim(0, 2)  # (2, L, n, ...)
    for i, name in enumerate(("k", "v")):
        cache[name].view(L, nb * bs, K, dh)[:, idx] = kv[i].reshape(
            L, -1, K, dh)


def prefill_paged(cfg: TransformerConfig, params: Params,
                  tokens: torch.Tensor, lens: torch.Tensor, cache: Cache
                  ) -> Tuple[Cache, torch.Tensor]:
    """Batched causal prefill into a paged cache: row p of lane b lands at
    the physical row its block table maps p to.  Rows past a lane's
    allocated coverage (prompt padding, lanes without a request) resolve to
    the NULL block — garbage, never attended (I3).  Under a mesh each rank
    runs its lanes (``Layout.local``; the logits are its lanes' block) and
    the ranks then exchange the rows they wrote (``_share_paged_rows``)."""
    B, S = tokens.shape
    lay = Layout(cfg, B, paged=True)
    tables = lay.local(cache["block_tables"])
    positions = torch.arange(S, device=tokens.device)[None, :].expand(
        tables.shape[0], S)
    rows = paged_row_index(tables, positions, cfg.kv_block_size)
    logits = _self_forward(
        cfg, params, lay.local(tokens), lay.local(lens),
        lambda i, k, v: _scatter_paged_rows(cache, i, rows, k, v), lay)
    _share_paged_rows(cache, lay, rows)
    return cache, logits


def prefill_into_slot_paged(cfg: TransformerConfig, params: Params,
                            cache: Cache, slot: Index, tokens: torch.Tensor,
                            lens: torch.Tensor
                            ) -> Tuple[Cache, torch.Tensor]:
    """Paged twin of ``prefill_into_slot`` (the same (1, S) or padded
    (B, S) batch): one request's KV scatters through lane ``slot``'s block
    table; every other lane's blocks are untouched (block ownership is
    exclusive).  Under a mesh the padded batch runs as the cohort prefill
    does, each rank its lanes: the rank that holds lane ``slot`` writes its
    rows and hands them to the others (``_share_paged_rows``), and the
    logits are gathered over the lanes.  The (1, S) form's one lane is
    whole: every rank computes and writes it."""
    B, S = tokens.shape
    lay = Layout(cfg, B, paged=True)
    slot = lane_index(slot, tokens.device)
    out_row = slot if B > 1 else torch.zeros_like(slot)
    lane, mine = _local_lane(lay.lanes, B, slot)
    row = lane if B > 1 else out_row
    bt_row = cache["block_tables"].index_select(0, slot)
    positions = torch.arange(S, device=tokens.device)[None, :]
    rows = paged_row_index(bt_row, positions, cfg.kv_block_size)
    if mine is not None:        # another rank's lane: write the NULL block
        rows = torch.where(mine[:, None], rows, torch.zeros_like(rows))
    logits = _self_forward(
        cfg, params, lay.local(tokens), lay.local(lens),
        lambda i, k, v: _scatter_paged_rows(cache, i, rows,
                                            k.index_select(0, row),
                                            v.index_select(0, row)), lay)
    _share_paged_rows(cache, lay, rows)
    return cache, lay.gather(logits).index_select(0, out_row)


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

    Under a mesh the block is this rank's lanes' rows, as the admission's
    is: the rank that holds lane ``slot`` computes the suffix and writes
    its rows, then hands them to the others (``_share_paged_rows``); on
    the other ranks every slot is a pad slot (nothing written but the NULL
    block), and the logits are gathered over the lanes.
    """
    B, Sb = tokens.shape
    assert B == 1, "prefill_from_offset admits one request at a time"
    dev = tokens.device
    slot = lane_index(slot, dev)
    lanes = cache["block_tables"].shape[0]
    lay = Layout(cfg, lanes, paged=True)
    lane, mine = _local_lane(lay.lanes, lanes, slot)
    Bl = lay.local(cache["block_tables"]).shape[0]
    Sp = int(prefill_len or cfg.max_seq_len)
    n_rows = Bl * Sp
    bt_row = cache["block_tables"].index_select(0, slot)
    ar = torch.arange(Sb, device=dev)
    positions = offset.int()[:, None] + ar.int()[None, :]        # (1, Sb)
    causal = torch.ones((Sb, Sb), dtype=torch.bool,
                        device=dev).tril().expand(B, Sb, Sb)
    valid = ar[None, :] < lens.long()[:, None]
    if mine is not None:
        valid = valid & mine[:, None]
    # suffix slot i <-> flat row lane*Sp + offset + i of the padded block;
    # pad slots read the row of column Sp-1 (their results are discarded)
    # and write to a spare row past the block
    col = positions[0].long()
    src = lane * Sp + col.clamp(max=Sp - 1)
    dst = torch.where(valid[0], lane * Sp + col, n_rows)
    block = torch.zeros((n_rows + 1,), dtype=tokens.dtype, device=dev)
    block[dst] = tokens[0]
    block_pos = torch.arange(Sp, device=dev)[None, :]    # as the admission's
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_paged_tree_attend(cfg, bt_row, offset, causal,
                                            valid, **lay.attend_kw())

    def attend_suffix(q, k, v, k_cache, v_cache):
        out = attend(*(x.reshape(n_rows, *x.shape[2:])[src][None]
                       for x in (q, k, v)), k_cache, v_cache)
        full = out.new_zeros((n_rows + 1,) + tuple(out.shape[2:]))
        full[dst] = out[0]
        return full[:n_rows].view(q.shape)

    h = _tree_forward(cfg, params, cache, block[:n_rows].view(Bl, Sp),
                      block_pos.expand(Bl, Sp), attend_suffix, lay)
    last = lane * Sp + offset.long() + lens.long() - 1              # (1,)
    h_last = torch.zeros((Bl, h.shape[-1]), dtype=h.dtype, device=dev)
    h_last.index_copy_(0, lane, h.reshape(n_rows, -1)[last])
    logits = lay.gather(_unembed(cfg, params, h_last, lay))
    rows = paged_row_index(bt_row, positions, cfg.kv_block_size)
    _share_paged_rows(cache, lay, torch.where(valid, rows,
                                              torch.zeros_like(rows)))
    return cache, logits.index_select(0, slot)


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


def _tree_step_paged(cfg: TransformerConfig, params: Params, cache: Cache,
                     lay: Layout, cache_lens: torch.Tensor,
                     tokens: torch.Tensor, positions: torch.Tensor,
                     tree_mask: torch.Tensor) -> torch.Tensor:
    """``tree_step_paged`` on this rank's lanes (their inputs given
    global), its rows not yet shared: the logits."""
    tables, cache_lens, tokens, positions, tree_mask = (
        lay.local(x) for x in (cache["block_tables"], cache_lens, tokens,
                               positions, tree_mask))
    backend = attn_backends.get_backend(cfg.decode_backend)
    attend = backend.make_paged_tree_attend(cfg, tables, cache_lens,
                                            tree_mask, **lay.attend_kw())
    h = _tree_forward(cfg, params, cache, tokens, positions, attend, lay)
    return _unembed(cfg, params, h, lay)


def _slot_rows(cfg: TransformerConfig, lay: Layout, cache: Cache,
               cache_lens: torch.Tensor, T: int) -> torch.Tensor:
    """The flat pool rows of this rank's lanes' positions cache_lens +
    [0, T): where a tree step writes its draft slots and a commit moves
    the accepted ones."""
    lens = lay.local(cache_lens).long()[:, None]
    return paged_row_index(lay.local(cache["block_tables"]),
                           lens + torch.arange(T, device=lens.device),
                           cfg.kv_block_size)


def tree_step_paged(cfg: TransformerConfig, params: Params, cache: Cache,
                    cache_lens: torch.Tensor, tokens: torch.Tensor,
                    positions: torch.Tensor, tree_mask: torch.Tensor
                    ) -> Tuple[Cache, torch.Tensor]:
    """Lookahead VA forward over the paged cache: the decode backend's
    ``make_paged_tree_attend`` scatters draft-slot KV through the block
    tables and attends against the blocks (dense: a gather; cuda: the
    paged kernel).  Under a mesh each rank runs its lanes on its heads
    and the ranks exchange the draft rows they wrote; the logits are its
    lanes' and vocab block (``Layout.logits``)."""
    lay = Layout(cfg, tokens.shape[0], paged=True)
    logits = _tree_step_paged(cfg, params, cache, lay, cache_lens, tokens,
                              positions, tree_mask)
    _share_paged_rows(cache, lay, _slot_rows(cfg, lay, cache, cache_lens,
                                             tokens.shape[1]))
    return cache, logits


def _commit_paged(cfg: TransformerConfig, cache: Cache, lay: Layout,
                  cache_lens: torch.Tensor, gather_idx: torch.Tensor
                  ) -> torch.Tensor:
    """``commit_paged_cache``'s moves on this rank's lanes, not yet
    shared; returns the rows written (``_slot_rows``)."""
    k, v = cache["k"], cache["v"]
    L, nb, bs, K, dh = k.shape
    T = gather_idx.shape[1]
    lens = lay.local(cache_lens).long()[:, None]
    tables = lay.local(cache["block_tables"])
    src = lens + lay.local(gather_idx).long()                    # (B, T)
    dst = _slot_rows(cfg, lay, cache, cache_lens, T)
    src_rows = paged_row_index(tables, src, cfg.kv_block_size).reshape(-1)
    kf = k.view(L, nb * bs, K, dh)
    vf = v.view(L, nb * bs, K, dh)
    kg = kf[:, src_rows]                                    # (L, B*T, K, dh)
    vg = vf[:, src_rows]
    kf[:, dst.reshape(-1)] = kg
    vf[:, dst.reshape(-1)] = vg
    return dst


def commit_paged_cache(cfg: TransformerConfig, cache: Cache,
                       cache_lens: torch.Tensor, gather_idx: torch.Tensor,
                       n_accept: torch.Tensor
                       ) -> Tuple[Cache, torch.Tensor]:
    """Paged twin of ``commit_cache``: logical src/dst positions resolve
    through the block tables; every source row is gathered before any row
    is written (a row may be the source of a later one).  Under a mesh
    each rank moves its lanes' rows and the ranks exchange them."""
    lay = Layout(cfg, cache_lens.shape[0], paged=True)
    rows = _commit_paged(cfg, cache, lay, cache_lens, gather_idx)
    _share_paged_rows(cache, lay, rows)
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


__all__ = ["TransformerConfig", "Params", "param_logical_axes",
           "param_shapes", "Layout", "CacheBlock",
           "cache_logical_axes", "cache_sharding", "paged_sharding",
           "cache_batch", "lane_index", "init_cache", "prefill",
           "prefill_into_slot", "reset_slot", "tree_step", "fused_step",
           "commit_cache",
           "verify_accept_device", "pack_step_result", "blocks_per_lane",
           "init_paged_cache", "paged_row_index", "prefill_paged",
           "prefill_into_slot_paged", "prefill_from_offset_paged",
           "copy_paged_block", "tree_step_paged", "commit_paged_cache",
           "reset_blocks", "train_logits", "lm_loss"]
