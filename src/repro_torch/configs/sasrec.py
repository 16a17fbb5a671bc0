"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq 50,
causal self-attention, next-item objective (the numbers of
``repro.configs.sasrec``)."""
from repro_torch.configs import recsys_common as rc
from repro_torch.configs.recsys_common import Input, ServeCell
from repro_torch.models.recsys import sasrec as model

ARCH = "sasrec"
SHAPES = rc.SHAPES
N_ITEMS = 1_000_000
N_CAND = 512            # ranking-stage candidates per user


def full_config() -> model.SasRecConfig:
    # embed_dim 50 padded to 52 (heads=1; the reference keeps d%4==0)
    return model.SasRecConfig(n_items=N_ITEMS, embed_dim=52, n_blocks=2,
                              n_heads=1, seq_len=50)


def smoke_config() -> model.SasRecConfig:
    return model.SasRecConfig(n_items=300, embed_dim=16, n_blocks=2,
                              n_heads=1, seq_len=12)


def serve_cell(shape: str, cfg: model.SasRecConfig = None) -> ServeCell:
    """``serve``: retrieval_cand scores the full catalog (no candidates),
    serve_p99 / serve_bulk rank N_CAND candidates per user."""
    rc.check_serve_shape(shape)
    cfg = cfg or full_config()
    B, S = rc.BATCHES[shape], cfg.seq_len
    ins = (Input("ids", (B, S), "int32"), Input("pad_mask", (B, S), "bool"))
    if shape != "retrieval_cand":
        ins += (Input("cand_ids", (B, N_CAND), "int32"),)
    return ServeCell(model.serve, ins)
