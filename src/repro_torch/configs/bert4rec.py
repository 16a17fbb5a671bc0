"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, seq 200,
bidirectional cloze.  Encoder-only: serve = last-position scoring (the
numbers of ``repro.configs.bert4rec``)."""
from repro_torch.configs import recsys_common as rc
from repro_torch.configs.recsys_common import Input, ServeCell
from repro_torch.models.recsys import bert4rec as model

ARCH = "bert4rec"
SHAPES = rc.SHAPES
N_ITEMS = 1_000_000
N_CAND = 512            # ranking-stage candidates per user


def full_config() -> model.Bert4RecConfig:
    return model.Bert4RecConfig(n_items=N_ITEMS, embed_dim=64, n_blocks=2,
                                n_heads=2, seq_len=200)


def smoke_config() -> model.Bert4RecConfig:
    return model.Bert4RecConfig(n_items=500, embed_dim=16, n_blocks=2,
                                n_heads=2, seq_len=24)


def serve_cell(shape: str, cfg: model.Bert4RecConfig = None) -> ServeCell:
    """``serve``: retrieval_cand scores the full catalog (B = 1, 10^6
    items), serve_p99 / serve_bulk rank N_CAND candidates per user."""
    rc.check_serve_shape(shape)
    cfg = cfg or full_config()
    B, S = rc.BATCHES[shape], cfg.seq_len
    ins = (Input("ids", (B, S), "int32"), Input("pad_mask", (B, S), "bool"))
    if shape != "retrieval_cand":
        ins += (Input("cand_ids", (B, N_CAND), "int32"),)
    return ServeCell(model.serve, ins)
