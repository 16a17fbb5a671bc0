from .transformer import TransformerConfig, prefill, tree_step
from .params import init_params, params_from_jax

__all__ = ["TransformerConfig", "init_params", "params_from_jax", "prefill",
           "tree_step"]
