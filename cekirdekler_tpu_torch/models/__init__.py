"""The flagship decoder-only transformer (forward pass and train step) and
its mixture-of-experts FFN."""

from .moe import moe_ffn, moe_ffn_capacity, moe_ffn_sharded, record_routing
from .transformer import (
    Transformer,
    TransformerConfig,
    adamw,
    cross_entropy_loss,
    params_from_jax,
)

__all__ = ["Transformer", "TransformerConfig", "adamw", "cross_entropy_loss", "moe_ffn",
           "moe_ffn_capacity", "moe_ffn_sharded", "params_from_jax", "record_routing"]
