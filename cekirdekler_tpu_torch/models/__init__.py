"""The flagship decoder-only transformer (forward pass and train step)."""

from .transformer import (
    Transformer,
    TransformerConfig,
    adamw,
    cross_entropy_loss,
    params_from_jax,
)

__all__ = ["Transformer", "TransformerConfig", "adamw", "cross_entropy_loss", "params_from_jax"]
