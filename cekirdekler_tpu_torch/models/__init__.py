"""The flagship decoder-only transformer (forward pass)."""

from .transformer import Transformer, TransformerConfig, cross_entropy_loss, params_from_jax

__all__ = ["Transformer", "TransformerConfig", "cross_entropy_loss", "params_from_jax"]
