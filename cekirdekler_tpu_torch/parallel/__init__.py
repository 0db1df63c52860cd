"""Attention over one device: the dense reference (ring and Ulysses come later)."""
