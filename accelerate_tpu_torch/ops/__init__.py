"""Kernels of the port and their plain PyTorch versions."""

from .ring_attention import ring_attention, ring_self_attention
