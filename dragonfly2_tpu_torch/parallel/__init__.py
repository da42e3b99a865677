"""Attention reference (parallel/ring.py: dense_attention)."""
