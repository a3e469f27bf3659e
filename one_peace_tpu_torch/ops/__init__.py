"""Attention and its CUDA kernel."""
