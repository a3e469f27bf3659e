"""Weights and helpers."""
