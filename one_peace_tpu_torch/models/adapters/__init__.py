"""Modality adapters."""
