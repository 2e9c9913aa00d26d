"""Activation checkpointing of the PyTorch port (checkpointing.py)."""
