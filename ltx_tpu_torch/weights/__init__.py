"""Checkpoint files: reading, key maps, local layout, quantized cache."""
