"""Tensor ops: schedule, RoPE, embeddings, latents, normalization, attention."""
