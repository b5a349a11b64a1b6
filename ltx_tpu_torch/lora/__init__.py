"""LoRA adapters fused into the DiT."""
