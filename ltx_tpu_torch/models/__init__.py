"""Model modules: the DiT, Gemma-3, the text encoder and the VAE decoder."""
