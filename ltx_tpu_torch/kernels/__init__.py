"""Hand-written Hopper kernels, each beside its plain PyTorch version."""
