"""ltx_tpu_torch — the PyTorch/CUDA port of ltx_tpu for NVIDIA Hopper.

A second package beside the JAX reference `ltx_tpu`, laid out like it
(`ops/`, `kernels/`, `models/`, `pipeline/`, with `config.py` for
`core/config.py`). It imports torch and numpy, and nothing of jax or of
`ltx_tpu`: it runs where only torch is installed. Every Pallas kernel of the
reference gets a hand-written Hopper kernel under `kernels/` and `csrc/`,
with a plain PyTorch version beside it for CPU runs and comparisons.

Numerics contract, set on import: float32 matrix products and float32
convolutions run in full float32 (no TF32), and bf16 matrix products reduce
in float32 (no reduced-precision reduction), matching the reference's
`preferred_element_type=float32` dots.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
