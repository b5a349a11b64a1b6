"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; outputs
come back as float32 numpy arrays and are compared by the largest absolute
error relative to the reference's largest magnitude.
"""

import numpy as np
import torch


def as_np(x) -> np.ndarray:
    """A torch tensor or a jax/numpy array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def as_torch(x, dtype=torch.float32) -> torch.Tensor:
    """numpy -> torch on the CPU, rounded to `dtype` (bf16 rounds to
    nearest even, as jnp.asarray(x, jnp.bfloat16) does)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (max |want| floored at 1e-30)."""
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.isfinite(g).all(), "non-finite values in the port's output"
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def assert_rel(got, want, tol: float, what: str) -> float:
    err = rel_err(got, want)
    print(f"[parity] {what}: {err:.3e} (tol {tol:.1e})")
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol:.1e}"
    return err
