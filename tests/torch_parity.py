"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; outputs
come back as float32 numpy arrays and are compared by the largest absolute
error relative to the reference's largest magnitude.
"""

import contextlib

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


def reference_int4_kernel_route(monkeypatch) -> list:
    """Make ltx_tpu's linear_any take its int4 kernel route on the CPU, as
    it does on a TPU: `_use_pallas_int4` becomes the shape rule alone and
    `int4_matmul` runs in Pallas interpret mode. Returns a list that gains
    one entry each time the reference traces or calls the kernel."""
    from ltx_tpu.kernels import quantization as jq

    tiles = (1024, 768, 512, 256)
    calls = []

    def shape_rule(p, x):
        return bool("w_q4" in p and jq._pick_block(x.shape[-1], tiles)
                    and jq._pick_block(p["w_q4"].shape[1], tiles)
                    and x.shape[-1] % jq.PACK_BLOCK == 0)

    def interpreted(p, x):
        calls.append(tuple(x.shape))
        return kernel(p, x, interpret=True)

    kernel = jq.int4_matmul
    monkeypatch.setattr(jq, "_use_pallas_int4", shape_rule)
    monkeypatch.setattr(jq, "int4_matmul", interpreted)
    return calls


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to `n` for the duration. The generation
    loops run thousands of small ops a token; when six test workers share
    the cores, each process's default of one thread a core oversubscribes
    them and every small op waits on the others (one file took 290 s under
    such load, 24 s on one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
