"""Split-RoPE cos/sin tables: the hand-written Hopper kernel and its plain version.

The plain version is `ops.rope.precompute_freqs_cis`: float64 numpy on the
host, returned as float32. The CUDA kernel is `ltx_tpu_torch/csrc/rope_tables.cu`,
built with nvcc for sm_90a on first use and bound with ctypes; it computes
the same tables on the card in float64 from the f32 position grid and
writes f32 straight into the (num_heads, T, dim / 2 / num_heads) layout
that `ops.rope.apply_rope_split` reads. It replaces no TPU kernel: the JAX
package builds these tables in host numpy.

`rope_tables` takes the plain version only for the CPU. For a CUDA device it
launches the kernel or raises: there is no fallback. It counts its
launches in `rope_tables.launches`, one a table.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ltx_tpu_torch.kernels import build
from ltx_tpu_torch.ops.rope import _freq_indices_f64, precompute_freqs_cis

_LIB = "rope_tables"
_C_FNS = {}


def _c_function():
    fn = _C_FNS.get("ltx_rope_tables")
    if fn is None:
        fn = build.load(_LIB).ltx_rope_tables
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _C_FNS["ltx_rope_tables"] = fn
    return fn


def rope_tables(grid: np.ndarray, dim: int, theta: float = 10000.0,
                max_pos: Sequence[int] = (20, 2048, 2048), num_heads: int = 32,
                device=None):
    """The (cos, sin) tables of `precompute_freqs_cis(grid, dim, theta,
    max_pos, num_heads)` as f32 tensors (num_heads, T, dim / 2 / num_heads)
    on `device` (None: the CPU). grid: (n_pos, T) positions, float32.

    On the CPU: the plain version. On a CUDA device: one launch of the
    kernel, counted in `rope_tables.launches`. Nothing larger than the grid
    and the frequency vector crosses to the card; they go together, from
    pinned memory, without waiting for the card."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        cos, sin = precompute_freqs_cis(grid, dim, theta=theta, max_pos=max_pos,
                                        num_heads=num_heads)
        return torch.from_numpy(cos), torch.from_numpy(sin)
    if device.type != "cuda":
        raise ValueError(f"rope_tables: unsupported device {device}")
    grid = np.asarray(grid, dtype=np.float32)
    n_pos, seq_len = grid.shape
    if len(max_pos) != n_pos or seq_len == 0:
        raise ValueError(f"rope_tables: grid {grid.shape} against max_pos {tuple(max_pos)}")
    idx = _freq_indices_f64(dim, n_pos, theta)
    freq_dim = idx.shape[0] * n_pos
    pad = max(0, dim // 2 - freq_dim)
    if (pad + freq_dim) % num_heads:
        raise ValueError(f"rope_tables: {pad + freq_dim} columns over {num_heads} heads")
    per_head = (pad + freq_dim) // num_heads

    # one pinned buffer: the frequencies and max_pos (f64), then the grid (f32)
    n64 = idx.shape[0] + n_pos
    host = torch.empty(8 * n64 + 4 * grid.size, dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    view[:8 * n64].view(np.float64)[:] = np.concatenate(
        [idx, np.asarray(max_pos, dtype=np.float64)])
    view[8 * n64:].view(np.float32).reshape(n_pos, seq_len)[:] = grid
    index = device.index if device.index is not None else torch.cuda.current_device()
    inputs = host.to(device, non_blocking=True)
    cos = torch.empty((num_heads, seq_len, per_head), dtype=torch.float32, device=device)
    sin = torch.empty_like(cos)
    base = inputs.data_ptr()
    args = (base + 8 * n64, base, base + 8 * idx.shape[0], cos.data_ptr(), sin.data_ptr(),
            seq_len, n_pos, idx.shape[0], pad, per_head)
    fn = _C_FNS.get("ltx_rope_tables") or _c_function()
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"rope_tables kernel launch failed: CUDA error {err}")
    rope_tables.launches += 1
    return cos, sin


rope_tables.launches = 0
