"""Host microseconds a call of the int4 wrappers, on one NVIDIA GPU.

    cd <a checkout> && python3 <this checkout>/scripts/int4_host_cost.py

Imports `ltx_tpu_torch` from the current directory (so that two checkouts
can be compared with one script), builds its int4 library, and times the
host's enqueue of `int4_matmul` and `dequant_int4` at the DiT's attention
projection ((1536, 4096) x (4096, 4096)) while the card is busy with
earlier work, so that the host never waits for the card. Prints one JSON
line. Fails without CUDA.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from ltx_tpu_torch import checks  # noqa: E402
from ltx_tpu_torch.kernels import quantization as qz  # noqa: E402

CALLS = 400
LEAD_PRODUCTS = 32  # 8192^3 bf16 products queued ahead, ~1.5 ms each


def host_us(fn) -> float:
    fn()
    blocker = torch.zeros(8192, 8192, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    for _ in range(LEAD_PRODUCTS):
        torch.matmul(blocker, blocker)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int4_host_cost: CUDA is not available")
    device = torch.device("cuda", 0)
    case = next(c for c in checks.INT4_CASES if c.name == "dit_attn_proj")
    x, qp = checks.int4_inputs(case, device)
    args = (qp["w_q4"], qp["scale"], qp["bias"])
    out = {"checkout": os.getcwd(), "gpu": torch.cuda.get_device_name(0)}
    for name, fn in (("int4_matmul", lambda: qz.int4_matmul(x, *args)),
                     ("dequant_int4", lambda: qz.dequant_int4(*args))):
        out[f"{name}_us"] = sorted(host_us(fn) for _ in range(5))[2]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
