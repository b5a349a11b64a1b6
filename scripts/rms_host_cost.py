"""Host microseconds a call of the RMSNorm paths, on one NVIDIA GPU.

    cd <a checkout> && python3 <this checkout>/scripts/rms_host_cost.py

Imports `ltx_tpu_torch` from the current directory (so that two checkouts
can be compared with one script), builds its rms_norm library, and times
the host's enqueue, at the north star's weighted q/k norm (1536 x 4096
bf16, a bf16 weight; `checks.RMS_CASES` "north_star_qk") while the card is
busy with earlier work, so that the host never waits for the card, of:

  wrapper  the kernel's wrapper, `kernels.rms_norm.rms_norm`;
  routed   `ops.normalization.rms_norm` as the checkout routes it by
           default (the kernel where the route takes it; the plain chain in
           a checkout that kept the chain by default);
  chain    the plain chain, `kernels.rms_norm.rms_norm_reference`.

Each is the median of five runs of CALLS calls under torch.inference_mode.
Prints one JSON line. Fails without CUDA.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from ltx_tpu_torch import checks  # noqa: E402
from ltx_tpu_torch.kernels import rms_norm as rk  # noqa: E402
from ltx_tpu_torch.ops import normalization  # noqa: E402

CALLS = 100  # the chain launches about six kernels a call: the queue holds them all
LEAD_PRODUCTS = 32  # 8192^3 bf16 products queued ahead, ~1.5 ms each


def host_us(fn) -> float:
    fn()
    blocker = torch.zeros(8192, 8192, dtype=torch.bfloat16, device="cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        for _ in range(LEAD_PRODUCTS):
            torch.matmul(blocker, blocker)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[2]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rms_host_cost: CUDA is not available")
    device = torch.device("cuda", 0)
    case = next(c for c in checks.RMS_CASES if c.name == "north_star_qk")
    x, w = checks.rms_inputs(case, device)
    out = {"checkout": os.getcwd(), "gpu": torch.cuda.get_device_name(0),
           "shape": [case.rows, case.d]}
    with torch.inference_mode():
        for name, fn in (("wrapper", lambda: rk.rms_norm(x, w)),
                         ("routed", lambda: normalization.rms_norm(x, w)),
                         ("chain", lambda: rk.rms_norm_reference(x, w))):
            out[f"{name}_us"] = host_us(fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
