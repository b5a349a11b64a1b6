"""Where the fused int4 kernel's time goes, on one NVIDIA GPU.

    python3 scripts/int4_matmul_variants.py

Builds the committed `ltx_tpu_torch/csrc/int4_matmul.cu` three times into
`build/int4_variants/`, each with a part of its work switched off by a text
edit of the source, and times `ltx_int4_matmul` of each (CUDA events
around 20 launches on an idle card, after 3 warm-ups) at the DiT's four
int4 shapes:

  full           the kernel as committed;
  products_only  no dequant: the consumers skip the weight tiles' dequant
                 and stores (the products read stale tiles) and only free
                 each stage's codes;
  dequant_only   no products: the wgmma instructions are skipped.

Only `full` computes the product; the others are timings. Prints one line
per shape and variant, then the card's name and power limit.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ltx_tpu_torch import checks  # noqa: E402
from ltx_tpu_torch.kernels import build  # noqa: E402

OUT = build.BUILD_DIR.parent / "int4_variants"
DEQUANT = "    if (h + 1 < n_halves) dequant(h + 1);"
FREE_CODES = ("    if (h + 1 < n_halves && ((h + 1) & 1)) { __syncwarp(); if (lane == 0) "
              "mbar_arrive(c_empty + 8 * (((h + 1) / 2) % kCodeSlots)); }")
PRODUCT = "        wgmma_tb_m64n128k16(acc[j],"
SHAPES = ("dit_attn_proj", "dit_ff_in", "dit_ff_out", "dit_text_kv")


def variants(src: str) -> dict:
    for piece in (DEQUANT, "  dequant(0);\n", PRODUCT):
        if piece not in src:
            raise SystemExit(f"int4_matmul_variants: the source no longer holds {piece!r}")
    return {
        "full": src,
        "products_only": src.replace(DEQUANT, FREE_CODES).replace("  dequant(0);\n", ""),
        "dequant_only": src.replace(PRODUCT, "        if (p.m < 0) " + PRODUCT.strip()),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int4_matmul_variants: CUDA is not available")
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "int4_matmul.cu").read_text().replace(
        '#include "hopper.cuh"', f'#include "{build.CSRC_DIR / "hopper.cuh"}"')
    procs = {}
    for name, text in variants(src).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"int4_matmul_variants: {name} failed to build:\n{log}")
    device = torch.device("cuda", 0)
    for case in (c for c in checks.INT4_CASES if c.name in SHAPES):
        x, qp = checks.int4_inputs(case, device)
        y = torch.empty(case.m, case.n, dtype=torch.bfloat16, device=device)
        for name in procs:
            fn = ctypes.CDLL(str(OUT / f"{name}.so")).ltx_int4_matmul
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

            def call():
                err = fn(x.data_ptr(), qp["w_q4"].data_ptr(), qp["scale"].data_ptr(),
                         qp["bias"].data_ptr(), y.data_ptr(), case.m, case.k, case.n,
                         case.group, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            print(f"{case.name} ({case.m}, {case.k}) x ({case.k}, {case.n}) {name}: "
                  f"{start.elapsed_time(end) / 20:.4f} ms", flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"gpu: {gpu.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
