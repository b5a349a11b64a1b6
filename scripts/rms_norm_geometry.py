"""The RMSNorm kernel under other launch geometries, on one NVIDIA GPU.

    python3 scripts/rms_norm_geometry.py

Times the committed kernel's C entry (`ltx_rms_norm`, built as
`kernels/rms_norm.py` builds it) at the inference paths' shapes of
`checks.RMS_CASES` under the geometry `kernels/rms_norm.py::geometry`
chooses and under others of the same kernel: CTAs an SM, warps a CTA and
ring stages a warp (whole rows). Each by `chip_smoke.queued_ms` (launches
queued behind earlier work over inputs rotated past the L2's size), every
output bit for bit the chosen geometry's. Prints one line per shape and
geometry with its share of the bound by bytes, then the card's name and
power limit.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import PEAK_BYTES_PER_S, gpu_name_and_power, queued_ms, rotated_sets  # noqa: E402
from ltx_tpu_torch import checks  # noqa: E402
from ltx_tpu_torch.kernels import rms_norm as rk  # noqa: E402

SHAPES = ("dit_stage2_adaln", "one_row_9216_qk", "dit_stage1_qk", "dit_stage1_text_k",
          "north_star_qk", "connector_two_rows_qk", "connector_qk")
# (CTAs an SM, warps a CTA, stages a warp)
GEOMETRIES = ((2, 4, 3), (1, 4, 6), (1, 8, 3), (2, 2, 6), (1, 2, 12), (2, 8, 1), (3, 4, 2),
              (2, 4, 1), (1, 8, 2))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rms_norm_geometry: CUDA is not available")
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fn = rk._c_function()
    for name in SHAPES:
        case = next(c for c in checks.RMS_CASES if c.name == name)
        x, w = checks.rms_inputs(case, device)
        chosen = rk.geometry(case.rows, case.d, x.element_size(),
                             0 if w is None else w.element_size(), sms)
        want = rk.rms_norm(x, w)
        xs = [s[0] for s in rotated_sets((x,), x.numel() * x.element_size())]
        ys = [torch.empty_like(x) for _ in xs]
        nbytes = 2.0 * x.numel() * x.element_size() + (0 if w is None else
                                                        w.numel() * w.element_size())
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        geometries = [(0, chosen.warps, chosen.stages, chosen.grid)] + [
            (per_sm, warps, stages, min(case.rows, per_sm * sms))
            for per_sm, warps, stages in GEOMETRIES]
        for per_sm, warps, stages, grid in geometries:
            def call(i, warps=warps, stages=stages, grid=grid):
                err = fn(xs[i].data_ptr(), None if w is None else w.data_ptr(),
                         ys[i].data_ptr(), case.rows, case.d, 1e-6,
                         int(x.dtype == torch.bfloat16),
                         int(w is not None and w.dtype == torch.bfloat16), grid, warps,
                         stages, case.d * x.element_size(), 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            try:
                call(0)
            except RuntimeError as e:
                print(f"[geometry] {name}: {per_sm} CTAs an SM x {warps} warps x {stages} "
                      f"stages refused ({e})", flush=True)
                continue
            torch.cuda.synchronize()
            same = torch.equal(ys[0], rk.rms_norm(xs[0], w))
            ms = queued_ms([lambda i=i: call(i) for i in range(len(xs))])
            label = "chosen" if per_sm == 0 else f"{per_sm} CTAs an SM"
            print(f"[geometry] {name} ({case.rows}, {case.d}): {label}, grid {grid} x {warps} "
                  f"warps x {stages} stages: {ms:.4f} ms, {bound / ms:.3f} of the bound "
                  f"({bound:.4f} ms); bitwise the chosen's: {same}", flush=True)
        del xs, ys, want
    print(f"[geometry] gpu: {gpu_name_and_power()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
