"""The RMSNorm kernel's store routes, against an older kernel, on one NVIDIA GPU.

    python3 scripts/rms_norm_variants.py [--parent OTHER_CHECKOUT]

Builds the committed `ltx_tpu_torch/csrc/rms_norm.cu` twice into
`build/rms_variants/`, the second time with its whole-row store changed by a
text edit of the source, and times `ltx_rms_norm` of each at every
`checks.RMS_CASES` shape of 1024 rows or more, by `chip_smoke.queued_ms`
(launches queued behind earlier work over inputs rotated past the L2's
size), beside `F.rms_norm` and the bound by bytes:

  vector_stores  the kernel as committed: each lane stores its scaled
                 16-byte pieces from registers to global memory;
  bulk_stores    each lane writes its scaled pieces back into the row's
                 stage, then lane 0 stores the row with one bulk copy
                 (cp.async.bulk.global.shared::cta after fence.proxy.async)
                 and waits for the copy to have read the stage before it
                 refills it;
  parent         with --parent, that checkout's csrc/rms_norm.cu as it is,
                 if it is the one-block-a-row kernel (C entry without the
                 geometry arguments): the rows' pieces held in registers.

The variants run in turns (parent, vector, bulk, bulk, vector, parent) and
each reading is the mean of its turns. The bulk variant's output is
compared with the committed kernel's, bit for bit (the parent sums in
another order). Prints one line per shape, then
the card's name and power limit.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import PEAK_BYTES_PER_S, gpu_name_and_power, queued_ms, rotated_sets  # noqa: E402
from ltx_tpu_torch import checks  # noqa: E402
from ltx_tpu_torch.kernels import build  # noqa: E402
from ltx_tpu_torch.kernels import rms_norm as rk  # noqa: E402

OUT = build.BUILD_DIR.parent / "rms_variants"
WHOLE = ("      scale_store<TX, TW, kWeighted>(src, wr, out, row_pieces, lane, inv);\n")
BULK = """      scale_store<TX, TW, kWeighted>(src, wr, const_cast<TX*>(src), row_pieces, lane, inv);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                     :: "l"(reinterpret_cast<uint64_t>(out)), "r"(smem_u32(src)),
                        "r"(static_cast<uint32_t>(row_bytes))
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
      }
"""
LOOP_END = "    if (lane == 0 && t + stages < items) issue(t + stages);\n  }\n"
DRAIN = LOOP_END + ('  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\\n"'
                    ' ::: "memory");\n')


def variants(src: str) -> dict:
    for piece in (WHOLE, LOOP_END):
        if piece not in src:
            raise SystemExit(f"rms_norm_variants: the source no longer holds {piece!r}")
    return {"vector_stores": src,
            "bulk_stores": src.replace(WHOLE, BULK).replace(LOOP_END, DRAIN)}


def build_all(sources: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"rms_norm_variants: {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so")).ltx_rms_norm
    return libs


def caller(name: str, fn, sms: int):
    """A function (x, w, y) -> None launching variant `name` on the current
    stream; raises on a CUDA error."""
    if name == "parent":
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    else:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])

    def call(x, w, y):
        rows, d = x.shape
        w_bf16 = int(w is not None and w.dtype == torch.bfloat16)
        args = (x.data_ptr(), None if w is None else w.data_ptr(), y.data_ptr(), rows, d,
                1e-6, int(x.dtype == torch.bfloat16), w_bf16)
        if name != "parent":
            g = rk.geometry(rows, d, x.element_size(), 0 if w is None else w.element_size(),
                            sms)
            args += (g.grid, g.warps, g.stages, g.stage_bytes, g.chunks)
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose rms_norm.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rms_norm_variants: CUDA is not available")
    src = (build.CSRC_DIR / "rms_norm.cu").read_text().replace(
        '#include "hopper.cuh"', f'#include "{build.CSRC_DIR / "hopper.cuh"}"')
    sources = variants(src)
    if args.parent:
        sources["parent"] = (Path(args.parent) / "ltx_tpu_torch/csrc/rms_norm.cu").read_text()
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    calls = {name: caller(name, fn, sms) for name, fn in build_all(sources).items()}
    order = ["vector_stores", "bulk_stores", "bulk_stores", "vector_stores"]
    if "parent" in calls:
        order = ["parent"] + order + ["parent"]
    for case in (c for c in checks.RMS_CASES if c.rows >= 1024):
        x, w = checks.rms_inputs(case, device)
        want = torch.empty_like(x)
        calls["vector_stores"](x, w, want)
        for name, call in calls.items():
            got = torch.empty_like(x)
            call(x, w, got)
            if name != "parent" and not torch.equal(got, want):
                raise SystemExit(f"rms_norm_variants: {name} differs at {case.name}")
        xs = [s[0] for s in rotated_sets((x,), x.numel() * x.element_size())]
        ys = [torch.empty_like(x) for _ in xs]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(queued_ms(
                [lambda i=i, name=name: calls[name](xs[i], w, ys[i]) for i in range(len(xs))]))
        lib_w = None if w is None else w.to(x.dtype)
        library = queued_ms([lambda t=t: F.rms_norm(t, (case.d,), lib_w, 1e-6) for t in xs])
        nbytes = 2.0 * x.numel() * x.element_size() + (0 if w is None else
                                                        w.numel() * w.element_size())
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        means = {name: sum(v) / len(v) for name, v in times.items()}
        print(f"[variants] {case.name} ({case.rows}, {case.d}) {case.dtype} weight={case.weight}: "
              + ", ".join(f"{name} {ms:.4f} ms ({bound / ms:.3f} of the bound; turns "
                          + "/".join(f"{t:.4f}" for t in times[name]) + ")"
                          for name, ms in means.items())
              + f"; F.rms_norm {library:.4f} ms; bound {bound:.4f} ms (bytes)", flush=True)
        del xs, ys
    print(f"[variants] gpu: {gpu_name_and_power()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
