"""The traced run's device timeline: torch.profiler's CUDA activity over the
window, reduced to kernel time by name group, the union of kernel intervals
(busy seconds), and the idle gaps labelled by what the host was doing.

Kineto's event times are on the host's realtime clock (time.time_ns), so
the host's phase marks line up with the device's intervals.
"""

from __future__ import annotations

import time

# kernel-name fragments of each group, matched in this order: the port's
# own kernels by name, the library's attention kernels with them
GROUPS = (
    ("attention", ("flash_fwd_kernel", "flash_fwd", "fmha", "attention_kernel",
                   "efficient_attention", "flash_attn", "sdpa")),
    ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("int4_matmul", ("int4_matmul_kernel",)),
    ("dequant_int4", ("dequant_int4_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("conv", ("fprop", "implicit_gemm", "conv", "winograd", "dgrad")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")),
)


def group_of(name: str) -> str:
    for group, fragments in GROUPS:
        if any(f in name for f in fragments):
            return group
    return "other"


class DeviceTrace:
    """Profiles the CUDA activity between __enter__ and __exit__."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._prof.__exit__(*exc)
        return False

    def kernels(self) -> list:
        """[(start_ns, end_ns, name)] of every kernel (copies and memsets
        left out), sorted by start."""
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != DeviceType.CUDA or name.startswith(("Memcpy", "Memset")):
                continue
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        out.sort()
        return out


def phase_at(marks: list, t_ns: int) -> str:
    """The host's phase at t_ns: marks is [(start_ns, end_ns, label)]."""
    for start, end, label in marks:
        if start <= t_ns < end:
            return label
    return "between clips"


def summarize(kernels: list, start_ns: int, end_ns: int, marks: list, top: int = 10) -> dict:
    """Kernel seconds by group, busy seconds (the union of kernel intervals
    inside the window), the window's seconds, and the breakdown: the top
    kernels by device seconds and the longest idle gaps by host phase."""
    by_group, by_name = {}, {}
    busy, gaps = 0, []
    cursor = start_ns
    for start, end, name in kernels:
        start, end = max(start, start_ns), min(end, end_ns)
        if end <= start:
            continue
        sec = (end - start) / 1e9
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + sec
        by_name[name] = by_name.get(name, 0.0) + sec
        if start > cursor:
            gaps.append((start - cursor, cursor))
            cursor = start
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if end_ns > cursor:
        gaps.append((end_ns - cursor, cursor))
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "group_seconds": by_group,
        "busy_s": busy / 1e9,
        "window_s": (end_ns - start_ns) / 1e9,
        "kernels": len(kernels),
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[phase_at(marks, at + length // 2), length / 1e9]
                          for length, at in gaps[:top]],
        },
    }
