"""The RMSNorm route and the card kernel's schedule, on the CPU.

`ops.normalization.rms_route` decides, for every call of `rms_norm`, between
the hand-written kernel (csrc/rms_norm.cu) and the plain chain; its branches
are covered here, and its wiring through `rms_norm`. The kernel itself runs
only on the card (tests/test_torch_cuda.py), so its schedule is emulated in
torch: `kernels.rms_norm.geometry`'s persistent grid, the rows each CTA and
each warp take, every warp's ring of stages with its mbarriers (a copy lands
when a wait on its phase needs it; a wait whose phase has completed reads
the stage as it is), the chunked two-pass form of very wide rows, each
lane's fma sums over its 16-byte pieces (one accumulator a position in the
piece, added in order), and the butterfly of shuffles. The
emulation is held to `checks.rms_tolerance` against `rms_norm_reference` at
every `checks.RMS_CASES` shape, gives a row the same bits alone as in its
batch, and must break the tolerance when its schedule is broken.
"""

import collections
import dataclasses

import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.ops import normalization

H100_SMS = 132
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs many small tensor ops: one intra-op thread keeps
    them fast where the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# (device type, d, weight ndim, dtype, autograd records, route)
ROUTES = [
    ("cuda", 4096, None, BF16, False, "kernel"),
    ("cuda", 4096, 1, BF16, False, "kernel"),
    ("cuda", 3840, 1, F32, False, "kernel"),
    ("cuda", 128, None, F32, False, "kernel"),
    ("cpu", 4096, None, BF16, False, "chain"),
    ("cpu", 3840, 1, F32, False, "chain"),
    ("meta", 4096, None, BF16, False, "chain"),
    ("cuda", 4096, None, BF16, True, "chain"),
    ("cuda", 3840, 1, F32, True, "chain"),
    ("cpu", 4096, 1, BF16, True, "chain"),
    ("cuda", 100, None, BF16, False, "chain"),
    ("cuda", 4160, 1, BF16, False, "chain"),
    ("cuda", 4096, 2, BF16, False, "chain"),
    ("cuda", 4096, 0, F32, False, "chain"),
    ("cuda", 4096, None, torch.float16, False, "chain"),
    ("cuda", 4096, 1, torch.float64, False, "chain"),
]


@pytest.mark.parametrize("device_type,d,weight_ndim,dtype,records,route", ROUTES)
def test_rms_route(device_type, d, weight_ndim, dtype, records, route):
    """The kernel exactly where the reference's own dispatch would take its
    Pallas kernel (d % 128, weight None or 1-D) and the card can run it (a
    CUDA tensor of bf16 or f32 that autograd does not record)."""
    assert normalization.rms_route(device_type, d, weight_ndim, dtype, records) == route


def test_rms_norm_asks_the_route_what_the_call_needs(monkeypatch):
    """rms_norm hands the route the tensor's device type, last dim, weight
    rank and dtype, and whether autograd records the call; "kernel" goes to
    the kernel's wrapper unless `forced_rms_chain()` is on, and the chain
    counts nothing for a CPU tensor."""
    asked, launched = [], []
    answer = ["chain"]

    def route(*args):
        asked.append(args)
        return answer[0]

    monkeypatch.setattr(normalization, "rms_route", route)
    monkeypatch.setattr(normalization.rms_kernel, "rms_norm",
                        lambda x, w=None, eps=1e-6: launched.append(x.shape) or x)
    x = torch.randn(3, 256)
    w = torch.ones(256, requires_grad=True)
    before = normalization.rms_chain_on_cuda
    normalization.rms_norm(x)
    normalization.rms_norm(x.bfloat16(), torch.ones(1, 256))
    normalization.rms_norm(x.requires_grad_(True))
    normalization.rms_norm(x.detach(), w)
    with torch.no_grad():
        normalization.rms_norm(x, w)
    with torch.inference_mode():
        normalization.rms_norm(torch.randn(3, 256))
    assert asked == [("cpu", 256, None, F32, False), ("cpu", 256, 2, BF16, False),
                     ("cpu", 256, None, F32, True), ("cpu", 256, 1, F32, True),
                     ("cpu", 256, 1, F32, False), ("cpu", 256, None, F32, False)]
    assert launched == [] and normalization.rms_chain_on_cuda == before
    answer[0] = "kernel"
    normalization.rms_norm(x.detach())
    assert launched == [(3, 256)]
    with normalization.forced_rms_chain():
        with normalization.forced_rms_chain():
            normalization.rms_norm(x.detach())
        got = normalization.rms_norm(x.detach())
    assert launched == [(3, 256)]
    assert torch.equal(got, rk.rms_norm_reference(x.detach()))
    normalization.rms_norm(x.detach())
    assert launched == [(3, 256), (3, 256)]


# ---------------------------------------------------------------------------
# the card kernel's schedule, emulated

def _warp_items(g, rows, cta, warp):
    """(first row, row step, rows) of one warp: CTA `cta` owns rows cta,
    cta + grid, ...; its warp w the CTA's rows w, w + warps, ...."""
    cta_rows = (rows - 1 - cta) // g.grid + 1 if cta < rows else 0
    mine = (cta_rows - 1 - warp) // g.warps + 1 if cta_rows > warp else 0
    return cta + g.grid * warp, g.grid * g.warps, mine


def _schedule(g, rows, fault=None):
    """{(row, item): (source row, source chunk) or None}: what each item of
    each row found in its stage when the warp read it. A row is one item
    (whole rows) or 2 * chunks (the chunks for the sum, then for the scale).
    Item t of a warp lives in stage t % stages; lane 0 issues items 0 ..
    stages - 1 first, then item t + stages after item t; a wait on parity p
    blocks while the stage's barrier is in a phase of parity p, landing the
    stage's oldest copy (one copy completes one phase), and returns at once
    otherwise. Faults: "wrong_parity" waits on the other parity,
    "row_stride" steps a warp's rows by the grid alone."""
    per_row = 1 if g.chunks == 1 else 2 * g.chunks
    found = {}
    for cta in range(g.grid):
        for warp in range(g.warps):
            first, step, mine = _warp_items(g, rows, cta, warp)
            if fault == "row_stride":
                step = g.grid
            items = mine * per_row

            def tag(t):
                return (first + (t // per_row) * step,
                        0 if g.chunks == 1 else (t % per_row) % g.chunks)

            ring = [None] * g.stages
            phases = [0] * g.stages
            pending = [collections.deque() for _ in range(g.stages)]
            for t in range(min(g.stages, items)):
                pending[t].append(tag(t))
            for t in range(items):
                s = t % g.stages
                parity = (t // g.stages + (fault == "wrong_parity")) & 1
                while phases[s] & 1 == parity:
                    if not pending[s]:
                        raise RuntimeError("a wait that no copy completes: the card hangs")
                    ring[s] = pending[s].popleft()
                    phases[s] += 1
                found[(tag(t)[0], t % per_row)] = ring[s]
                if t + g.stages < items:
                    pending[s].append(tag(t + g.stages))
    return found


def _gather(x, found, item, chunks, stage_vals, only):
    """(len(only), d) f32: what the rows `only` of x (rows, d) found in their
    items item .. item + chunks - 1, chunk c in its place; a stage read
    before any copy landed, or filled from past the last row, holds zeros;
    rows that no warp took stay NaN."""
    rows, d = x.shape
    out = torch.full((len(only), d), float("nan"))
    for i, row in enumerate(only):
        for k in range(item, item + chunks):
            if (row, k) not in found:
                continue
            tag = found[(row, k)]
            lo = (k - item) * stage_vals
            hi = min(d, lo + stage_vals)
            out[i, lo:hi] = 0.0
            if tag is not None and tag[0] < rows:
                src = x[tag[0], tag[1] * stage_vals:tag[1] * stage_vals + hi - lo]
                out[i, lo:lo + src.numel()] = src.float()
    return out


def _lane_sums(acc, chunk, kvec):
    """acc (n, 32, kvec) f32 plus the squares of `chunk` (n, v): lane l
    takes the 16-byte pieces l, l + 32, ... in order, and its accumulator j
    value j of each piece, one fma a value (the product exact in float64,
    one rounding of the sum to float32)."""
    n, v = chunk.shape
    pieces = v // kvec
    padded = -(-pieces // 32) * 32
    data = torch.zeros(n, padded * kvec, dtype=torch.float64)
    data[:, :v] = chunk.double()
    data = data.view(n, padded // 32, 32, kvec)
    acc = acc.double()
    for k in range(padded // 32):
        acc = (data[:, k] * data[:, k] + acc).float().double()
    return acc.float()


def _lane_totals(acc):
    """Each lane's sum of its accumulators, acc[..., 0] + acc[..., 1] + ...
    in order, in float32."""
    total = acc[..., 0]
    for j in range(1, acc.shape[-1]):
        total = total + acc[..., j]
    return total


def _butterfly(acc):
    """The shuffle tree: five xor exchanges; every lane must end equal."""
    lanes = torch.arange(32)
    for offset in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ offset]
    assert torch.equal(acc, acc[:, :1].expand_as(acc)) or not torch.isfinite(acc).all()
    return acc[:, 0]


def emulate_rms_kernel(x, weight=None, eps=1e-6, sms=H100_SMS, fault=None, only=None):
    """What csrc/rms_norm.cu computes for x (rows, d), step by step on the
    CPU: the whole launch's schedule, and the arithmetic of the rows `only`
    (all by default; (len(only), d) out). Faults, besides `_schedule`'s:
    "skipped_chunk" leaves a wide row's second chunk out of its sum. Returns
    (out, the schedule's findings)."""
    rows, d = x.shape
    xs = x.element_size()
    g = rk.geometry(rows, d, xs, 0 if weight is None else weight.element_size(), sms)
    kvec, stage_vals = 16 // xs, g.stage_bytes // xs
    found = _schedule(g, rows, fault)
    only = range(rows) if only is None else only
    first = _gather(x, found, 0, g.chunks, stage_vals, only)
    second = first if g.chunks == 1 else _gather(x, found, g.chunks, g.chunks, stage_vals,
                                                only)
    acc = torch.zeros(len(only), 32, kvec)
    for c in range(g.chunks):
        if fault == "skipped_chunk" and c == 1:
            continue
        acc = _lane_sums(acc, first[:, c * stage_vals:(c + 1) * stage_vals], kvec)
    inv = torch.rsqrt(_butterfly(_lane_totals(acc)) / torch.tensor(float(d)) + eps)
    out = second * inv[:, None]
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype), found


def _case(name):
    return next(c for c in checks.RMS_CASES if c.name == name)


# the rows whose arithmetic the emulation computes at a case: every row's
# schedule is checked, and a strided sample of rows (with the last)
SAMPLED_ROWS = 256


def _sampled(rows: int) -> list:
    only = list(range(0, rows, max(1, rows // SAMPLED_ROWS)))
    return only if only[-1] == rows - 1 else only + [rows - 1]


@pytest.mark.parametrize("case", checks.RMS_CASES, ids=lambda c: c.name)
def test_rms_kernel_schedule_emulation_within_tolerance(case):
    """Every row's every item read from its own bytes, once, by the launch
    `geometry` gives the case on an H100; the sampled rows' outputs within
    the card's element tolerance of the plain version (checks.rms_tolerance).
    The sampled rows hold `checks.rms_inputs` of a case of as many rows, the
    others zeros: the schedule, checked first, reads each row's own."""
    only = _sampled(case.rows)
    data, w = checks.rms_inputs(dataclasses.replace(case, rows=len(only)), "cpu")
    x = torch.zeros(case.rows, case.d, dtype=data.dtype)
    x[only] = data
    g = rk.geometry(case.rows, case.d, x.element_size(),
                    0 if w is None else w.element_size(), H100_SMS)
    got, found = emulate_rms_kernel(x, w, only=only)
    per_row = 1 if g.chunks == 1 else 2 * g.chunks
    assert found == {(r, k): (r, k % g.chunks) for r in range(case.rows)
                     for k in range(per_row)}
    plain32, tol = checks.rms_tolerance(data, w, got)
    share = checks.tolerance_share(got, plain32, tol)
    print(f"[parity] rms_norm kernel emulation {case.name}: {share:.3f} of the element bound")
    assert got.dtype == x.dtype and share <= 1.0


@pytest.mark.parametrize("name", checks.RMS_BITWISE_CASES)
def test_rms_kernel_emulation_row_alone_equals_row_in_batch(name):
    """A row's output bits do not depend on the batch around it: each of a
    few rows alone, and a run of rows from the middle as its own batch,
    equal their rows of the whole batch bit for bit."""
    case = _case(name)
    x, w = checks.rms_inputs(case, "cpu")
    mid = case.rows // 2
    runs = [range(0, 1), range(mid, mid + 1), range(case.rows - 1, case.rows),
            range(mid // 2, mid // 2 + min(64, max(1, case.rows // 3)))]
    needed = sorted({r for run in runs for r in run})
    full = dict(zip(needed, emulate_rms_kernel(x, w, only=needed)[0]))
    for run in runs:
        alone = emulate_rms_kernel(x[run.start:run.stop], w)[0]
        assert torch.equal(alone, torch.stack([full[r] for r in run])), run


@pytest.mark.parametrize("fault,name", [("wrong_parity", "north_star_adaln"),
                                        ("wrong_parity", "connector_qk"),
                                        ("row_stride", "batched_adaln"),
                                        ("skipped_chunk", "chunked_d32768_f32")])
def test_rms_kernel_schedule_faults_break_the_tolerance(fault, name):
    """A ring read on the wrong parity (a stage read before its copy lands,
    or a row's data read for the next), rows stepped wrongly across a CTA's
    warps (rows missed, others taken twice) and a chunk left out of a wide
    row's sum each break the tolerance the card kernel is held to, at the
    sampled rows."""
    case = _case(name)
    x, w = checks.rms_inputs(case, "cpu")
    only = _sampled(case.rows)
    got = emulate_rms_kernel(x, w, fault=fault, only=only)[0]
    plain32, tol = checks.rms_tolerance(x[only], w, got)
    share = checks.tolerance_share(got, plain32, tol)
    print(f"[parity] rms_norm kernel schedule with {fault} at {name}: {share:.3g} of the "
          "element bound")
    assert not share <= 1.0


def test_rms_geometry_fits_the_card():
    """Every RMS_CASES launch: its shared memory within its CTA's budget,
    no more CTAs than rows or than two an SM; a ring a warp of every item
    it takes or of two at least; whole rows where they fit, else chunks of
    a multiple of 32 lanes x 16 bytes."""
    budgets = dict(rk.SMEM_PER_CTA)
    for case in checks.RMS_CASES:
        xs = 2 if case.dtype == "bfloat16" else 4
        ws = 0 if case.weight is None else (2 if case.weight == "bfloat16" else 4)
        g = rk.geometry(case.rows, case.d, xs, ws, H100_SMS)
        w_bytes = -(-case.d * ws // 128) * 128 if g.chunks == 1 else 0
        smem = rk.BAR_BYTES + w_bytes + g.warps * g.stages * g.stage_bytes
        per_sm = 2 if g.grid <= H100_SMS or smem <= budgets[2] else 1
        items = max(_warp_items(g, case.rows, 0, w)[2] for w in range(g.warps)) \
            * (1 if g.chunks == 1 else 2 * g.chunks)
        assert 1 <= g.warps <= rk.MAX_WARPS, case.name
        assert min(2, items) <= g.stages <= min(rk.MAX_STAGES, max(items, 1)), case.name
        assert smem <= budgets[per_sm] and g.grid <= min(case.rows, per_sm * H100_SMS)
        if g.chunks == 1:
            assert g.stage_bytes == case.d * xs
        else:
            assert g.stage_bytes % 512 == 0 and case.d * xs > budgets[1] // 2
            assert (g.chunks - 1) * g.stage_bytes < case.d * xs <= g.chunks * g.stage_bytes
