"""The frozen FLOP and byte counts against hand counts at tiny shapes, and
the trace's reduction on a made-up timeline."""

from __future__ import annotations

import pytest

from benchmark import flops
from benchmark.tests.tiny import tiny_config, tiny_traffic
from benchmark.trace import group_of, summarize


def test_least_seconds_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.least_seconds(989e9, 6.7e12) == pytest.approx(2.0)


def test_attention_and_norm_counts():
    assert flops.attention_flops(2, 3, 5, 4) == 4 * 2 * 3 * 5 * 4
    assert flops.attention_bytes(2, 3, 5, 4, False) == 2 * 2 * 4 * (2 * 3 + 2 * 5)
    assert flops.attention_bytes(2, 3, 5, 4, True) == 2 * 2 * 4 * 16 + 4 * 5


def test_video_clip_work_by_hand():
    cfg, tr = tiny_config("ltx2-video"), tiny_traffic()
    work = flops.clip_work(cfg, tr.params)
    tv, s, d, ff, h, hd = 5 * 2 * 2, 16, 128, 512, 4, 32
    block = (4 * 2 * tv * d * d + 2 * 2 * tv * d * d + 2 * 2 * s * 128 * d
             + 2 * 2 * tv * d * ff + 4 * h * hd * (tv * tv + tv * s))
    assert work["dit_step_flops"] == 2 * block
    # 2 attentions a block, 2 blocks, 8 steps, and the connector's 2 layers
    assert work["attentions"] == 2 * 2 * 8 + 2
    assert work["norms"] == 6 * 2 * 8 + 9
    att = flops.least_seconds(4 * h * hd * tv * tv, 2 * h * hd * 4 * tv)
    cross = flops.least_seconds(4 * h * hd * tv * s, 2 * h * hd * (2 * tv + 2 * s) + 4 * s)
    conn = flops.least_seconds(4 * 4 * 16 * s * s, 2 * 4 * 16 * 4 * s)
    assert work["attention_seconds"] == pytest.approx(16 * (att + cross) + 2 * conn)


def test_av_clip_work_by_hand():
    cfg, tr = tiny_config("ltx2-av"), tiny_traffic()
    work = flops.clip_work(cfg, tr.params)
    tv, ta, s, dv, da = 20, 34, 16, 128, 64
    video = (4 * 2 * tv * dv * dv + 2 * 2 * tv * dv * dv + 2 * 2 * s * dv * dv
             + 2 * 2 * tv * dv * 4 * dv + 4 * 4 * 32 * (tv * tv + tv * s))
    audio = (4 * 2 * ta * da * da + 2 * 2 * ta * da * da + 2 * 2 * s * da * da
             + 2 * 2 * ta * da * 4 * da + 4 * 4 * 16 * (ta * ta + ta * s))
    cross = (2 * tv * dv * da + 2 * 2 * ta * da * da + 2 * tv * da * dv
             + 2 * ta * da * da + 2 * 2 * tv * dv * da + 2 * ta * da * da
             + 4 * 4 * 16 * 2 * tv * ta)
    assert work["dit_step_flops"] == 2 * (video + audio + cross)
    assert work["attentions"] == 6 * 2 * 8 + 2 * 2
    assert work["norms"] == 20 * 2 * 8 + 2 * 9


def test_kernel_groups():
    assert group_of("void flash_fwd_kernel<128, true>(Params)") == "attention"
    assert group_of("pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>") == "attention"
    assert group_of("void rms_norm_kernel<__nv_bfloat16>(...)") == "rms_norm"
    assert group_of("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NTN") == "gemm"
    assert group_of("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "conv"
    assert group_of("elementwise_kernel") == "other"


def test_summarize_unions_intervals_and_labels_gaps():
    ms = 1_000_000
    kernels = [(0, 10 * ms, "gemm_a"), (5 * ms, 12 * ms, "flash_fwd_kernel"),
               (20 * ms, 30 * ms, "rms_norm_kernel"), (40 * ms, 45 * ms, "gemm_a")]
    marks = [(0, 15 * ms, "text"), (15 * ms, 35 * ms, "denoise")]
    out = summarize(kernels, 0, 50 * ms, marks)
    assert out["busy_s"] == pytest.approx(0.027)
    assert out["window_s"] == pytest.approx(0.05)
    assert out["group_seconds"]["attention"] == pytest.approx(0.007)
    assert out["breakdown"]["idle_gaps"][0] == ["between clips", pytest.approx(0.01)]
    assert ["denoise", pytest.approx(0.008)] in out["breakdown"]["idle_gaps"]
    assert out["breakdown"]["device_ops"][0] == ["gemm_a", pytest.approx(0.015)]
