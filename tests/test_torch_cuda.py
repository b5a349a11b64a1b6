"""The port on an NVIDIA GPU: the hand kernels against their plain versions,
and the tiny pipeline on CUDA against the same pipeline on the CPU.

Marked `cuda`; each test skips when no CUDA device is present (decided in
the fixture, never at import). Imports no jax, so it runs on a machine with
only torch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

The cases and tolerances are ltx_tpu_torch.checks', which chip_smoke.py
runs too: attention element by element within 2**-8 * (P @ |V|) plus
(Tk/16 + 16) * 2**-23 * (P @ |V|) plus two bf16 ulps of the exact product
(the f32 softmax times V, checks.attention_exact); the P hand-off of the forward (bf16(q k^T) v) within 2**-8 * (|S| @ |V|)
plus two bf16 ulps; the softmax statistics within 2**-14 (m) and
2**-12 (l) relative; the backward's dQ, dK, dV element by element (the bf16
rounding of P and dS, checks' docstring), exactly 0 on -1e30 masked keys,
in the layouts of q, k and v, and bitwise equal from run to run; the int4
product within one bf16 ulp plus 2**-12 * (|X| @ |W|), at the DiT's and
Gemma's shapes; the W8A8 product's activation codes, int32 accumulator and
bf16 output bit for bit the CPU's (and the accumulator the exact one);
dequant_int4 and quantize_weight on the card bit for bit; the tiny
pipeline's frames within 2e-2; the tiny LoRA train within 5e-2 relative,
in bf16 and with a float32 compute dtype; the tiny AV QLoRA step (int4
dual DiT, head dim 64) within 5e-2 relative, with its launches;
rms_norm within 16 f32 ulps of the plain version's f32 value plus, for a
bf16 output, half a bf16 ulp, bitwise equal from run to run and row by row;
the RoPE tables within one f32 ulp of the plain float64 host build, one
launch a table of a denoise loop;
the tiny two-stage I2V pipeline, its norms through that kernel by the
default route, within 2e-2; the tiny long-video modes (video-to-video,
extension, keyframes, chains, and their audio twins) within the tiny
tolerances; the seeded front, a served job and a denoise resume bit for
bit the direct call; the MLX 4-bit dequantization of the loader on
the card bit for bit; LoRA fusion on the card against the CPU's within
checks.check_fused_leaves' bound, and the fused DiT against the adapter as
a side path within 5e-2; the tiny cycle Gemma's greedy generation
(sequential, speculative, int8 cache, batched) token for token the CPU's;
a SigLIP tower at head dim 72 through the flash kernel within 5e-2 of the
same tower on the plain attention; ring attention on a one-rank mesh within
the ring bounds (checks' derivation: the attention and backward bounds with
their rounding terms doubled, the lse and delta of a rounded forward); a
tiny DiT sharded over a (1, 1) mesh bit for bit the unsharded one.
"""

import pytest
import torch
import torch.nn.functional as F

from ltx_tpu_torch import checks
from ltx_tpu_torch.kernels import flash_attention as fa
from ltx_tpu_torch.kernels import quantization as qz
from ltx_tpu_torch.kernels import rms_norm as rk
from ltx_tpu_torch.ops import normalization
from ltx_tpu_torch.pipeline.generate import LTXPipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", checks.ATTN_CASES, ids=lambda c: c.name)
def test_flash_kernel_matches_plain(device, case):
    before = fa.flash_attention.launches
    checks.check_attention(case, device)
    assert fa.flash_attention.launches == before + 1


def test_flash_kernel_p_handoff(device):
    """The S accumulators of the first wgmma, rounded to bf16, as the
    register operand of the P V product, with no softmax between."""
    assert checks.check_pv_handoff(device)["tol_share"] <= 1.0


def test_flash_kernel_writes_in_q_layout_and_takes_many_heads(device):
    """A (B, H, T, D) view of a (B, T, H, D) buffer gives an output of the
    same layout (the DiT's transpose back is a view); batch * heads past
    65535 (one block a query tile per head) launches."""
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = (torch.randn(1, t, 4, 64, generator=gen, device=device).bfloat16()
               .transpose(1, 2) for t in (130, 70, 70))
    out = fa.flash_attention(q, k, v)
    assert out.stride() == q.stride()
    want = fa.flash_attention_reference(q, k, v)
    assert (out.float() - want.float()).abs().max() <= 2e-2
    q = torch.randn(70000, 1, 3, 16, generator=gen, device=device).bfloat16()
    out = fa.flash_attention(q, q, q)
    assert (out.float() - fa.flash_attention_reference(q, q, q).float()).abs().max() <= 2e-2


def test_flash_kernel_rejects_what_it_does_not_take(device):
    q = torch.randn(1, 2, 8, 32, device=device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(qb.transpose(2, 3), qb, qb)
    q48 = torch.randn(1, 2, 8, 48, device=device).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q48, q48, q48)
    # head dim 72 runs forward only
    q72 = torch.randn(1, 2, 8, 72, device=device).bfloat16()
    lse = torch.zeros(1, 2, 8, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_backward(q72, q72, q72, None, q72, lse, q72)


def test_tiny_generate_cuda_matches_cpu(device):
    res = checks.check_tiny_generate(device)
    assert res["spec"]["forwards"] < res["sequential"]["forwards"]


def test_siglip_head_dim_72_through_the_kernel(device):
    from ltx_tpu_torch.models.siglip import SigLIPConfig

    cfg = SigLIPConfig(hidden_size=144, image_size=56, num_layers=2, num_heads=2,
                       intermediate_size=64, text_hidden_size=48, mm_tokens_per_image=4)
    res = checks.check_siglip(*checks.siglip_inputs(cfg, device))
    assert res["launches"] == cfg.num_layers


@pytest.mark.parametrize("case", checks.BWD_CASES, ids=lambda c: c.name)
def test_flash_stats_and_backward_kernels_match_plain(device, case):
    before = (fa.flash_attention_stats.launches, fa.flash_attention.launches)
    checks.check_stats(case, device)
    assert (fa.flash_attention_stats.launches, fa.flash_attention.launches) == (
        before[0] + 1, before[1])
    res = checks.check_backward(case, device)
    assert (res["dq_launches"], res["dkv_launches"]) == (1, 1)


@pytest.mark.parametrize("name", checks.DETERMINISM_CASES)
def test_flash_backward_is_bitwise_deterministic(device, name):
    """No atomics: two runs of the dq and dkv kernels give equal dQ, dK and
    dV, bit for bit (check_backward also holds each gradient to its input's
    layout)."""
    case = next(c for c in checks.BWD_CASES if c.name == name)
    assert not any(checks.check_backward_deterministic(case, device).values())


def test_flash_backward_rejects_what_it_does_not_take(device):
    case = checks.BackwardCase("reject", 1, 2, 40, 40, 32)
    q, k, v, do, bias, o, lse = checks.backward_inputs(case, device)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_backward(q, k, v, bias, o, lse, do.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, k, v, None, do, lse[:, :, :8], lse, 0.1)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="dO's last dim"):
        fa.flash_attention_bwd_dkv(q, k, v, None, do.transpose(2, 3).contiguous()
                                   .transpose(2, 3), lse, delta, 0.1)


def test_tiny_lora_train_cuda_matches_cpu(device):
    checks.check_tiny_train(device)


def test_tiny_lora_train_f32_runs_on_the_card(device):
    """A float32 compute dtype on the card: the attention kernels get bf16
    casts (ops.attention), held to the bf16 run's tolerance against the
    CPU's float32 run."""
    res = checks.check_tiny_train(device, torch.float32)
    assert res["launches"]["flash_attention_stats"] > 0


@pytest.mark.parametrize("case", checks.INT4_CASES, ids=lambda c: c.name)
def test_int4_route_matches_plain(device, case):
    res = checks.check_int4(case, device)
    big = case.m >= qz.BIG_M_DEQUANT_THRESHOLD
    assert (res["int4_matmul_launches"], res["dequant_int4_launches"]) == (
        (0, 1) if big else (1, 0))


@pytest.mark.parametrize("case", checks.W8A8_CASES, ids=lambda c: c.name)
def test_w8a8_product_matches_the_cpu(device, case):
    assert not any(checks.check_w8a8(case, device).values())


def test_int8_product_pads_rows_and_refuses_unaligned_widths(device):
    """Fewer than the 17 rows cuBLASLt takes are padded (exact); K or N off
    a multiple of 8 raises."""
    gen = torch.Generator(device=device).manual_seed(3)
    x8 = torch.randint(-127, 128, (5, 64), generator=gen, device=device, dtype=torch.int8)
    w8 = qz.w8_layout(torch.randint(-127, 128, (64, 32), generator=gen, device=device,
                                    dtype=torch.int8))
    assert torch.equal(qz.int8_mm(x8, w8).cpu(), qz.int8_mm(x8.cpu(), w8.cpu()))
    with pytest.raises(ValueError, match="multiples of 8"):
        qz.int8_mm(x8[:, :60].contiguous(), w8[:60])


def test_dequant_kernel_is_exact(device):
    for shape in checks.DEQUANT_SHAPES:
        assert checks.check_dequant(device, shape)["mismatches"] == 0
    assert checks.check_dequant(device, (512, 264), group=32)["mismatches"] == 0


def test_quantize_on_the_card_matches_the_cpu(device):
    assert not any(checks.check_quantize_on_device(device).values())


def test_int4_kernels_reject_what_they_do_not_take(device):
    case = checks.Int4Case("reject", 64, 512, 256)
    x, qp = checks.int4_inputs(case, device)
    args = (qp["w_q4"], qp["scale"], qp["bias"])
    with pytest.raises(ValueError, match="bfloat16"):
        qz.int4_matmul(x.float(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        qz.int4_matmul(x.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="scale is"):
        qz.int4_matmul(x, qp["w_q4"], qp["scale"].bfloat16(), qp["bias"])
    with pytest.raises(ValueError, match="K % 256"):
        small = checks.int4_weights(128, 256, 64, device)
        qz.int4_matmul(x[:, :128].contiguous(), small["w_q4"], small["scale"], small["bias"])
    with pytest.raises(ValueError, match="do not match"):
        qz.dequant_int4(qp["w_q4"], qp["scale"][:3], qp["bias"][:3])


def test_bf16_linear_rounds_once(device):
    """F.linear in bf16 adds the bias in f32 before its one rounding (the
    reference's linear); a bf16 matmul then a bf16 add would round twice."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(512, 1024, generator=gen, device=device).bfloat16()
    w = (torch.randn(768, 1024, generator=gen, device=device) * 0.03).bfloat16()
    b = torch.randn(768, generator=gen, device=device).bfloat16()
    exact = (x.float() @ w.float().t() + b.float()).bfloat16()
    mismatch = (F.linear(x, w, b) != exact).float().mean().item()
    assert mismatch < 0.01, mismatch


def test_tiny_pipeline_cuda_matches_cpu(device):
    checks.check_tiny_pipeline(device)


@pytest.mark.parametrize("case", checks.RMS_CASES, ids=lambda c: c.name)
def test_rms_norm_kernel_matches_plain(device, case):
    res = checks.check_rms(case, device)
    assert res["tol_share"] <= 1.0


def test_rms_norm_dispatch_and_what_the_kernel_does_not_take(device):
    """By default a CUDA tensor on the 128 rule launches the kernel (3-D and
    non-contiguous inputs too, f32 as well as bf16); a last dim off the rule,
    float16, a call that autograd records and `forced_rms_chain()` take the
    plain chain, each counted in `rms_chain_on_cuda`; under no_grad a tensor
    that requires grad launches the kernel. The kernel's wrapper itself
    raises on what it does not take."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(4, 37, 512, generator=gen, device=device).bfloat16()
    w = torch.randn(256, generator=gen, device=device).bfloat16()
    strided = x[:, :, ::2]
    launches, chain = rk.rms_norm.launches, normalization.rms_chain_on_cuda
    assert normalization.rms_norm(x).shape == x.shape
    got = normalization.rms_norm(strided, w)
    normalization.rms_norm(x.float())
    assert rk.rms_norm.launches == launches + 3
    want = rk.rms_norm_reference(strided, w)
    assert (got.float() - want.float()).abs().max() <= checks.bf16_ulp(want).max()
    odd = torch.ones(3, 100, device=device)
    assert torch.equal(normalization.rms_norm(odd), rk.rms_norm_reference(odd))
    normalization.rms_norm(x.half())
    grad_x = x.float().requires_grad_(True)
    out = normalization.rms_norm(grad_x)
    assert out.requires_grad
    out.sum().backward()
    assert grad_x.grad is not None
    with normalization.forced_rms_chain():
        assert torch.equal(normalization.rms_norm(x), rk.rms_norm_reference(x))
    assert rk.rms_norm.launches == launches + 3
    assert normalization.rms_chain_on_cuda == chain + 4
    with torch.no_grad():
        normalization.rms_norm(grad_x)
    assert rk.rms_norm.launches == launches + 4
    with pytest.raises(RuntimeError, match="inference only"):
        rk.rms_norm(grad_x)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        rk.rms_norm(x.half())
    with pytest.raises(ValueError, match="multiple of 128"):
        rk.rms_norm(torch.ones(3, 100, device=device))
    assert rk.rms_norm(torch.empty(0, 128, device=device)).shape == (0, 128)


@pytest.mark.parametrize("name", checks.RMS_BITWISE_CASES)
def test_rms_norm_kernel_bitwise_run_to_run_and_row_independent(device, name):
    """Two runs equal, and each row alone or in another batch equal to its
    row of the whole batch, bit for bit."""
    case = next(c for c in checks.RMS_CASES if c.name == name)
    assert not any(checks.check_rms_bitwise(case, device).values())


@pytest.mark.parametrize("case", checks.ROPE_CASES, ids=lambda c: c.name)
def test_rope_tables_kernel_matches_plain(device, case):
    """The kernel's f32 tables within one f32 ulp of the plain float64 host
    build; the count of elements that are not bit for bit (expected 0)."""
    out = checks.check_rope_tables(case, device)
    print(f"rope_tables {case.name}: {out['differ']} of {out['elements']} elements differ, "
          f"up to {out['max_ulps']} ulps")
    assert out["max_ulps"] <= 1.0


def test_rope_tables_launch_once_a_table_of_a_denoise_loop(device):
    assert checks.rope_loop_launches(device) == {"video": 1, "av": 4}


def test_tiny_two_stage_cuda_matches_cpu(device):
    res = checks.check_tiny_two_stage(device)
    assert res["launches"]["rms_norm"] > 0
    # the chain only for the tiny connector's norms (64 wide), once a text pass
    tecfg = LTXPipeline.random_tiny(device="cpu").tecfg
    assert res["launches"]["rms_chain_on_cuda"] == tecfg.connector_layers * 4 + 1


def test_tiny_av_pipeline_cuda_matches_cpu(device):
    """The tiny joint-audio pipeline (CFG, then I2V re-noised) on the card
    against the CPU: frames and waveform, and the launches by head dim."""
    res = checks.check_tiny_av_pipeline(device)
    assert set(res) == {"t2v_cfg", "i2v"}


def test_tiny_av_qlora_train_cuda_matches_cpu(device):
    """The tiny AV QLoRA step on the card (B2, B3a, B3b at head dim 64, B4
    and B5 on the int4 dual DiT) against the CPU: one loss and its LoRA
    gradients, then the steps, with the launches av_train_step_launches
    derives; the base bit for bit."""
    res = checks.check_tiny_av_train(device)
    assert res["launches"]["int4_matmul"] > 0 and res["launches"]["dequant_int4"] > 0


def test_tiny_long_video_cuda_matches_cpu(device):
    """Video-to-video, extension, keyframes, an anchored two-prompt chain
    and the audio chain, keyframes and extension, each within the tiny
    tolerances of the CPU, with the launches their DiT calls and text
    passes imply."""
    res = checks.check_tiny_long_video(device)
    assert len(res) == 7 and all(r["launches"]["flash_attention"] > 0 for r in res.values())


def test_tiny_surfaces_cuda(device):
    """SeededPipeline on the card twice at one seed, a job served over HTTP
    and a DenoiseCheckpoint resume, each bit for bit the direct call
    (checks.check_tiny_surfaces; the MP4 writer chip_smoke.py picks for
    this machine: its .npy stand-in where no encoder is installed)."""
    import chip_smoke

    res = checks.check_tiny_surfaces(device, chip_smoke.mp4_writer())
    assert res["resumed_steps"] == 3 and res["resumed_launches"]["flash_attention"] > 0


def test_mlx_dequant_on_the_card_is_bit_for_bit(device):
    """keymaps' MLX 4-bit dequantization run on the card equals numpy's
    (checks.mlx_dequant_bits), bit for bit."""
    from ltx_tpu_torch.weights import keymaps

    gen = torch.Generator().manual_seed(3)
    packed = torch.randint(-2**31, 2**31, (256, 512 // 8), generator=gen,
                           dtype=torch.int32).view(torch.uint32)
    scales = (torch.rand(256, 512 // 64, generator=gen) * 0.01).to(torch.bfloat16)
    biases = (-7.5 * scales.float()).to(torch.bfloat16)
    tensors = {"w.weight": packed, "w.scales": scales, "w.biases": biases}
    got = keymaps._maybe_dequant_mlx_4bit(tensors, "w", device=device)
    assert got.device.type == "cuda"
    assert checks.check_mlx_dequant(packed, scales, biases,
                                    got.to(torch.bfloat16))["differing"] == 0


def test_lora_fusion_on_the_card_matches_the_cpu(device):
    """A rank-64 LoRA over every block linear of the tiny bf16 DiT, fused on
    the card and on the CPU (checks.check_fused_leaves), and the fused DiT
    on the card against the adapter as a side path (LORA_SIDE_PATH_TOL)."""
    from ltx_tpu_torch.config import TransformerConfig
    from ltx_tpu_torch.lora.fuse import LoRALayer, fuse_lora
    from ltx_tpu_torch.models.common import init_random_
    from ltx_tpu_torch.models.dit import LTXTransformer

    cfg = TransformerConfig().tiny()
    gen = torch.Generator().manual_seed(4)
    model = init_random_(LTXTransformer(cfg, device="cpu", dtype=torch.bfloat16), gen)
    layers, paths = [], set()
    for i in range(cfg.num_layers):
        for name in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out", "attn2.to_q",
                     "attn2.to_k", "attn2.to_v", "attn2.to_out", "ff.project_in",
                     "ff.project_out"):
            d_out, d_in = model.blocks[i].get_submodule(name).weight.shape
            key = name.replace("ff.project_in", "ff.project_in.proj")
            layers.append(LoRALayer(f"transformer_blocks.{i}.{key}",
                                    torch.randn(64, d_in, generator=gen) * d_in**-0.5,
                                    torch.randn(d_out, 64, generator=gen) * 0.0125, 64.0))
            paths.add(f"blocks.{i}.{name}")
    card = fuse_lora(model, layers, 0.8, device=device)
    cpu = fuse_lora(model, layers, 0.8, device="cpu")
    assert checks.check_fused_leaves(card, cpu, layers, 0.8, paths)["share"] <= 1.0
    res = checks.lora_side_path_check(model, layers, 0.8, tokens=(2, 4, 4), text_tokens=16,
                                      device=device)
    assert res["finite"] and res["rel_err"] <= checks.LORA_SIDE_PATH_TOL


@pytest.mark.parametrize("case", checks.RING_CASES[:2], ids=lambda c: c.name)
def test_ring_of_one_rank_within_its_bounds(device, case):
    """Ring attention on a one-rank mesh (one ring step: B2, then the B3
    pair at the merged lse) within the ring bounds, beside B1 and the B3
    pair on the whole sequence within theirs (checks' derivation); the two
    ranks' rings at every RING_CASES shape run in chip_smoke's phase 7."""
    from ltx_tpu_torch.parallel import runtime

    res = checks.check_ring(case, runtime.make_mesh(1, 1), device, judge=True)
    assert max(res["shares"].values()) <= 1.0
    assert res["per_ring_step"] == {"flash_attention_stats": 1.0,
                                    "flash_attention_bwd_dq": 1.0,
                                    "flash_attention_bwd_dkv": 1.0}


def test_tp_world_of_one_is_the_plain_step(device):
    """A tiny DiT sharded over a (1, 1) mesh: the step's velocity bit for bit
    the unsharded one's, no collective run."""
    assert checks.check_tp_world_one(device)["bitwise"]
