"""Model and generation configuration.

Port of the parts of ltx_tpu/core/config.py that the generation paths
read, field for field and with the same defaults (tests/test_torch_static.py
holds them against the reference's classes): the DiT's `TransformerConfig`,
the pixel/latent scale factors, `GenerationConfig`, `QuantizationConfig` and
the memory knobs the port honours.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """DiT architecture constants, the same for dev and distilled."""

    num_layers: int = 48
    num_heads: int = 32
    head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    cross_attention_dim: int = 4096
    caption_channels: int = 3840
    rope_theta: float = 10000.0
    max_pos: Tuple[int, ...] = (20, 2048, 2048)
    timestep_scale_multiplier: float = 1000.0
    norm_eps: float = 1e-6
    ffn_mult: int = 4
    # audio stream of the dual AV transformer (not ported yet)
    audio_num_heads: int = 32
    audio_head_dim: int = 64
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_max_pos: Tuple[int, ...] = (20,)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return self.inner_dim * self.ffn_mult

    def tiny(self) -> "TransformerConfig":
        """A CPU-test-sized config with the same structure."""
        return dataclasses.replace(
            self, num_layers=2, num_heads=4, head_dim=32, in_channels=16,
            out_channels=16, cross_attention_dim=128, caption_channels=48,
            audio_num_heads=4, audio_head_dim=16, audio_in_channels=16,
            audio_out_channels=16)


# The reference's default negative prompt, verbatim: checkpoint-defined
# behavioural data, not code.
DEFAULT_NEGATIVE_PROMPT = (
    "blurry, out of focus, overexposed, underexposed, low contrast, washed "
    "out colors, excessive noise, grainy texture, poor lighting, flickering, "
    "motion blur, distorted proportions, unnatural skin tones, deformed "
    "facial features, asymmetrical face, missing facial features, extra "
    "limbs, disfigured hands, wrong hand count, artifacts around text, "
    "inconsistent perspective, camera shake, incorrect depth of field, "
    "background too sharp, background clutter, distracting reflections, "
    "harsh shadows, inconsistent lighting direction, color banding, "
    "cartoonish rendering, 3D CGI look, unrealistic materials, uncanny "
    "valley effect, incorrect ethnicity, wrong gender, exaggerated "
    "expressions, wrong gaze direction, mismatched lip sync, silent or "
    "muted audio, distorted voice, robotic voice, echo, background noise, "
    "off-sync audio, incorrect dialogue, added dialogue, repetitive speech, "
    "jittery movement, awkward pauses, incorrect timing, unnatural "
    "transitions, inconsistent framing, tilted camera, flat lighting, "
    "inconsistent tone, cinematic oversaturation, stylized filters, or AI "
    "artifacts."
)

# pixel <-> latent scale factors
TEMPORAL_SCALE = 8
SPATIAL_SCALE = 32
LATENT_CHANNELS = 128


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """All generation knobs. The port runs T2V and I2V, single- and
    two-stage, with CFG, STG, guidance rescale and extrapolation;
    `enhance_prompt` raises NotImplementedError (ROADMAP A13)."""

    width: int = 704
    height: int = 480
    num_frames: int = 121
    num_steps: int = 8
    cfg_scale: float = 1.0
    seed: Optional[int] = None
    negative_prompt: Optional[str] = None
    guidance_rescale: float = 0.0
    cross_attention_scale: float = 1.0
    ge_gamma: float = 0.0
    stg_scale: float = 0.0
    stg_blocks: Tuple[int, ...] = (29,)
    two_stage: bool = False
    enhance_prompt: bool = False
    enhancement_spec_k: int = 8
    image_path: Optional[str] = None
    image_cond_noise_scale: float = 0.0
    fps: float = 24.0
    # custom sigma table; None = the model's schedule
    sigmas_override: Optional[Tuple[float, ...]] = None

    def validate(self) -> None:
        """The reference's checks; raises ValueError, as its error classes are."""
        if self.width % 32 != 0 or self.height % 32 != 0:
            raise ValueError(f"Width and height must be divisible by 32, got "
                             f"{self.width}x{self.height}")
        if (self.num_frames - 1) % 8 != 0:
            raise ValueError(f"num_frames must be 8n+1, got {self.num_frames}")
        bounds = (("width", 64, 2048), ("height", 64, 2048),
                  ("num_frames", 9, 257), ("num_steps", 1, 100),
                  ("cfg_scale", 1.0, 20.0))
        for name, lo, hi in bounds:
            if not lo <= getattr(self, name) <= hi:
                raise ValueError(f"{name} must be in [{lo}, {hi}], "
                                 f"got {getattr(self, name)}")
        if self.two_stage and (self.width % 64 or self.height % 64):
            raise ValueError("Two-stage requires width and height divisible by "
                             f"64. Got {self.width}x{self.height}")


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Weight-only quantization of the transformer. The port runs "bf16",
    "qint8" and "int4"; "w8a8" (int8 activations too) is not ported yet."""

    mode: str = "bf16"  # "bf16" | "qint8" | "int4" | "w8a8"
    group_size: int = 64

    @property
    def bits(self) -> Optional[int]:
        return {"bf16": None, "qint8": 8, "int4": 4, "w8a8": 8}[self.mode]


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """The reference's memory knobs that the port honours, same defaults."""

    vae_tile_size: int = 0  # latent frames per decode tile; 0 = no tiling
    vae_tile_overlap: int = 1  # latent-frame overlap between tiles
    # what a tiled decode copies to the host: "uint8" (RGB, a quarter of
    # f32's bytes, at most 1/255 off); "yuv420" is not ported (ROADMAP A4b)
    decode_transfer: str = "uint8"
    offload_text_encoder: bool = True  # drop Gemma weights after encoding
    # keep components on the host and place each on the device only for its
    # phase, releasing it afterwards
    phase_staging: bool = False
