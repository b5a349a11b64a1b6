"""Model and generation configuration.

Port of the parts of ltx_tpu/core/config.py that the generation paths
read, field for field and with the same defaults (tests/test_torch_static.py
holds them against the reference's classes): the model variants
(`LTXModel`), the DiT's `TransformerConfig`, the audio VAE's and the
vocoder's configs (ltx_tpu/models/audio_vae.py), the pixel/latent scale
factors, `GenerationConfig`, `QuantizationConfig` and
the memory knobs the port honours.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class LTXModel(str, enum.Enum):
    """LTX-2 model variants: the same DiT, distilled or not."""

    DEV = "dev"
    DISTILLED = "distilled"

    @property
    def is_distilled(self) -> bool:
        return self is LTXModel.DISTILLED

    @property
    def default_steps(self) -> int:
        return 8 if self.is_distilled else 40

    @property
    def default_guidance(self) -> float:
        return 1.0 if self.is_distilled else 4.0

    @property
    def unified_weights_filename(self) -> str:
        return f"ltx-2-19b-{self.value}.safetensors"


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
    # audio stream of the dual audio-video transformer
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

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_num_heads * self.audio_head_dim

    @property
    def audio_cross_attention_dim(self) -> int:
        return self.audio_inner_dim

    def tiny(self) -> "TransformerConfig":
        """A CPU-test-sized config with the same structure."""
        return dataclasses.replace(
            self, num_layers=2, num_heads=4, head_dim=32, in_channels=16,
            out_channels=16, cross_attention_dim=128, caption_channels=48,
            audio_num_heads=4, audio_head_dim=16, audio_in_channels=16,
            audio_out_channels=16)


@dataclasses.dataclass(frozen=True)
class AudioVAEConfig:
    """The audio VAE decoder: latent (B, 8, T, 16) -> stereo mel (B, 2,
    4T - 3, 64)."""

    latent_channels: int = 8
    output_channels: int = 2
    base_channels: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2  # decoder levels use num_res_blocks + 1
    mel_bins: int = 64
    mel_latent_bins: int = 16  # latent width; packed dim = 8 * this = 128
    latent_downsample: int = 4

    def tiny(self) -> "AudioVAEConfig":
        return dataclasses.replace(self, base_channels=16, num_res_blocks=0,
                                   mel_bins=8, mel_latent_bins=2)


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """The HiFi-GAN vocoder: stereo mel -> 24 kHz stereo waveform."""

    in_channels: int = 128
    hidden_channels: int = 1024
    out_channels: int = 2
    upsample_factors: Tuple[int, ...] = (6, 5, 2, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 15, 8, 4, 4)
    resnet_kernels: Tuple[int, ...] = (3, 7, 11)
    resnet_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_slope: float = 0.1
    sample_rate: int = 24000

    def tiny(self) -> "VocoderConfig":
        return dataclasses.replace(
            self, in_channels=16, hidden_channels=32, upsample_factors=(2, 2),
            upsample_kernels=(4, 4), resnet_kernels=(3,), resnet_dilations=((1, 3),))


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
    two-stage, with CFG, STG, guidance rescale and extrapolation, and
    prompt enhancement (`enhance_prompt`, `enhancement_spec_k`)."""

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
        """The reference's checks, with its typed errors and messages (all
        ValueErrors: InvalidConfigurationError and its subclasses)."""
        from ltx_tpu_torch.errors import (
            InvalidConfigurationError,
            InvalidDimensionsError,
            InvalidFrameCountError,
        )

        if self.width % 32 != 0 or self.height % 32 != 0:
            raise InvalidDimensionsError(self.width, self.height)
        if (self.num_frames - 1) % 8 != 0:
            raise InvalidFrameCountError(self.num_frames)
        bounds = (("Width", self.width, 64, 2048), ("Height", self.height, 64, 2048),
                  ("num_frames", self.num_frames, 9, 257),
                  ("num_steps", self.num_steps, 1, 100),
                  ("cfg_scale", self.cfg_scale, 1.0, 20.0))
        for name, value, lo, hi in bounds:
            if not lo <= value <= hi:
                raise InvalidConfigurationError(f"{name} must be in [{lo}, {hi}], got {value}")
        if self.two_stage and (self.width % 64 or self.height % 64):
            raise InvalidConfigurationError(
                "Two-stage requires width and height divisible by 64. "
                f"Got {self.width}x{self.height}")


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Quantization of the transformer: "bf16" (none), weight-only "qint8"
    and "int4" (group-wise), and "w8a8" (int8 weights per output channel,
    int8 activations per row; `bits` 8, the group size unused)."""

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
    # f32's bytes, at most 1/255 off) or "yuv420" (4:2:0 planes, half of
    # uint8's bytes: the encoder's own chroma subsample)
    decode_transfer: str = "uint8"
    offload_text_encoder: bool = True  # drop Gemma weights after encoding
    # keep components on the host and place each on the device only for its
    # phase, releasing it afterwards
    phase_staging: bool = False

    @classmethod
    def preset(cls, name: str) -> "MemoryConfig":
        """The reference's tiers over the knobs the port has (its
        `remat_blocks` has no counterpart here): "disabled" keeps
        everything, "light" drops the text encoder after encoding,
        "moderate" adds phase staging and decode tiles of 8 latent frames,
        "aggressive" tiles of 6."""
        presets = {
            "disabled": cls(vae_tile_size=0, offload_text_encoder=False),
            "light": cls(vae_tile_size=0, offload_text_encoder=True),
            "moderate": cls(vae_tile_size=8, vae_tile_overlap=1, offload_text_encoder=True,
                            phase_staging=True),
            "aggressive": cls(vae_tile_size=6, vae_tile_overlap=1, offload_text_encoder=True,
                              phase_staging=True),
        }
        if name not in presets:
            raise ValueError(f"unknown memory preset: {name} (choose from {sorted(presets)})")
        return presets[name]
