"""Text-to-video generation: prompt -> frames.

Port of ltx_tpu/pipeline/generate.py::LTXPipeline for the single-stage T2V
path: tokenize -> Gemma-3 -> feature extractor and connector -> the DiT
denoise loop -> VAE decode. With `memory.phase_staging` every component
lives on the host between phases and comes to the device only for its own
phase, as the reference stages them; otherwise all sit on the device, and
`memory.offload_text_encoder` drops Gemma and the connector after encoding.

Random draws are explicit: `generate_video` takes the initial latent noise
(and, for decoders with timestep conditioning, the decode noise) as tensors.
Prompt enhancement, I2V, two-stage, guidance rows and tiled decoding are not
ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ltx_tpu_torch.config import (
    GenerationConfig,
    MemoryConfig,
    QuantizationConfig,
    TransformerConfig,
)
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from ltx_tpu_torch.models.vae import VAEConfig, VideoDecoder, decode_video
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape
from ltx_tpu_torch.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    make_denoise_step,
    run_denoise_loop,
)


class ModelNotLoadedError(RuntimeError):
    """A component the phase needs was never loaded, or was offloaded."""

    def __init__(self, component: str):
        super().__init__(f"Model component not loaded: {component}")
        self.component = component


@dataclasses.dataclass
class GenerationTimings:
    """Seconds per phase, each ended by a device synchronise. `staging` is
    the time spent moving components to the device, outside the phases."""

    staging: float = 0.0
    gemma: float = 0.0
    connector: float = 0.0
    denoise_steps: list = dataclasses.field(default_factory=list)
    vae_decode: float = 0.0
    total: float = 0.0


@dataclasses.dataclass
class VideoGenerationResult:
    frames: np.ndarray  # (F, H, W, 3) float32 in [0, 1]
    timings: GenerationTimings


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tiny_configs():
    """The reference's LTXPipeline.random_tiny configs, field for field."""
    tcfg = TransformerConfig().tiny()
    vcfg = dataclasses.replace(VAEConfig().tiny(), latent_channels=tcfg.in_channels)
    gcfg = Gemma3Config().tiny()
    tecfg = dataclasses.replace(
        TextEncoderConfig().tiny(), hidden_dim=gcfg.hidden_size,
        num_gemma_layers=gcfg.hidden_layers + 1, connector_heads=4,
        connector_head_dim=gcfg.hidden_size // 4)
    tcfg = dataclasses.replace(tcfg, caption_channels=tecfg.inner_dim)
    return tcfg, vcfg, gcfg, tecfg


class LTXPipeline:
    """Holds the four modules and their configs; drives the phases."""

    def __init__(self, transformer: LTXTransformer, vae_decoder: VideoDecoder,
                 gemma: Optional[Gemma3Model] = None,
                 text_encoder: Optional[TextEncoder] = None, tokenizer=None,
                 memory: MemoryConfig = MemoryConfig(), is_distilled: bool = True,
                 device=None):
        self.transformer = transformer
        self.vae_decoder = vae_decoder
        self.gemma = gemma
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.memory = memory
        self.is_distilled = is_distilled
        self.device = torch.device(device if device is not None
                                   else transformer.proj_out.weight.device)
        self.tcfg = transformer.cfg
        self.vcfg = vae_decoder.cfg
        self.gcfg = gemma.cfg if gemma is not None else None
        self.tecfg = text_encoder.cfg if text_encoder is not None else None
        self._host_store = {}  # name -> host tensors of a staged component

    @classmethod
    def random(cls, tcfg: TransformerConfig, vcfg: VAEConfig, gcfg: Gemma3Config,
               tecfg: TextEncoderConfig, device, seed: int = 0,
               dtype=torch.bfloat16, vae_dtype=torch.bfloat16,
               memory: MemoryConfig = MemoryConfig(),
               quantization: QuantizationConfig = QuantizationConfig()):
        """Random weights at the given configs, drawn on `device` from one
        seeded torch.Generator per component with the reference's init
        scales. With `quantization.mode` "int4" or "qint8" the DiT's block
        linears are then quantized there, layer by layer; Gemma, the
        connector and the VAE stay unquantized. With phase staging each
        component then moves to the host."""
        device = torch.device(device)

        def build(i, make):
            gen = torch.Generator(device=device).manual_seed(seed * 16 + i)
            module = init_random_(make(), gen)
            if i == 0 and quantization.bits is not None:
                quantize_transformer(module, quantization.bits, quantization.group_size,
                                     w8a8=quantization.mode == "w8a8")
            return module.to("cpu") if memory.phase_staging else module

        return cls(
            transformer=build(0, lambda: LTXTransformer(tcfg, device, dtype)),
            vae_decoder=build(1, lambda: VideoDecoder(vcfg, device, vae_dtype)),
            gemma=build(2, lambda: Gemma3Model(gcfg, device, dtype)),
            text_encoder=build(3, lambda: TextEncoder(tecfg, device, dtype)),
            memory=memory, device=device)

    @classmethod
    def random_full(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(phase_staging=True),
                    quantization: QuantizationConfig = QuantizationConfig()):
        """Full widths and depths: Gemma-3-12B, the 30x128 connector, the
        48-block DiT (bf16, or quantized per `quantization`), the
        1024-channel VAE decoder; bf16 otherwise."""
        return cls.random(TransformerConfig(), VAEConfig(), Gemma3Config(),
                          TextEncoderConfig(), device, seed=seed, memory=memory,
                          quantization=quantization)

    @classmethod
    def random_tiny(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(),
                    quantization: QuantizationConfig = QuantizationConfig()):
        """The reference's tiny test configs; f32 VAE like its tiny pipeline.
        Torch draws differ from jax.random's: parity tests convert the
        reference's parameters instead (convert.py)."""
        return cls.random(*tiny_configs(), device, seed=seed,
                          vae_dtype=torch.float32, memory=memory,
                          quantization=quantization)

    # ------------------------------------------------------------------
    # Phase staging
    # ------------------------------------------------------------------

    def _on_device(self, name: str, timings: GenerationTimings):
        """Place a component on the device for its phase. With phase staging
        its host tensors are kept, so that `_release` frees the device copy
        without copying anything back."""
        module = getattr(self, name)
        if module is None:
            raise ModelNotLoadedError(name)
        t0 = time.perf_counter()
        if self.memory.phase_staging and name not in self._host_store:
            self._host_store[name] = {n: p.data for n, p in module.named_parameters()}
        module.to(self.device)
        _sync(self.device)
        timings.staging += time.perf_counter() - t0
        return module

    def _release(self, name: str) -> None:
        """After its phase, point a staged component back at its host
        tensors and free the device memory (phase_staging only)."""
        host = self._host_store.pop(name, None)
        if host is None:
            return
        for n, p in getattr(self, name).named_parameters():
            p.data = host[n]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Text encoding
    # ------------------------------------------------------------------

    def tokenize(self, prompt: str):
        """Left-pad to max_length with pad id 0; an over-long prompt keeps its
        LAST max_length tokens. Without a tokenizer, bytes are the tokens."""
        max_len = self.tecfg.max_length
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(prompt).ids
        else:
            ids = [(b % (self.gcfg.vocab_size - 2)) + 2 for b in prompt.encode()]
        ids = ids[-max_len:]
        pad = max_len - len(ids)
        input_ids = np.zeros((1, max_len), np.int32)
        mask = np.zeros((1, max_len), np.int32)
        input_ids[0, pad:] = ids
        mask[0, pad:] = 1
        return (torch.from_numpy(input_ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def encode_prompt(self, prompt: str, timings: Optional[GenerationTimings] = None):
        """prompt -> {"video": (1, S, D), "mask": (1, S)}: the Gemma tower,
        then the connector, each staged on the device for its own phase."""
        timings = timings if timings is not None else GenerationTimings()
        ids, mask = self.tokenize(prompt)
        gemma = self._on_device("gemma", timings)
        t0 = time.perf_counter()
        hidden = gemma.forward_hidden_states(ids, mask)
        _sync(self.device)
        timings.gemma = time.perf_counter() - t0
        self._release("gemma")
        text_encoder = self._on_device("text_encoder", timings)
        t0 = time.perf_counter()
        out = text_encoder.encode_from_hidden_states(hidden, mask)
        del hidden
        _sync(self.device)
        timings.connector = time.perf_counter() - t0
        self._release("text_encoder")
        return out

    def offload_text_encoder(self) -> None:
        """Drop Gemma and the connector (staging keeps the host copies)."""
        if not self.memory.phase_staging:
            self.gemma = None
            self.text_encoder = None

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def _sigmas(self, config: GenerationConfig, shape: VideoLatentShape) -> np.ndarray:
        if config.sigmas_override is not None:
            s = np.asarray(config.sigmas_override, np.float32)
            if s[-1] != 0.0:
                s = np.concatenate([s, [0.0]]).astype(np.float32)
            return s
        return schedule.get_sigmas(config.num_steps, distilled=self.is_distilled,
                                   token_count=shape.token_count)

    def _decode_frames(self, latent, decode_noise, timings: GenerationTimings):
        """VAE decode in the decoder's own dtype -> host (F, H, W, 3) f32."""
        decoder = self._on_device("vae_decoder", timings)
        t0 = time.perf_counter()
        latent = latent.to(decoder.dtype)
        ts = 0.05 if self.vcfg.timestep_conditioning else None
        noise = None
        if ts is not None and decode_noise is not None:
            noise = decode_noise.to(self.device, decoder.dtype)
        frames = decode_video(decoder, latent, timestep=ts, noise=noise)
        frames = frames.float().cpu().numpy()
        timings.vae_decode = time.perf_counter() - t0
        self._release("vae_decoder")
        return frames

    @staticmethod
    def _check_ported(config: GenerationConfig) -> None:
        unported = {"enhance_prompt": config.enhance_prompt,
                    "two_stage": config.two_stage,
                    "image_path (I2V)": config.image_path is not None}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported yet")

    @torch.inference_mode()
    def generate_video(self, prompt: str, config: GenerationConfig,
                       initial_noise, decode_noise=None) -> VideoGenerationResult:
        """Single-stage T2V. initial_noise: (1, C, F', H', W') float32
        standard normal (see ops.latents.generate_noise); decode_noise: the
        latent's shape, used only by decoders with timestep conditioning.
        Returns frames (F, H, W, 3) in [0, 1] on the host."""
        config.validate()
        self._check_ported(config)
        if self.memory.vae_tile_size > 0:
            raise NotImplementedError("tiled VAE decoding is not ported yet")
        guidance = GuidanceSpec.from_config(config)
        guidance.check_ported()
        total_start = time.perf_counter()
        timings = GenerationTimings()

        pos = self.encode_prompt(prompt, timings)
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        context, bias = build_guidance_context(guidance, pos["video"], pos["mask"])

        shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                             config.width,
                                             channels=self.tcfg.in_channels)
        if tuple(initial_noise.shape) != shape.shape:
            raise ValueError(f"initial_noise {tuple(initial_noise.shape)} != {shape.shape}")
        sigmas = self._sigmas(config, shape)
        latent = initial_noise.to(self.device, torch.float32) * float(sigmas[0])

        step_fn = make_denoise_step(self._on_device("transformer", timings), guidance,
                                    shape, context, bias, fps=config.fps)

        def on_step(i, n, sigma):
            now = time.perf_counter()
            timings.denoise_steps.append(now - on_step.t0)
            on_step.t0 = now

        on_step.t0 = time.perf_counter()
        latent = run_denoise_loop(step_fn, latent, sigmas, on_step=on_step)
        del step_fn
        self._release("transformer")

        frames = self._decode_frames(latent, decode_noise, timings)
        frames = frames[: config.num_frames]
        timings.total = time.perf_counter() - total_start
        return VideoGenerationResult(frames=frames, timings=timings)
