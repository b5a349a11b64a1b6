"""Generation: prompt (and an optional conditioning image) -> frames.

Port of ltx_tpu/pipeline/generate.py::LTXPipeline for text-to-video and
image-to-video, single-stage (`generate_video`), batched over prompts
(`generate_videos`) and two-stage (`generate_video_two_stage`: a guided
half-resolution denoise, a 2x latent upscale with AdaIN, a 3-step refine),
with `encode_prompt(s)` and `encode_image`. Phases: tokenize -> Gemma-3 ->
feature extractor and connector -> [VAE encoder] -> the DiT denoise loop
[-> upscaler -> the DiT again] -> VAE decode, tiled in time when
`memory.vae_tile_size` says so. With `memory.phase_staging` every component
lives on the host between phases and comes to the device only for its own
phase, as the reference stages them; otherwise all sit on the device, and
`memory.offload_text_encoder` drops Gemma and the connector after encoding.

Random draws are explicit tensors: the initial latent noise of each stage,
one re-noise draw per denoise step for conditioned frames (when
`image_cond_noise_scale` > 0) and, for decoders with timestep conditioning,
one decode-noise tensor per decode tile. The reference derives them from
`config.seed`; a torch generator cannot give jax.random's numbers.

The reference's warm-compile machinery (`_WarmCompiles`, `_warm_*`) overlaps
XLA compiles with earlier phases; eager PyTorch compiles nothing, so it has
no counterpart here. Prompt enhancement raises NotImplementedError (ROADMAP
A13); the extension, keyframe, video-to-video, chain and audio entry points
are ROADMAP A14 and A15.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ltx_tpu_torch.config import (
    DEFAULT_NEGATIVE_PROMPT,
    GenerationConfig,
    MemoryConfig,
    QuantizationConfig,
    TransformerConfig,
)
from ltx_tpu_torch.models.common import init_random_
from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
from ltx_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model
from ltx_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from ltx_tpu_torch.models.upscaler import LatentUpscaler, UpscalerConfig, upsample_latents
from ltx_tpu_torch.models.vae import (
    VAEConfig,
    VideoDecoder,
    VideoEncoder,
    decode_video,
    tile_latent_frames,
)
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape, adain_filter_latent
from ltx_tpu_torch.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    build_guidance_context_batched,
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
    image_encode: float = 0.0
    denoise_steps: list = dataclasses.field(default_factory=list)  # every stage's
    upscale: float = 0.0
    vae_decode: float = 0.0
    total: float = 0.0


@dataclasses.dataclass
class VideoGenerationResult:
    frames: np.ndarray  # (F, H, W, 3) float32 in [0, 1]
    timings: GenerationTimings
    seed: int = 0  # config.seed (the draws themselves are arguments)


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


def tiny_upscaler_config(tcfg: TransformerConfig) -> UpscalerConfig:
    """The reference's random_tiny upscaler config."""
    return dataclasses.replace(UpscalerConfig().tiny(), in_channels=tcfg.in_channels)


class LTXPipeline:
    """Holds the modules and their configs; drives the phases."""

    def __init__(self, transformer: LTXTransformer, vae_decoder: VideoDecoder,
                 gemma: Optional[Gemma3Model] = None,
                 text_encoder: Optional[TextEncoder] = None, tokenizer=None,
                 memory: MemoryConfig = MemoryConfig(), is_distilled: bool = True,
                 device=None, vae_encoder: Optional[VideoEncoder] = None,
                 upscaler: Optional[LatentUpscaler] = None):
        self.transformer = transformer
        self.vae_decoder = vae_decoder
        self.gemma = gemma
        self.text_encoder = text_encoder
        self.vae_encoder = vae_encoder
        self.upscaler = upscaler
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
               quantization: QuantizationConfig = QuantizationConfig(),
               ucfg: Optional[UpscalerConfig] = None):
        """Random weights at the given configs, drawn on `device` from one
        seeded torch.Generator per component with the reference's init
        scales. With `quantization.mode` "int4" or "qint8" the DiT's block
        linears are then quantized there, layer by layer; Gemma, the
        connector, the VAE and the upscaler stay unquantized. The VAE
        encoder takes the decoder's dtype, the upscaler (built when `ucfg`
        is given) float32. With phase staging each component then moves to
        the host."""
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
            vae_encoder=build(4, lambda: VideoEncoder(vcfg, device, vae_dtype)),
            upscaler=None if ucfg is None else build(
                5, lambda: LatentUpscaler(ucfg, device, torch.float32)),
            memory=memory, device=device)

    @classmethod
    def random_full(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(phase_staging=True),
                    quantization: QuantizationConfig = QuantizationConfig()):
        """Full widths and depths: Gemma-3-12B, the 30x128 connector, the
        48-block DiT (bf16, or quantized per `quantization`), the
        1024-channel VAE decoder and the 128..2048-channel encoder; bf16
        otherwise, and the 1024-channel latent upscaler in float32."""
        return cls.random(TransformerConfig(), VAEConfig(), Gemma3Config(),
                          TextEncoderConfig(), device, seed=seed, memory=memory,
                          quantization=quantization, ucfg=UpscalerConfig())

    @classmethod
    def random_tiny(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(),
                    quantization: QuantizationConfig = QuantizationConfig()):
        """The reference's tiny test configs; f32 VAE like its tiny pipeline.
        Torch draws differ from jax.random's: parity tests convert the
        reference's parameters instead (convert.py)."""
        cfgs = tiny_configs()
        return cls.random(*cfgs, device, seed=seed,
                          vae_dtype=torch.float32, memory=memory,
                          quantization=quantization,
                          ucfg=tiny_upscaler_config(cfgs[0]))

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
        return self.encode_prompts([prompt], timings=timings)[0]

    @torch.inference_mode()
    def encode_prompts(self, prompts, batch: Optional[int] = None,
                       stage: Optional[bool] = None,
                       timings: Optional[GenerationTimings] = None) -> list:
        """Encode many prompts with Gemma and the connector each placed on
        the device once. Chunks of `batch` prompts (default 4) go through the
        tower together; a tail chunk is padded by repeating its last row and
        the padded rows are dropped. stage=None follows memory.phase_staging:
        when staged, each chunk's hidden states wait on the host while the
        tower leaves and the connector arrives, so the two never share the
        device. Returns one {"video": (1, S, D), "mask": (1, S)} per prompt,
        on the pipeline's device."""
        timings = timings if timings is not None else GenerationTimings()
        prompts = list(prompts)
        if not prompts:
            return []
        if self.gemma is None:
            raise ModelNotLoadedError("gemma")
        if stage is None:
            stage = self.memory.phase_staging
        batch = max(1, int(batch if batch is not None else 4))
        rows = [self.tokenize(p) for p in prompts]
        chunks = []  # (ids (B, S), mask (B, S), rows that are real)
        for s in range(0, len(rows), batch):
            ids = [r[0] for r in rows[s:s + batch]]
            msk = [r[1] for r in rows[s:s + batch]]
            n = len(ids)
            if n < batch and len(rows) > batch:
                ids += [ids[-1]] * (batch - n)
                msk += [msk[-1]] * (batch - n)
            chunks.append((torch.cat(ids), torch.cat(msk), n))

        gemma = self._on_device("gemma", timings)
        t0 = time.perf_counter()
        hidden = []
        for ids, msk, _ in chunks:
            h = gemma.forward_hidden_states(ids, msk)
            hidden.append(h.cpu() if stage and len(chunks) > 1 else h)
        _sync(self.device)
        timings.gemma += time.perf_counter() - t0
        self._release("gemma")

        text_encoder = self._on_device("text_encoder", timings)
        t0 = time.perf_counter()
        results = []
        for ci, (_, msk, n) in enumerate(chunks):
            out = text_encoder.encode_from_hidden_states(hidden[ci].to(self.device), msk)
            hidden[ci] = None
            for r in range(n):
                results.append({"video": out["video"][r:r + 1], "mask": out["mask"][r:r + 1]})
        _sync(self.device)
        timings.connector += time.perf_counter() - t0
        self._release("text_encoder")
        return results

    def offload_text_encoder(self) -> None:
        """Drop Gemma and the connector (staging keeps the host copies)."""
        if not self.memory.phase_staging:
            self.gemma = None
            self.text_encoder = None

    def _encode_text(self, prompts, config: GenerationConfig, guidance: GuidanceSpec,
                     timings: GenerationTimings):
        """The positives and, under CFG, the negative prompt after them, in
        one pass. Returns (positive rows, the negative row or None)."""
        to_encode = list(prompts)
        if guidance.use_cfg:
            to_encode.append(config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        rows = self.encode_prompts(to_encode, timings=timings)
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        return rows[:len(prompts)], (rows[-1] if guidance.use_cfg else None)

    # ------------------------------------------------------------------
    # Image conditioning
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, pixels, timings: Optional[GenerationTimings] = None):
        """(1, 3, 1, H, W) pixels in [-1, 1] (numpy or tensor) -> the
        normalized f32 latent (1, C, 1, H/32, W/32) for I2V conditioning:
        the VAE encoder's mean, normalized with the decoder's per-channel
        statistics."""
        timings = timings if timings is not None else GenerationTimings()
        if self.vae_encoder is None:
            raise ModelNotLoadedError("vae_encoder")
        if self.vae_decoder is None:
            raise ModelNotLoadedError("vae_decoder")
        encoder = self._on_device("vae_encoder", timings)
        t0 = time.perf_counter()
        pixels = torch.as_tensor(pixels).to(self.device, encoder.dtype)
        latent = encoder(pixels).float()
        mean = self.vae_decoder.mean_of_means.to(self.device, torch.float32)
        std = self.vae_decoder.std_of_means.to(self.device, torch.float32)
        out = (latent - mean.reshape(1, -1, 1, 1, 1)) / std.reshape(1, -1, 1, 1, 1)
        _sync(self.device)
        timings.image_encode += time.perf_counter() - t0
        self._release("vae_encoder")
        return out

    def _encode_image_at(self, image_path: str, width: int, height: int,
                         timings: GenerationTimings):
        """Load the conditioning image at a target resolution and encode it."""
        from ltx_tpu_torch.io.video import load_image

        return self.encode_image(load_image(image_path, width, height), timings)

    @staticmethod
    def _conditioning_mask(shape: VideoLatentShape) -> np.ndarray:
        """(1, T) mask, 1 on the tokens of the conditioned first latent frame
        (patchify is row-major (F, H, W): frame 0's tokens come first)."""
        cm = np.zeros((1, shape.token_count), np.float32)
        cm[:, :shape.height * shape.width] = 1.0
        return cm

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

    def _initial_latent(self, noise, shape: VideoLatentShape, what: str):
        if tuple(noise.shape) != shape.shape:
            raise ValueError(f"{what} {tuple(noise.shape)} != {shape.shape}")
        return noise.to(self.device, torch.float32)

    def _denoise(self, latent, sigmas, shape, guidance, context, bias,
                 conditioning_mask, cond_noise_scale, fps, cond_noise, timings,
                 on_progress, conditioned_latent=None):
        """One denoise loop on the DiT, which stays on the device after it."""
        step_fn = make_denoise_step(
            self._on_device("transformer", timings), guidance, shape, context, bias,
            conditioning_mask=conditioning_mask, conditioned_latent=conditioned_latent,
            image_cond_noise_scale=cond_noise_scale, fps=fps)

        def on_step(i, n, sigma):
            now = time.perf_counter()
            timings.denoise_steps.append(now - on_step.t0)
            on_step.t0 = now
            if on_progress:
                on_progress(i, n, sigma)

        on_step.t0 = time.perf_counter()
        return run_denoise_loop(step_fn, latent, sigmas, cond_noise=cond_noise,
                                on_step=on_step)

    def decode_tile_frames(self, latent_frames: int):
        """Latent frames of each decode tile under this pipeline's memory
        config: a timestep-conditioned decoder takes one noise tensor of
        shape (1, C, that many, H', W') per tile."""
        return tile_latent_frames(latent_frames, self.memory.vae_tile_size,
                                  self.memory.vae_tile_overlap)

    def _decode_frames(self, latent, decode_noise, timings: GenerationTimings):
        """VAE decode in the decoder's own dtype -> host (F, H, W, 3) f32.
        The DiT leaves the device first (phase staging). A tiled decode
        copies each tile to the host as uint8. decode_noise: None, a tensor
        (untiled) or one tensor per tile."""
        if self.memory.decode_transfer not in ("uint8", "yuv420"):
            raise ValueError(f"unknown decode_transfer {self.memory.decode_transfer!r}")
        self._release("transformer")
        decoder = self._on_device("vae_decoder", timings)
        t0 = time.perf_counter()
        latent = latent.to(decoder.dtype)
        ts = 0.05 if self.vcfg.timestep_conditioning else None
        noise = None
        if ts is not None and decode_noise is not None:
            if isinstance(decode_noise, (list, tuple)):
                noise = [n.to(self.device, decoder.dtype) for n in decode_noise]
            else:
                noise = decode_noise.to(self.device, decoder.dtype)
        transfer = False
        if self.memory.vae_tile_size > 0:
            transfer = "yuv420" if self.memory.decode_transfer == "yuv420" else True
        frames = decode_video(decoder, latent, timestep=ts, noise=noise,
                              tile_size=self.memory.vae_tile_size,
                              tile_overlap=self.memory.vae_tile_overlap,
                              transfer_uint8=transfer)
        if torch.is_tensor(frames):
            frames = frames.float().cpu().numpy()
        timings.vae_decode += time.perf_counter() - t0
        self._release("vae_decoder")
        return frames

    @staticmethod
    def _check_ported(config: GenerationConfig) -> None:
        if config.enhance_prompt:
            raise NotImplementedError("enhance_prompt is not ported yet (ROADMAP A13)")

    @staticmethod
    def _seed(config: GenerationConfig) -> int:
        return config.seed if config.seed is not None else int(time.time())

    @torch.inference_mode()
    def generate_video(self, prompt: str, config: GenerationConfig,
                       initial_noise, decode_noise=None, image_latent=None,
                       cond_noise=None, on_progress=None) -> VideoGenerationResult:
        """Single-stage T2V, or I2V when `image_latent` (1, C, 1, H', W'), a
        normalized latent from `encode_image`, or `config.image_path` is
        given (the hook takes precedence).

        initial_noise: (1, C, F', H', W') float32 standard normal (see
        ops.latents.generate_noise). cond_noise: for I2V with
        config.image_cond_noise_scale > 0, one standard-normal tensor of
        image_latent's shape per denoise step. decode_noise: for decoders
        with timestep conditioning, the latent's shape, or one tensor per
        decode tile (`decode_tile_frames`). Returns frames (F, H, W, 3) in
        [0, 1] on the host."""
        config.validate()
        self._check_ported(config)
        total_start = time.perf_counter()
        timings = GenerationTimings()
        guidance = GuidanceSpec.from_config(config)

        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(config.image_path, config.width,
                                                 config.height, timings)

        (pos,), neg = self._encode_text([prompt], config, guidance, timings)
        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None)

        shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                             config.width,
                                             channels=self.tcfg.in_channels)
        sigmas = self._sigmas(config, shape)
        latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])

        conditioning_mask = None
        if image_latent is not None:
            # frame 0 is the clean conditioned latent; the mask marks its tokens
            image_latent = image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = image_latent
            conditioning_mask = self._conditioning_mask(shape)

        latent = self._denoise(latent, sigmas, shape, guidance, context, bias,
                               conditioning_mask, config.image_cond_noise_scale,
                               config.fps, cond_noise, timings, on_progress,
                               conditioned_latent=image_latent)

        frames = self._decode_frames(latent, decode_noise, timings)
        frames = frames[: config.num_frames]
        timings.total = time.perf_counter() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=self._seed(config))

    @torch.inference_mode()
    def generate_videos(self, prompts, config: GenerationConfig, initial_noise,
                        decode_noise=None, seeds=None) -> list:
        """B prompts through one batched denoise loop (the serving path);
        T2V only. Each prompt keeps its own noise, context rows and decode,
        and each sample's numerics match its solo `generate_video`.

        initial_noise: (B, C, F', H', W'), row i prompt i's noise;
        decode_noise: None or one entry per prompt, each as
        `generate_video`'s; seeds: the seeds to report (default config.seed,
        config.seed + 1, ...). Returns a list of VideoGenerationResult."""
        config.validate()
        self._check_ported(config)
        if config.image_path is not None:
            raise ValueError("generate_videos is T2V-only: image conditioning is "
                             "per-job state; route I2V requests through generate_video")
        prompts = list(prompts)
        b = len(prompts)
        if b == 0:
            return []
        total_start = time.perf_counter()
        if seeds is None:
            seeds = [self._seed(config) + i for i in range(b)]
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} prompts")
        if decode_noise is not None and len(decode_noise) != b:
            raise ValueError(f"{len(decode_noise)} decode noises for {b} prompts")
        guidance = GuidanceSpec.from_config(config)
        timings = GenerationTimings()

        # the positives and the shared negative ride one text pass
        pos_rows, neg = self._encode_text(prompts, config, guidance, timings)
        pos_v = torch.cat([r["video"] for r in pos_rows], dim=0)
        pos_m = torch.cat([r["mask"] for r in pos_rows], dim=0)
        neg_v = neg_m = None
        if neg is not None:
            neg_v = neg["video"].repeat(b, 1, 1)
            neg_m = neg["mask"].repeat(b, 1)
        context, bias = build_guidance_context_batched(guidance, pos_v, pos_m,
                                                       neg_v, neg_m)

        shape = VideoLatentShape.from_pixels(b, config.num_frames, config.height,
                                             config.width,
                                             channels=self.tcfg.in_channels)
        sigmas = self._sigmas(config, shape)
        latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])
        latent = self._denoise(latent, sigmas, shape, guidance, context, bias, None,
                               0.0, config.fps, None, timings, None)

        results = []
        for i in range(b):
            t_i = GenerationTimings(
                staging=timings.staging / b, gemma=timings.gemma / b,
                connector=timings.connector / b,
                denoise_steps=[d / b for d in timings.denoise_steps])
            frames = self._decode_frames(
                latent[i:i + 1], None if decode_noise is None else decode_noise[i], t_i)
            t_i.total = time.perf_counter() - total_start
            results.append(VideoGenerationResult(frames=frames[: config.num_frames],
                                                 timings=t_i, seed=seeds[i]))
        return results

    @torch.inference_mode()
    def generate_video_two_stage(self, prompt: str, config: GenerationConfig,
                                 stage1_noise, stage2_noise, decode_noise=None,
                                 image_latent=None, full_res_image_latent=None,
                                 stage1_cond_noise=None, stage2_cond_noise=None,
                                 on_progress=None) -> VideoGenerationResult:
        """Half-resolution denoise -> 2x latent upscale and AdaIN toward the
        stage-1 statistics -> a 3-step full-resolution refine without CFG ->
        decode.

        I2V: with config.image_path the image is encoded at half resolution
        for stage 1 and again at full resolution for stage 2; image_latent
        and full_res_image_latent are hooks that take the place of those
        encodes (see `encode_image`).

        stage1_noise: (1, C, F', H'/2, W'/2); stage2_noise: (1, C, F', H',
        W'), mixed into the upscaled latent as
        s * noise + (1 - s) * latent with s = STAGE_2_SIGMAS[0];
        stage{1,2}_cond_noise: per-step re-noise draws of each stage's image
        latent shape, when config.image_cond_noise_scale > 0; decode_noise
        as in `generate_video`."""
        config.validate()
        self._check_ported(config)
        if self.upscaler is None:
            raise ModelNotLoadedError("upscaler")
        total_start = time.perf_counter()
        timings = GenerationTimings()
        guidance = GuidanceSpec.from_config(config)
        g2 = GuidanceSpec.from_config(config, use_cfg=False)

        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width // 2, config.height // 2, timings)

        (pos,), neg = self._encode_text([prompt], config, guidance, timings)
        context, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None)

        # === stage 1: half resolution ===
        channels = self.tcfg.in_channels
        s1_shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height // 2,
                                                config.width // 2, channels=channels)
        s1_sigmas = schedule.get_sigmas(
            config.num_steps,
            distilled=config.num_steps <= 8 and config.cfg_scale <= 1.0,
            token_count=s1_shape.token_count)
        latent = self._initial_latent(stage1_noise, s1_shape, "stage1_noise") \
            * float(s1_sigmas[0])
        s1_cond_mask = None
        if image_latent is not None:
            image_latent = image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = image_latent
            s1_cond_mask = self._conditioning_mask(s1_shape)
        latent = self._denoise(latent, s1_sigmas, s1_shape, guidance, context, bias,
                               s1_cond_mask, config.image_cond_noise_scale, config.fps,
                               stage1_cond_noise, timings, on_progress,
                               conditioned_latent=image_latent)
        stage1_output = latent

        # === upscale 2x, AdaIN toward the stage-1 statistics ===
        upscaler = self._on_device("upscaler", timings)
        t0 = time.perf_counter()
        mean = self.vae_decoder.mean_of_means.to(self.device)
        std = self.vae_decoder.std_of_means.to(self.device)
        latent = adain_filter_latent(upsample_latents(upscaler, latent, mean, std),
                                     stage1_output)
        _sync(self.device)
        timings.upscale += time.perf_counter() - t0
        self._release("upscaler")

        # === stage 2: full resolution, 3 steps, never CFG ===
        s2_shape = VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                                config.width, channels=channels)
        s2_sigmas = schedule.STAGE_2_SIGMAS
        noise_scale = float(s2_sigmas[0])
        noise = self._initial_latent(stage2_noise, s2_shape, "stage2_noise")
        latent = noise_scale * noise + (1.0 - noise_scale) * latent

        if full_res_image_latent is None and config.image_path is not None:
            full_res_image_latent = self._encode_image_at(
                config.image_path, config.width, config.height, timings)
        s2_cond_mask = None
        if full_res_image_latent is not None:
            full_res_image_latent = full_res_image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = full_res_image_latent
            s2_cond_mask = self._conditioning_mask(s2_shape)

        context2, bias2 = build_guidance_context(g2, pos["video"], pos["mask"])
        latent = self._denoise(latent, s2_sigmas, s2_shape, g2, context2, bias2,
                               s2_cond_mask, config.image_cond_noise_scale, config.fps,
                               stage2_cond_noise, timings, on_progress,
                               conditioned_latent=full_res_image_latent)

        frames = self._decode_frames(latent, decode_noise, timings)
        frames = frames[: config.num_frames]
        timings.total = time.perf_counter() - total_start
        return VideoGenerationResult(frames=frames, timings=timings,
                                     seed=self._seed(config))
