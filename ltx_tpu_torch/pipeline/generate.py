"""Generation: prompt (and an optional conditioning image) -> frames, and
with the audio components a stereo waveform.

Port of ltx_tpu/pipeline/generate.py::LTXPipeline for text-to-video and
image-to-video, single-stage (`generate_video`), batched over prompts
(`generate_videos`) and two-stage (`generate_video_two_stage`: a guided
half-resolution denoise, a 2x latent upscale with AdaIN, a 3-step refine),
with `encode_prompt(s)` and `encode_image`; and jointly with audio through
the dual audio-video DiT, single-stage (`generate_video_with_audio`) and
two-stage (`generate_video_with_audio_two_stage`), the latent audio decoded
by the audio VAE and the vocoder. Phases: [prompt enhancement:
Gemma-3 samples the enhanced prompt, an I2V one seeing the image through
the SigLIP tower] -> tokenize -> Gemma-3 -> feature extractor and connector
-> [VAE encoder] -> the DiT denoise loop [-> upscaler -> the DiT again] ->
VAE decode, tiled in time when `memory.vae_tile_size` says so (uint8 or
yuv420 tiles, `memory.decode_transfer`). With `memory.phase_staging` every component
lives on the host between phases and comes to the device only for its own
phase, as the reference stages them; otherwise all sit on the device, and
`memory.offload_text_encoder` drops Gemma and the connector after encoding.

Random draws are explicit tensors: the initial latent noise of each stage
(and the audio latent's), one re-noise draw per denoise step for conditioned
frames (when `image_cond_noise_scale` > 0) and, for decoders with timestep
conditioning, one decode-noise tensor per decode tile. The reference derives them from
`config.seed`; a torch generator cannot give jax.random's numbers.

Long video: video-to-video (`generate_video_from_video`, SDEdit on the
flow-matching forward), clip extension (`generate_video_extension`, and the
audio path's `generate_video_with_audio(video_frames=)`), keyframes at any
8-aligned frames (`generate_video_keyframes`, with or without audio) and
latent-carry chains (`generate_video_chain`, `generate_video_chain_with_audio`:
every segment denoises first, the DiT staged once, then every segment
decodes, the VAE staged once; each segment after the first is conditioned on
the previous one's tail latent, optionally pinned to keyframe anchors).

The reference's warm-compile machinery (`_WarmCompiles`, `_warm_*`) overlaps
XLA compiles with earlier phases, and its chains rebind one compiled step
across segments; eager PyTorch compiles nothing, so neither has a
counterpart here: a chain builds each segment's step over the staged DiT.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Optional

import numpy as np
import torch

from ltx_tpu_torch.config import (
    DEFAULT_NEGATIVE_PROMPT,
    AudioVAEConfig,
    VocoderConfig,
    GenerationConfig,
    MemoryConfig,
    QuantizationConfig,
    TransformerConfig,
)
from ltx_tpu_torch.errors import (
    InvalidConfigurationError,
    ModelNotLoadedError,
    TextEncodingFailedError,
)
from ltx_tpu_torch.models import dit_av
from ltx_tpu_torch.models.audio_vae import AudioVAE, Vocoder, decode_audio
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
    decode_video_sharded,
    sharded_tiles,
    tile_latent_frames,
)
from ltx_tpu_torch.ops import schedule
from ltx_tpu_torch.ops.latents import VideoLatentShape, adain_filter_latent
from ltx_tpu_torch.pipeline.denoise import (
    GuidanceSpec,
    build_guidance_context,
    build_guidance_context_batched,
    make_av_denoise_step,
    make_denoise_step,
    run_av_denoise_loop,
    run_denoise_loop,
)
from ltx_tpu_torch.utils import diagnostics
from ltx_tpu_torch.utils.diagnostics import span

log = logging.getLogger("ltx_tpu_torch")


# the phase field each span adds its seconds to; the other spans are parts
# of a phase ("denoise.rope", "denoise.launch", "decode.wait",
# "decode.stitch", "decode.widen", "decode.copy")
_PHASE_OF_SPAN = {"clip": "total", "staging": "staging", "enhancement": "enhancement",
                  "text.gemma": "gemma", "text.connector": "connector",
                  "image_encode": "image_encode", "upscale": "upscale",
                  "decode.vae": "vae_decode", "decode.audio": "audio_decode"}


@dataclasses.dataclass
class GenerationTimings:
    """A generate_* call's span recorder (utils.diagnostics.recording) and
    its seconds per phase, each phase the sum of its spans and ended by a
    device synchronise: `total` the call's `clip` span; `staging` the
    components' moves to the device, outside the phases; `enhancement` the
    prompt enhancement's, with its generated tokens and decode forwards;
    `gemma` and `connector` the text phase's `text.gemma` and
    `text.connector`; `denoise_steps` one `denoise.step` a step, from its
    launch to its synchronise; `vae_decode` and `audio_decode` the
    `decode.vae` and `decode.audio` spans. The parts no phase field sums:
    `denoise.rope` (a loop's RoPE tables: on the card, the pinned copy of
    their inputs and the launches of `kernels.rope.rope_tables`),
    `denoise.launch` (the step function's call), and the decode's `decode.wait`
    (the host blocked on the device), `decode.stitch`, `decode.widen` and
    `decode.copy` (its host work). `spans` holds every span as (name,
    start_ns, end_ns) on time.time_ns, in the order they ended; `clip_id`
    is the call's process-wide id (utils.diagnostics.next_clip_id)."""

    staging: float = 0.0
    enhancement: float = 0.0
    enhancement_tokens: int = 0
    enhancement_forwards: int = 0
    gemma: float = 0.0
    connector: float = 0.0
    image_encode: float = 0.0
    denoise_steps: list = dataclasses.field(default_factory=list)  # every stage's
    upscale: float = 0.0
    vae_decode: float = 0.0
    audio_decode: float = 0.0  # the audio VAE and the vocoder
    total: float = 0.0
    clip_id: int = 0
    spans: list = dataclasses.field(default_factory=list)

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        """Keep one span and add its seconds to its phase."""
        self.spans.append((name, start_ns, end_ns))
        seconds = (end_ns - start_ns) / 1e9
        if name == "denoise.step":
            self.denoise_steps.append(seconds)
        elif name in _PHASE_OF_SPAN:
            field = _PHASE_OF_SPAN[name]
            setattr(self, field, getattr(self, field) + seconds)

    def span_seconds(self, *names: str) -> float:
        """The summed seconds of the spans named `names`."""
        return sum(e - s for n, s, e in self.spans if n in names) / 1e9

    def report(self) -> str:
        """The phases, one a line (the reference's lines, the text phase
        split into Gemma and the connector, staging and the upscale and
        audio decode added), with the RoPE build, the mean launch a step
        and the decode's host work."""
        steps = self.denoise_steps
        launches = [e - s for n, s, e in self.spans if n == "denoise.launch"]
        return "\n".join([
            f"Staging: {self.staging:.2f}s",
            f"Prompt enhancement: {self.enhancement:.2f}s ({self.enhancement_tokens} tokens)",
            f"Text encoding: {self.gemma + self.connector:.2f}s (Gemma {self.gemma:.2f}s, "
            f"connector {self.connector:.2f}s)",
            f"RoPE build: {self.span_seconds('denoise.rope'):.2f}s",
            f"Denoise: {sum(steps):.2f}s ({len(steps)} steps, "
            f"avg {np.mean(steps) if steps else 0:.2f}s, launch avg "
            f"{np.mean(launches) / 1e6 if launches else 0:.1f}ms)",
            f"Upscale: {self.upscale:.2f}s",
            f"VAE decode: {self.vae_decode:.2f}s (host "
            f"{self.span_seconds('decode.stitch', 'decode.widen', 'decode.copy'):.2f}s, "
            f"waits {self.span_seconds('decode.wait'):.2f}s)",
            f"Audio decode: {self.audio_decode:.2f}s",
            f"Total: {self.total:.2f}s",
        ])


@dataclasses.dataclass
class VideoGenerationResult:
    frames: np.ndarray  # (F, H, W, 3) float32 in [0, 1]
    timings: GenerationTimings
    seed: int = 0  # config.seed (the draws themselves are arguments)
    audio: Optional[np.ndarray] = None  # (2, samples) float32 in [-1, 1], the audio paths


def _one_clip(generate):
    """A generate_* entry's call as one clip: a GenerationTimings with the
    next clip_id is the active recorder for the call (the entry reads it
    from diagnostics.active()), its `clip` span the call's total. A call
    that returns joins diagnostics.recent_clips; one that raises leaves
    nothing behind."""
    @functools.wraps(generate)
    def call(self, *args, **kwargs):
        timings = GenerationTimings(clip_id=diagnostics.next_clip_id())
        with diagnostics.recording(timings), span("clip"):
            result = generate(self, *args, **kwargs)
        diagnostics.recent_clips.append(timings)
        return result

    return call


def _no_progress(i: int, n: int, sigma: float) -> None:
    """The denoise loops' on_step without a caller's: with one, a loop
    synchronises after each step, which ends the step's span."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_host(module) -> bool:
    """The module's parameters live on the CPU (a staged component)."""
    p = next(module.parameters(), None)
    return p is not None and p.device.type == "cpu"


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
    """Holds the modules and their configs; drives the phases. The audio
    paths take the dual DiT (`av_transformer`, at the video DiT's config),
    the audio VAE and the vocoder, and a text encoder with the audio
    connector; a pipeline built for them alone may have no video DiT."""

    def __init__(self, transformer: Optional[LTXTransformer], vae_decoder: VideoDecoder,
                 gemma: Optional[Gemma3Model] = None,
                 text_encoder: Optional[TextEncoder] = None, tokenizer=None,
                 memory: MemoryConfig = MemoryConfig(), is_distilled: bool = True,
                 device=None, vae_encoder: Optional[VideoEncoder] = None,
                 upscaler: Optional[LatentUpscaler] = None, vision=None, vision_config=None,
                 av_transformer: Optional[dit_av.LTXAVTransformer] = None,
                 audio_vae: Optional[AudioVAE] = None, vocoder: Optional[Vocoder] = None):
        dit = transformer if transformer is not None else av_transformer
        if dit is None:
            raise ModelNotLoadedError("transformer")
        self.transformer = transformer
        self.av_transformer = av_transformer
        self.audio_vae = audio_vae
        self.vocoder = vocoder
        self.vae_decoder = vae_decoder
        self.gemma = gemma
        self.text_encoder = text_encoder
        self.vae_encoder = vae_encoder
        self.upscaler = upscaler
        self.vision = vision  # the SigLIP tower of I2V enhancement, staged like Gemma
        self.vision_config = vision_config
        self.tokenizer = tokenizer
        self.memory = memory
        self.is_distilled = is_distilled
        self.device = torch.device(device if device is not None
                                   else dit.proj_out.weight.device)
        self.tcfg = dit.cfg
        self.vcfg = vae_decoder.cfg
        self.audio_vae_config = audio_vae.cfg if audio_vae is not None else None
        self.vocoder_config = vocoder.cfg if vocoder is not None else None
        self.gcfg = gemma.cfg if gemma is not None else None
        self.tecfg = text_encoder.cfg if text_encoder is not None else None
        self._host_store = {}  # name -> host tensors of a staged component
        self.mesh = None  # the (data, model) mesh of `shard`
        self.pp_mesh = None  # the (data, pipe) mesh of `shard_pp`
        self.pp_microbatches = None
        self._to_shard = set()  # staged components sharded when their phase starts

    @classmethod
    def random(cls, tcfg: TransformerConfig, vcfg: VAEConfig, gcfg: Gemma3Config,
               tecfg: TextEncoderConfig, device, seed: int = 0,
               dtype=torch.bfloat16, vae_dtype=torch.bfloat16,
               memory: MemoryConfig = MemoryConfig(),
               quantization: QuantizationConfig = QuantizationConfig(),
               ucfg: Optional[UpscalerConfig] = None,
               acfg: Optional[AudioVAEConfig] = None,
               voccfg: Optional[VocoderConfig] = None):
        """Random weights at the given configs, drawn on `device` from one
        seeded torch.Generator per component with the reference's init
        scales. With `quantization.mode` "int4", "qint8" or "w8a8" the DiTs'
        block linears are then quantized there, layer by layer; Gemma, the
        connectors, the VAEs, the vocoder and the upscaler stay unquantized.
        The VAE encoder takes the decoder's dtype, the upscaler (built when
        `ucfg` is given) float32. With `acfg` and `voccfg` the audio
        components come too: the dual DiT (the DiT's dtype), the text
        encoder's audio connector, the audio VAE and the vocoder (float32).
        With phase staging each component then moves to the host."""
        device = torch.device(device)
        audio = acfg is not None and voccfg is not None

        def build(i, make):
            gen = torch.Generator(device=device).manual_seed(seed * 16 + i)
            module = init_random_(make(), gen)
            if i in (0, 6) and quantization.bits is not None:
                quantize_transformer(module, quantization.bits, quantization.group_size,
                                     w8a8=quantization.mode == "w8a8")
            return module.to("cpu") if memory.phase_staging else module

        return cls(
            transformer=build(0, lambda: LTXTransformer(tcfg, device, dtype)),
            vae_decoder=build(1, lambda: VideoDecoder(vcfg, device, vae_dtype)),
            gemma=build(2, lambda: Gemma3Model(gcfg, device, dtype)),
            text_encoder=build(3, lambda: TextEncoder(tecfg, device, dtype,
                                                      include_audio=audio)),
            vae_encoder=build(4, lambda: VideoEncoder(vcfg, device, vae_dtype)),
            upscaler=None if ucfg is None else build(
                5, lambda: LatentUpscaler(ucfg, device, torch.float32)),
            av_transformer=build(6, lambda: dit_av.LTXAVTransformer(tcfg, device, dtype))
            if audio else None,
            audio_vae=build(7, lambda: AudioVAE(acfg, device)) if audio else None,
            vocoder=build(8, lambda: Vocoder(voccfg, device)) if audio else None,
            memory=memory, device=device)

    @classmethod
    def random_full(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(phase_staging=True),
                    quantization: QuantizationConfig = QuantizationConfig(),
                    include_audio: bool = False):
        """Full widths and depths: Gemma-3-12B, the 30x128 connector, the
        48-block DiT (bf16, or quantized per `quantization`), the
        1024-channel VAE decoder and the 128..2048-channel encoder; bf16
        otherwise, and the 1024-channel latent upscaler in float32. With
        include_audio also the 48-block dual DiT, the audio connector, the
        audio VAE and the vocoder."""
        audio = dict(acfg=AudioVAEConfig(), voccfg=VocoderConfig()) if include_audio else {}
        return cls.random(TransformerConfig(), VAEConfig(), Gemma3Config(),
                          TextEncoderConfig(), device, seed=seed, memory=memory,
                          quantization=quantization, ucfg=UpscalerConfig(), **audio)

    @classmethod
    def random_tiny(cls, device="cuda", seed: int = 0,
                    memory: MemoryConfig = MemoryConfig(),
                    quantization: QuantizationConfig = QuantizationConfig(),
                    include_audio: bool = False):
        """The reference's tiny test configs; f32 VAE like its tiny pipeline,
        and with include_audio its tiny audio VAE and vocoder. Torch draws
        differ from jax.random's: parity tests convert the reference's
        parameters instead (convert.py)."""
        cfgs = tiny_configs()
        audio = (dict(acfg=AudioVAEConfig().tiny(), voccfg=VocoderConfig().tiny())
                 if include_audio else {})
        return cls.random(*cfgs, device, seed=seed,
                          vae_dtype=torch.float32, memory=memory,
                          quantization=quantization,
                          ucfg=tiny_upscaler_config(cfgs[0]), **audio)

    # ------------------------------------------------------------------
    # Phase staging
    # ------------------------------------------------------------------

    def _on_device(self, name: str):
        """Place a component on the device for its phase. With phase staging
        its host tensors are kept, so that `_release` frees the device copy
        without copying anything back."""
        module = getattr(self, name)
        if module is None:
            raise ModelNotLoadedError(name)
        with span("staging"):
            if name in self._to_shard:
                self._to_shard.discard(name)
                self._shard_component(name, module)
            if self.memory.phase_staging and name not in self._host_store:
                self._host_store[name] = {n: p.data for n, p in module.named_parameters()}
            module.to(self.device)
            _sync(self.device)
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
    # Parallelism
    # ------------------------------------------------------------------

    _TP_SHARDED = ("transformer", "av_transformer", "gemma")

    def shard(self, mesh):
        """Place the components on a (data, model) mesh (the reference's
        `shard`): the video DiT, the dual DiT and Gemma get megatron tensor
        parallelism over the model axis (`parallel.sharding`, bf16 and
        quantized linears alike), the guidance rows of a denoise step split
        over the data axis, the VAE decode splits its frames over the model
        axis (`models.vae.decode_video_sharded`), and every other component
        stays whole on every rank. A component on the device is sharded
        now; one staged on the host (phase staging) when its phase starts
        (`_on_device`). Every process of the mesh builds the same pipeline
        and calls this. Returns the pipeline."""
        if self.pp_mesh is not None:
            raise InvalidConfigurationError("shard() and shard_pp() are mutually exclusive")
        self.mesh = mesh
        self._place(self._TP_SHARDED)
        return self

    def shard_pp(self, mesh, n_microbatches=None):
        """Pipeline-parallel placement over a (data, pipe) mesh (the
        reference's `shard_pp`): the video DiT and the dual DiT keep this
        stage's contiguous blocks (`parallel.pipeline.shard_pp`), every
        other component stays whole on every rank and the decode is not
        split; every denoise step runs the GPipe schedule with the guidance
        rows as its microbatches (n_microbatches of them, default one a
        row) and the rows over the data axis. A DiT on the device is split
        now; one staged on the host (phase staging) when its phase starts
        (`_on_device`). Every process of the mesh builds the same pipeline
        and calls this. Returns the pipeline."""
        if self.mesh is not None:
            raise InvalidConfigurationError("shard() and shard_pp() are mutually exclusive")
        self.pp_mesh, self.pp_microbatches = mesh, n_microbatches
        self._place(("transformer", "av_transformer"))
        return self

    def _place(self, names) -> None:
        """Split the named components over the mesh: now, or when their
        phase starts for one staged on the host."""
        for name in names:
            module = getattr(self, name)
            if module is None:
                continue
            if self.memory.phase_staging and _on_host(module):
                self._to_shard.add(name)
            else:
                self._shard_component(name, module)

    def _sharded_decode(self, latent_frames: int) -> bool:
        """The decode splits its frames over the mesh's model axis: a model
        axis of more than one rank and at least as many latent frames."""
        return (self.mesh is not None and self.mesh.shape["model"] > 1
                and latent_frames >= self.mesh.shape["model"])

    def _shard_component(self, name: str, module) -> None:
        from ltx_tpu_torch.parallel import pipeline, sharding

        if self.pp_mesh is not None:
            pipeline.shard_pp(module, self.pp_mesh, self.pp_microbatches)
        elif name == "gemma":
            sharding.shard_gemma(module, self.mesh)
        else:
            sharding.shard_transformer(module, self.mesh)

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

    def encode_prompt(self, prompt: str):
        """prompt -> {"video": (1, S, D), "mask": (1, S)} (and "audio": (1,
        S, D) with the audio connector): the Gemma tower, then the
        connector(s), each staged on the device for its own phase."""
        return self.encode_prompts([prompt])[0]

    @torch.inference_mode()
    def encode_prompts(self, prompts, batch: Optional[int] = None,
                       stage: Optional[bool] = None) -> list:
        """Encode many prompts with Gemma and the connector each placed on
        the device once. Chunks of `batch` prompts (default 4) go through the
        tower together; a tail chunk is padded by repeating its last row and
        the padded rows are dropped. stage=None follows memory.phase_staging:
        when staged, each chunk's hidden states wait on the host while the
        tower leaves and the connector arrives, so the two never share the
        device. Returns one {"video": (1, S, D), "mask": (1, S)} per prompt
        (and "audio" with the audio connector), on the pipeline's device."""
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

        gemma = self._on_device("gemma")
        with span("text.gemma"):
            hidden = []
            for ids, msk, _ in chunks:
                h = gemma.forward_hidden_states(ids, msk)
                hidden.append(h.cpu() if stage and len(chunks) > 1 else h)
            _sync(self.device)
        self._release("gemma")

        text_encoder = self._on_device("text_encoder")
        with span("text.connector"):
            results = []
            for ci, (_, msk, n) in enumerate(chunks):
                out = text_encoder.encode_from_hidden_states(hidden[ci].to(self.device), msk)
                hidden[ci] = None
                for r in range(n):
                    results.append({k: v[r:r + 1] for k, v in out.items()})
            _sync(self.device)
        self._release("text_encoder")
        return results

    def offload_text_encoder(self) -> None:
        """Drop Gemma and the connector (staging keeps the host copies)."""
        if not self.memory.phase_staging:
            self.gemma = None
            self.text_encoder = None

    def _encode_text(self, prompts, config: GenerationConfig, guidance: GuidanceSpec):
        """The positives and, under CFG, the negative prompt after them, in
        one pass. Returns (positive rows, the negative row or None)."""
        to_encode = list(prompts)
        if guidance.use_cfg:
            to_encode.append(config.negative_prompt or DEFAULT_NEGATIVE_PROMPT)
        rows = self.encode_prompts(to_encode)
        if self.memory.offload_text_encoder:
            self.offload_text_encoder()
        return rows[:len(prompts)], (rows[-1] if guidance.use_cfg else None)

    # ------------------------------------------------------------------
    # Image conditioning
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, pixels, release: bool = True):
        """(1, 3, 1, H, W) pixels in [-1, 1] (numpy or tensor) -> the
        normalized f32 latent (1, C, 1, H/32, W/32) for I2V conditioning:
        the VAE encoder's mean, normalized with the decoder's per-channel
        statistics. release=False leaves a staged encoder on the device for
        the caller's next encode (the caller releases it)."""
        if self.vae_encoder is None:
            raise ModelNotLoadedError("vae_encoder")
        if self.vae_decoder is None:
            raise ModelNotLoadedError("vae_decoder")
        encoder = self._on_device("vae_encoder")
        with span("image_encode"):
            pixels = torch.as_tensor(pixels).to(self.device, encoder.dtype)
            latent = encoder(pixels).float()
            mean = self.vae_decoder.mean_of_means.to(self.device, torch.float32)
            std = self.vae_decoder.std_of_means.to(self.device, torch.float32)
            out = (latent - mean.reshape(1, -1, 1, 1, 1)) / std.reshape(1, -1, 1, 1, 1)
            _sync(self.device)
        if release:
            self._release("vae_encoder")
        return out

    def encode_video(self, pixels, release: bool = True):
        """(1, 3, F, H, W) pixels in [-1, 1], F = 8k + 1 -> the normalized f32
        latent (1, C, k + 1, H/32, W/32): the multi-frame twin of
        `encode_image` (the causal encoder takes any 8k + 1 frames)."""
        return self.encode_image(pixels, release)

    def _encode_image_at(self, image_path: str, width: int, height: int):
        """Load the conditioning image at a target resolution and encode it."""
        from ltx_tpu_torch.io.video import load_image

        return self.encode_image(load_image(image_path, width, height))

    def _clip_frames(self, video_path, video_frames, config: GenerationConfig,
                     frames: int, sample: str):
        """Exactly one of a clip's path (read by io.video.load_video, `frames`
        of it by `sample`) or its pixels, checked to be (1, 3, frames, H, W)."""
        if (video_path is None) == (video_frames is None):
            raise InvalidConfigurationError("pass exactly one of video_path / video_frames")
        if video_frames is None:
            from ltx_tpu_torch.io.video import load_video

            video_frames = load_video(video_path, config.width, config.height, frames,
                                      sample=sample)
        video_frames = torch.as_tensor(video_frames)
        want = (1, 3, frames, config.height, config.width)
        if tuple(video_frames.shape) != want:
            raise InvalidConfigurationError(
                f"video_frames {tuple(video_frames.shape)} != {want}")
        return video_frames

    @staticmethod
    def _check_cond_frames(cond_frames: int, config: GenerationConfig) -> None:
        if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
            raise InvalidConfigurationError(f"cond_frames must be 8k+1, got {cond_frames}")
        if cond_frames >= config.num_frames:
            raise InvalidConfigurationError(
                f"cond_frames {cond_frames} must be < num_frames {config.num_frames}")

    def _encode_keyframe_sources(self, keyframes, config: GenerationConfig):
        """[(pixel frame index, source)] -> (the sources' latents stacked on
        the frame axis, f32, in index order; their latent-frame indices,
        int64). A source is an image path, pixels (1, 3, 1, H, W) in [-1, 1]
        or a normalized latent (1, C, 1, h, w); each index a multiple of 8
        (latent frame k sits at pixel frame 8k) inside the clip, none twice."""
        lat_idx, lats = [], []
        for pix_idx, src in sorted(keyframes, key=lambda kv: int(kv[0])):
            pix_idx = int(pix_idx)
            if pix_idx % 8 != 0:
                raise InvalidConfigurationError(
                    f"keyframe index {pix_idx} must be a multiple of 8 "
                    "(latent-frame alignment: latent k sits at pixel 8k)")
            if not 0 <= pix_idx < config.num_frames:
                raise InvalidConfigurationError(
                    f"keyframe index {pix_idx} outside [0, {config.num_frames})")
            k = pix_idx // 8
            if k in lat_idx:
                raise InvalidConfigurationError(f"duplicate keyframe at latent index {k}")
            if isinstance(src, str):
                lat = self._encode_image_at(src, config.width, config.height)
            else:
                src = torch.as_tensor(src)
                if src.ndim != 5 or src.shape[2] != 1:
                    raise InvalidConfigurationError(
                        f"keyframe source shape {tuple(src.shape)} is neither pixels "
                        "(1, 3, 1, H, W) nor a latent (1, C, 1, h, w)")
                if src.shape[1] == 3:
                    lat = self.encode_image(src)
                elif src.shape[1] == self.tcfg.in_channels:
                    lat = src
                else:
                    raise InvalidConfigurationError(
                        f"keyframe source has {src.shape[1]} channels; expected 3 (pixels) "
                        f"or {self.tcfg.in_channels} (latent)")
            lat_idx.append(k)
            lats.append(lat.to(self.device, torch.float32))
        return torch.cat(lats, dim=2), np.asarray(lat_idx, np.int64)

    @staticmethod
    def _conditioning_mask(shape: VideoLatentShape, frames: int = 1,
                           frame_idx=None) -> np.ndarray:
        """(1, T) mask, 1 on the tokens of the conditioned latent frames: the
        first `frames` (I2V, extension), or those named by `frame_idx`
        (keyframes). Patchify is row-major (F, H, W): frame f's tokens are
        the block [f*h*w, (f+1)*h*w)."""
        per_frame = shape.height * shape.width
        cm = np.zeros((1, shape.token_count), np.float32)
        if frame_idx is not None:
            for f in np.asarray(frame_idx).reshape(-1):
                cm[:, f * per_frame:(f + 1) * per_frame] = 1.0
        else:
            cm[:, :frames * per_frame] = 1.0
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
        if noise is None or tuple(noise.shape) != shape.shape:
            got = None if noise is None else tuple(noise.shape)
            raise ValueError(f"{what} {got} != {shape.shape}")
        return noise.to(self.device, torch.float32)

    @staticmethod
    def _per_segment(draws, segments: int, what: str, required: bool = True) -> list:
        """A chain's draws: one entry per segment (None entries when the
        argument is optional and absent), else ValueError naming it."""
        if draws is None and not required:
            return [None] * segments
        if draws is None or len(draws) != segments:
            got = None if draws is None else len(draws)
            raise ValueError(f"{what}: one entry per segment, {segments}, got {got}")
        return list(draws)

    @staticmethod
    def _check_draws(draws, steps: int, like, what: str) -> None:
        """The re-noise draws of a conditioned latent: `steps` tensors of its
        shape, else ValueError naming the argument."""
        shape = tuple(like.shape)
        if draws is None or len(draws) != steps:
            got = None if draws is None else len(draws)
            raise ValueError(f"{what}: the conditioned frames' re-noise needs {steps} draws "
                             f"of {shape}, one per step; got {got}")
        for d in draws:
            if tuple(d.shape) != shape:
                raise ValueError(f"{what}: a re-noise draw {tuple(d.shape)} != {shape}")

    @staticmethod
    def _guidance_context(guidance: GuidanceSpec, pos: dict, neg: Optional[dict]):
        """(context, key bias) of one prompt's guidance rows."""
        return build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None)

    def _precomputed(self, embeddings: dict, guidance: GuidanceSpec):
        """The text encoder bypassed: {"video": (1, S, D), "mask": (1, S)}
        and, under CFG, "neg_video" / "neg_mask" -> (pos, neg or None) rows
        on the device."""
        def row(video, mask):
            return {"video": torch.as_tensor(embeddings[video]).to(self.device),
                    "mask": torch.as_tensor(embeddings[mask]).to(self.device)}

        return (row("video", "mask"),
                row("neg_video", "neg_mask") if guidance.use_cfg else None)

    def _denoise(self, latent, sigmas, shape, guidance, context, bias,
                 conditioning_mask, cond_noise_scale, fps, cond_noise,
                 on_progress, conditioned_latent=None, cond_frames: int = 1,
                 cond_frame_idx=None, checkpoint=None, seed: int = 0):
        """One denoise loop on the DiT, which stays on the device after it;
        `checkpoint` (a DenoiseCheckpoint) saves and resumes it."""
        step_fn = make_denoise_step(
            self._on_device("transformer"), guidance, shape, context, bias,
            conditioning_mask=conditioning_mask, conditioned_latent=conditioned_latent,
            image_cond_noise_scale=cond_noise_scale, cond_frames=cond_frames,
            cond_frame_idx=cond_frame_idx, fps=fps, pp_mesh=self.pp_mesh)
        return run_denoise_loop(step_fn, latent, sigmas, cond_noise=cond_noise,
                                on_step=on_progress or _no_progress, checkpoint=checkpoint,
                                seed=seed)

    def decode_tile_frames(self, latent_frames: int):
        """Latent frames of each decode tile under this pipeline's memory
        config, or of each rank's tile when the decode is sharded over the
        mesh's model axis (`_decode_frames`): a timestep-conditioned decoder
        takes one noise tensor of shape (1, C, that many, H', W') per tile."""
        if self._sharded_decode(latent_frames):
            n = self.mesh.shape["model"]
            stride, ov = sharded_tiles(latent_frames, n, self.memory.vae_tile_overlap)
            return [stride + ov] * n
        return tile_latent_frames(latent_frames, self.memory.vae_tile_size,
                                  self.memory.vae_tile_overlap)

    def _decode_frames(self, latent, decode_noise, release: bool = True):
        """VAE decode in the decoder's own dtype -> host (F, H, W, 3) f32,
        one `decode.vae` span. The DiT leaves the device first (phase
        staging). A tiled decode copies each tile to the host as uint8
        (`decode_video`'s spans); an untiled one waits for its kernels
        (`decode.wait`, on a CUDA event recorded after them) and then copies
        its frames (`decode.copy`). decode_noise: None, a tensor (untiled)
        or one tensor per tile. release=False keeps the decoder placed for
        the next decode (a chain's segments)."""
        if self.memory.decode_transfer not in ("uint8", "yuv420"):
            raise ValueError(f"unknown decode_transfer {self.memory.decode_transfer!r}")
        self._release("transformer")
        decoder = self._on_device("vae_decoder")
        with span("decode.vae"):
            frames = self._decode_on(decoder, latent, decode_noise)
        if release:
            self._release("vae_decoder")
        return frames

    def _decode_on(self, decoder, latent, decode_noise) -> np.ndarray:
        """`_decode_frames`' decode on the placed decoder."""
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
        if self._sharded_decode(latent.shape[2]):
            # the frames decode across the model axis, one tile a rank
            frames = decode_video_sharded(
                decoder, latent, self.mesh, timestep=ts, noise=noise,
                tile_overlap=max(self.memory.vae_tile_overlap, 1),
                transfer_uint8="yuv420" if self.memory.decode_transfer == "yuv420" else True)
        else:
            frames = decode_video(decoder, latent, timestep=ts, noise=noise,
                                  tile_size=self.memory.vae_tile_size,
                                  tile_overlap=self.memory.vae_tile_overlap,
                                  transfer_uint8=transfer)
        if not torch.is_tensor(frames):
            return frames
        if frames.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(frames.device))
            with span("decode.wait"):
                done.synchronize()
        with span("decode.copy"):
            return frames.float().cpu().numpy()

    def _maybe_enhance(self, prompt: str, config: GenerationConfig, is_i2v: bool) -> str:
        """Prompt enhancement when `config.enhance_prompt` asks for it, on
        every generation path as the reference: Gemma (and for I2V the
        SigLIP tower) on the device, `enhance.enhance_prompt` with the
        config's speculation, timed. Gemma stays placed for the text phase
        that follows; the tower goes back (phase staging)."""
        if not config.enhance_prompt:
            return prompt
        if self.gemma is None or self.tokenizer is None:
            log.warning("enhance_prompt requested but the text encoder is not loaded; "
                        "using the raw prompt")
            return prompt
        from ltx_tpu_torch.pipeline.enhance import enhance_prompt

        gemma = self._on_device("gemma")
        vision = self._on_device("vision") if self.vision is not None else None
        stats = {}
        with span("enhancement"):
            enhanced = enhance_prompt(gemma, self.tokenizer, prompt, is_i2v=is_i2v,
                                      image_path=config.image_path, vision=vision,
                                      vision_config=self.vision_config,
                                      spec_k=config.enhancement_spec_k, stats=stats,
                                      mesh=self.mesh)
            _sync(self.device)
        timings = diagnostics.active()
        timings.enhancement_tokens += stats.get("tokens", 0)
        timings.enhancement_forwards += stats.get("forwards", 0)
        self._release("vision")
        log.info("Enhanced prompt: %s", enhanced)
        return enhanced

    @staticmethod
    def _seed(config: GenerationConfig) -> int:
        return config.seed if config.seed is not None else int(time.time())

    @_one_clip
    @torch.inference_mode()
    def generate_video(self, prompt: str, config: GenerationConfig,
                       initial_noise, decode_noise=None, image_latent=None,
                       cond_noise=None, on_progress=None,
                       precomputed_embeddings=None, checkpoint=None) -> VideoGenerationResult:
        """Single-stage T2V, or I2V when `image_latent` (1, C, 1, H', W'), a
        normalized latent from `encode_image`, or `config.image_path` is
        given (the hook takes precedence).

        initial_noise: (1, C, F', H', W') float32 standard normal (see
        ops.latents.generate_noise). cond_noise: for I2V with
        config.image_cond_noise_scale > 0, one standard-normal tensor of
        image_latent's shape per denoise step. decode_noise: for decoders
        with timestep conditioning, the latent's shape, or one tensor per
        decode tile (`decode_tile_frames`). precomputed_embeddings:
        {"video": (1, S, D), "mask": (1, S)} and under CFG "neg_video" /
        "neg_mask" in place of the text encoder (its rows from
        `encode_prompt(s)`). checkpoint: a utils.diagnostics.DenoiseCheckpoint
        that saves the denoise loop every few steps and resumes an
        interrupted run from its file (the same draws give the same frames).
        Returns frames (F, H, W, 3) in [0, 1] on the host."""
        config.validate()
        guidance = GuidanceSpec.from_config(config)

        is_i2v = image_latent is not None or config.image_path is not None
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(config.image_path, config.width,
                                                 config.height)

        prompt = self._maybe_enhance(prompt, config, is_i2v)
        if precomputed_embeddings is not None:
            pos, neg = self._precomputed(precomputed_embeddings, guidance)
            if self.memory.offload_text_encoder:
                self.offload_text_encoder()
        else:
            (pos,), neg = self._encode_text([prompt], config, guidance)
        context, bias = self._guidance_context(guidance, pos, neg)

        shape = self._shape(config)
        sigmas = self._sigmas(config, shape)
        latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])

        conditioning_mask = None
        if image_latent is not None:
            # frame 0 is the clean conditioned latent; the mask marks its tokens
            image_latent = image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = image_latent
            conditioning_mask = self._conditioning_mask(shape)

        seed = self._seed(config)
        latent = self._denoise(latent, sigmas, shape, guidance, context, bias,
                               conditioning_mask, config.image_cond_noise_scale,
                               config.fps, cond_noise, on_progress,
                               conditioned_latent=image_latent, checkpoint=checkpoint,
                               seed=seed)

        frames = self._decode_frames(latent, decode_noise)
        frames = frames[: config.num_frames]
        return VideoGenerationResult(frames=frames, timings=diagnostics.active(), seed=seed)

    @_one_clip
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

        if config.enhance_prompt and self.gemma is not None:
            from ltx_tpu_torch.pipeline.enhance import enhance_prompts

            gemma = self._on_device("gemma")
            with span("enhancement"):
                prompts = enhance_prompts(gemma, self.tokenizer, prompts,
                                          spec_k=config.enhancement_spec_k)
                _sync(self.device)

        # the positives and the shared negative ride one text pass
        pos_rows, neg = self._encode_text(prompts, config, guidance)
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
                               0.0, config.fps, None, None)

        results = []
        timings = diagnostics.active()
        for i in range(b):
            # the shared phases' share; the decode's spans are the prompt's own
            t_i = GenerationTimings(
                staging=timings.staging / b, enhancement=timings.enhancement / b,
                gemma=timings.gemma / b,
                connector=timings.connector / b,
                denoise_steps=[d / b for d in timings.denoise_steps], clip_id=timings.clip_id)
            with diagnostics.recording(t_i):
                frames = self._decode_frames(
                    latent[i:i + 1], None if decode_noise is None else decode_noise[i])
            t_i.total = time.perf_counter() - total_start
            results.append(VideoGenerationResult(frames=frames[: config.num_frames],
                                                 timings=t_i, seed=seeds[i]))
        return results

    @_one_clip
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
        if self.upscaler is None:
            raise ModelNotLoadedError("upscaler")
        guidance = GuidanceSpec.from_config(config)
        g2 = GuidanceSpec.from_config(config, use_cfg=False)

        is_i2v = (config.image_path is not None or image_latent is not None
                  or full_res_image_latent is not None)
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width // 2, config.height // 2)

        prompt = self._maybe_enhance(prompt, config, is_i2v)
        (pos,), neg = self._encode_text([prompt], config, guidance)
        context, bias = self._guidance_context(guidance, pos, neg)

        # === stage 1: half resolution ===
        s1_shape, s2_shape = self.stage_shapes(config)
        s1_sigmas = self.stage1_sigmas(config, s1_shape)
        latent = self._initial_latent(stage1_noise, s1_shape, "stage1_noise") \
            * float(s1_sigmas[0])
        s1_cond_mask = None
        if image_latent is not None:
            image_latent = image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = image_latent
            s1_cond_mask = self._conditioning_mask(s1_shape)
        latent = self._denoise(latent, s1_sigmas, s1_shape, guidance, context, bias,
                               s1_cond_mask, config.image_cond_noise_scale, config.fps,
                               stage1_cond_noise, on_progress,
                               conditioned_latent=image_latent)
        stage1_output = latent

        # === upscale 2x, AdaIN toward the stage-1 statistics ===
        upscaler = self._on_device("upscaler")
        with span("upscale"):
            mean = self.vae_decoder.mean_of_means.to(self.device)
            std = self.vae_decoder.std_of_means.to(self.device)
            latent = adain_filter_latent(upsample_latents(upscaler, latent, mean, std),
                                         stage1_output)
            _sync(self.device)
        self._release("upscaler")

        # === stage 2: full resolution, 3 steps, never CFG ===
        s2_sigmas = schedule.STAGE_2_SIGMAS
        noise_scale = float(s2_sigmas[0])
        noise = self._initial_latent(stage2_noise, s2_shape, "stage2_noise")
        latent = noise_scale * noise + (1.0 - noise_scale) * latent

        if full_res_image_latent is None and config.image_path is not None:
            full_res_image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)
        s2_cond_mask = None
        if full_res_image_latent is not None:
            full_res_image_latent = full_res_image_latent.to(self.device, torch.float32)
            latent[:, :, :1] = full_res_image_latent
            s2_cond_mask = self._conditioning_mask(s2_shape)

        context2, bias2 = build_guidance_context(g2, pos["video"], pos["mask"])
        latent = self._denoise(latent, s2_sigmas, s2_shape, g2, context2, bias2,
                               s2_cond_mask, config.image_cond_noise_scale, config.fps,
                               stage2_cond_noise, on_progress,
                               conditioned_latent=full_res_image_latent)

        frames = self._decode_frames(latent, decode_noise)
        frames = frames[: config.num_frames]
        return VideoGenerationResult(frames=frames, timings=diagnostics.active(),
                                     seed=self._seed(config))

    # ------------------------------------------------------------------
    # Long video: video-to-video, extension, keyframes, chains
    # ------------------------------------------------------------------

    def _shape(self, config: GenerationConfig) -> VideoLatentShape:
        return VideoLatentShape.from_pixels(1, config.num_frames, config.height,
                                            config.width, channels=self.tcfg.in_channels)

    def stage_shapes(self, config: GenerationConfig):
        """A two-stage run's latent shapes: stage 1 at half the width and
        height, stage 2 at the config's."""
        half = VideoLatentShape.from_pixels(1, config.num_frames, config.height // 2,
                                            config.width // 2, channels=self.tcfg.in_channels)
        return half, self._shape(config)

    @staticmethod
    def stage1_sigmas(config: GenerationConfig, shape: VideoLatentShape,
                      audio: bool = False) -> np.ndarray:
        """Stage 1's schedule: the distilled table for at most 8 steps
        without CFG (always with audio), else the dev schedule, shifted by
        the half-size token count."""
        distilled = audio or (config.num_steps <= 8 and config.cfg_scale <= 1.0)
        return schedule.get_sigmas(config.num_steps, distilled=distilled,
                                   token_count=shape.token_count)

    def cond_latent_shape(self, config: GenerationConfig, frames: int) -> tuple:
        """A conditioned latent of `frames` latent frames at the config's
        size, (1, C, frames, h, w): the shape of its re-noise draws."""
        return dataclasses.replace(self._shape(config), frames=frames).shape

    def decode_noise_shapes(self, shape: VideoLatentShape) -> list:
        """The decode-noise tensors a latent of `shape` takes: one a decode
        tile (`decode_tile_frames`) for a timestep-conditioned decoder, none
        otherwise."""
        if not self.vcfg.timestep_conditioning:
            return []
        return [dataclasses.replace(shape, batch=1, frames=f).shape
                for f in self.decode_tile_frames(shape.frames)]

    @_one_clip
    @torch.inference_mode()
    def generate_video_from_video(self, prompt: str, config: GenerationConfig,
                                  initial_noise, video_path: Optional[str] = None,
                                  video_frames=None, strength: float = 0.6,
                                  decode_noise=None, on_progress=None) -> VideoGenerationResult:
        """Video-to-video: the input clip encoded, noised to the schedule's
        sigma at step k = round((1 - strength) * n) by the flow-matching
        forward (1 - s) x0 + s noise, then the last n - k steps denoised
        under the prompt. strength in (0, 1]; 1.0 starts from pure noise and
        is `generate_video` bit for bit on the same initial_noise.

        video_path: a clip read by io.video.load_video (config.num_frames
        frames sampled evenly, resized); video_frames: (1, 3, num_frames, H,
        W) in [-1, 1] instead. initial_noise: the latent's shape (the noise
        the clip's latent is mixed with); decode_noise as `generate_video`'s."""
        config.validate()
        if not 0.0 < strength <= 1.0:
            raise InvalidConfigurationError(f"v2v strength must be in (0, 1], got {strength}")
        video_frames = self._clip_frames(video_path, video_frames, config, config.num_frames,
                                         "even")
        guidance = GuidanceSpec.from_config(config)
        prompt = self._maybe_enhance(prompt, config, False)
        (pos,), neg = self._encode_text([prompt], config, guidance)
        context, bias = self._guidance_context(guidance, pos, neg)

        shape = self._shape(config)
        src_latent = self.encode_video(video_frames)
        sig_full = self._sigmas(config, shape)
        n_steps = len(sig_full) - 1
        k = min(max(int(round((1.0 - strength) * n_steps)), 0), n_steps - 1)
        sigmas = sig_full[k:]
        noise = self._initial_latent(initial_noise, shape, "initial_noise")
        latent = schedule.add_noise(src_latent, noise, float(sigmas[0]))
        latent = self._denoise(latent, sigmas, shape, guidance, context, bias, None, 0.0,
                               config.fps, None, on_progress)
        frames = self._decode_frames(latent, decode_noise)
        return VideoGenerationResult(frames=frames[: config.num_frames],
                                     timings=diagnostics.active(),
                                     seed=self._seed(config))

    @_one_clip
    @torch.inference_mode()
    def generate_video_extension(self, prompt: str, config: GenerationConfig,
                                 initial_noise, video_path: Optional[str] = None,
                                 video_frames=None, cond_frames: int = 9, decode_noise=None,
                                 cond_noise=None, on_progress=None) -> VideoGenerationResult:
        """Extend a clip: its last `cond_frames` pixel frames (8k + 1, fewer
        than num_frames) are encoded into the first k + 1 latent frames,
        which keep timestep 0 and are carried through Euler (re-noised each
        step from the clean latent when config.image_cond_noise_scale > 0);
        the rest is generated. The result starts with those frames, re-encoded,
        and runs num_frames in all. cond_frames=1 on a one-frame clip is I2V
        bit for bit.

        video_path: a clip whose last cond_frames frames io.video.load_video
        reads; video_frames: (1, 3, cond_frames, H, W) in [-1, 1] instead.
        initial_noise and decode_noise as `generate_video`'s; cond_noise: one
        draw a step of the conditioned latent's shape (1, C, k + 1, h, w)."""
        config.validate()
        self._check_cond_frames(cond_frames, config)
        video_frames = self._clip_frames(video_path, video_frames, config, cond_frames, "tail")
        guidance = GuidanceSpec.from_config(config)
        prompt = self._maybe_enhance(prompt, config, False)
        (pos,), neg = self._encode_text([prompt], config, guidance)
        context, bias = self._guidance_context(guidance, pos, neg)

        shape = self._shape(config)
        cond_latent = self.encode_video(video_frames)
        k_lat = cond_latent.shape[2]
        sigmas = self._sigmas(config, shape)
        if config.image_cond_noise_scale > 0:
            self._check_draws(cond_noise, len(sigmas) - 1, cond_latent, "cond_noise")
        latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])
        latent[:, :, :k_lat] = cond_latent
        latent = self._denoise(latent, sigmas, shape, guidance, context, bias,
                               self._conditioning_mask(shape, frames=k_lat),
                               config.image_cond_noise_scale, config.fps, cond_noise,
                               on_progress, conditioned_latent=cond_latent, cond_frames=k_lat)
        frames = self._decode_frames(latent, decode_noise)
        return VideoGenerationResult(frames=frames[: config.num_frames],
                                     timings=diagnostics.active(),
                                     seed=self._seed(config))

    @_one_clip
    @torch.inference_mode()
    def generate_video_keyframes(self, prompt: str, config: GenerationConfig, keyframes,
                                 initial_noise, audio_noise=None, decode_noise=None,
                                 cond_noise=None, audio: bool = False,
                                 audio_gain: float = 1.0,
                                 on_progress=None) -> VideoGenerationResult:
        """Condition on keyframes at any 8-aligned pixel frames:
        keyframes = [(pixel frame index, source), ...], e.g. the first and
        the last frame for the motion between. A source is an image path,
        pixels (1, 3, 1, H, W) in [-1, 1] or a normalized latent (1, C, 1,
        h, w); each anchors latent frame index // 8, which keeps timestep 0
        and is carried through Euler (re-noised from the clean latent when
        config.image_cond_noise_scale > 0). keyframes=[(0, latent)] is I2V
        bit for bit.

        audio=True runs the dual DiT with a soundtrack, as
        `generate_video_with_audio` (STG dropped, audio_gain applied):
        keyframes=[(0, latent)] is its I2V bit for bit. initial_noise,
        audio_noise and decode_noise as those entry points'; cond_noise: one
        draw a step of the keyframes' stacked latent (1, C, K, h, w)."""
        config.validate()
        if not keyframes:
            raise InvalidConfigurationError("keyframes must be non-empty")
        if audio:
            self._require_audio()
        guidance = GuidanceSpec.from_config(config)
        if audio:
            guidance = dataclasses.replace(guidance, stg_scale=0.0)
        shape = self._shape(config)
        cond_latent, cond_idx = self._encode_keyframe_sources(keyframes, config)
        prompt = self._maybe_enhance(prompt, config, True)
        if audio:
            v_ctx, a_ctx, bias = self._encode_text_with_audio(prompt, config, guidance)
        else:
            (pos,), neg = self._encode_text([prompt], config, guidance)
            context, bias = self._guidance_context(guidance, pos, neg)

        sigmas = self._sigmas(config, shape)
        if config.image_cond_noise_scale > 0:
            self._check_draws(cond_noise, len(sigmas) - 1, cond_latent, "cond_noise")
        cm = self._conditioning_mask(shape, frame_idx=cond_idx)
        latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])
        latent[:, :, torch.from_numpy(cond_idx).to(self.device)] = cond_latent
        if audio:
            audio_packed = self._audio_latent(audio_noise, config, "audio_noise") \
                * float(sigmas[0])
            latent, audio_packed = self._av_denoise(
                latent, audio_packed, sigmas, shape, guidance, v_ctx, a_ctx, bias, cm,
                cond_latent, config, cond_noise, on_progress, cond_frame_idx=cond_idx)
            frames, waveform = self._decode_av(latent, audio_packed, decode_noise, audio_gain)
        else:
            latent = self._denoise(latent, sigmas, shape, guidance, context, bias, cm,
                                   config.image_cond_noise_scale, config.fps, cond_noise,
                                   on_progress, conditioned_latent=cond_latent,
                                   cond_frame_idx=cond_idx)
            frames, waveform = self._decode_frames(latent, decode_noise), None
        return VideoGenerationResult(frames=frames[: config.num_frames],
                                     timings=diagnostics.active(),
                                     seed=self._seed(config), audio=waveform)

    def _check_chain(self, segments: int, cond_frames: int, prompts,
                     config: GenerationConfig) -> None:
        if segments < 1:
            raise InvalidConfigurationError(f"segments must be >= 1, got {segments}")
        if cond_frames < 1 or (cond_frames - 1) % 8 != 0:
            raise InvalidConfigurationError(f"cond_frames must be 8k+1, got {cond_frames}")
        if segments > 1 and cond_frames >= config.num_frames:
            raise InvalidConfigurationError(
                f"cond_frames {cond_frames} must be < num_frames {config.num_frames}")
        if prompts is not None and len(prompts) != segments:
            raise InvalidConfigurationError(f"{len(prompts)} prompts for {segments} segments")

    def _encode_chain_anchors(self, anchors, segments: int, k_lat: int,
                              config: GenerationConfig) -> dict:
        """{segment: [(pixel frame index, source), ...]} -> {segment:
        (latents, latent indices)}, encoded and checked before any text or
        denoise work; an anchor of a segment after the first must lie past
        the carried tail's k_lat latent frames."""
        anchor_enc = {}
        for si, kfs in (anchors or {}).items():
            si = int(si)
            if not 0 <= si < segments:
                raise InvalidConfigurationError(f"anchor segment {si} outside [0, {segments})")
            a_lat, a_idx = self._encode_keyframe_sources(kfs, config)
            if si > 0 and int(a_idx[0]) < k_lat:
                raise InvalidConfigurationError(
                    f"segment {si} anchor at latent frame {int(a_idx[0])} overlaps the "
                    f"carried tail (first {k_lat} latent frames)")
            anchor_enc[si] = (a_lat, a_idx)
        return anchor_enc

    def _encode_chain_prompts(self, seg_prompts, config: GenerationConfig,
                              guidance: GuidanceSpec,
                              need_audio: bool = False):
        """A chain's prompts -> ({prompt: row}, the negative row or None).
        One unique prompt takes `generate_video`'s sequence (its enhancement,
        then its text pass), so that segment 0 is `generate_video`; several
        are enhanced together (`enhance_prompts`, four rows at a time) and
        encoded in one text pass with the negative after them."""
        unique = list(dict.fromkeys(seg_prompts))
        if len(unique) == 1:
            enhanced = [self._maybe_enhance(unique[0], config, False)]
        else:
            enhanced = unique
            if config.enhance_prompt:
                if self.gemma is None or self.tokenizer is None:
                    log.warning("enhance_prompt requested but the text encoder is not "
                                "loaded; using the raw prompts")
                else:
                    from ltx_tpu_torch.pipeline.enhance import enhance_prompts

                    gemma = self._on_device("gemma")
                    with span("enhancement"):
                        enhanced = enhance_prompts(gemma, self.tokenizer, unique,
                                                   spec_k=config.enhancement_spec_k,
                                                   max_batch=4)
                        _sync(self.device)
        rows, neg = self._encode_text(enhanced, config, guidance)
        if need_audio and any("audio" not in r for r in rows + ([neg] if neg else [])):
            raise TextEncodingFailedError("text encoder lacks the audio connector")
        return dict(zip(unique, rows)), neg

    @staticmethod
    def chain_cond_frames(segments: int, cond_frames: int, anchors=None) -> list:
        """Each chain segment's conditioned latent frames (its cond_noise
        draws' frame count): the carried tail's (cond_frames - 1) // 8 + 1
        after segment 0, then the segment's anchors; None for segment 0
        unanchored (as `_chain_segment_conditioning` lays them out)."""
        k_lat = (cond_frames - 1) // 8 + 1
        anchors = {int(k): v for k, v in (anchors or {}).items()}
        out = []
        for i in range(segments):
            n = (k_lat if i else 0) + len(anchors.get(i, ()))
            out.append(n or None)
        return out

    def _chain_segment_conditioning(self, i: int, shape: VideoLatentShape, k_lat: int,
                                    tail, anchor):
        """Segment i's video conditioning: (the frames to set in its initial
        latent as [(index or slice, latent)], conditioning mask, clean
        conditioned latent, cond_frames, cond_frame_idx). Segment 0 is
        unconditioned unless anchored; a later segment is conditioned on the
        carried tail, in its first k_lat frames, and on its anchors after
        them (indices tail ++ anchors, latents in that order)."""
        if i == 0 and anchor is None:
            return [], None, None, 1, None
        if anchor is None:
            return ([(slice(0, k_lat), tail)], self._conditioning_mask(shape, frames=k_lat),
                    tail, k_lat, None)
        a_lat, a_idx = anchor
        sets = [(torch.from_numpy(a_idx).to(self.device), a_lat)]
        if i == 0:
            idx, c_lat = a_idx, a_lat
        else:
            sets.insert(0, (slice(0, k_lat), tail))
            idx = np.concatenate([np.arange(k_lat), a_idx])
            c_lat = torch.cat([tail, a_lat], dim=2)
        return sets, self._conditioning_mask(shape, frame_idx=idx), c_lat, 1, idx

    @_one_clip
    @torch.inference_mode()
    def generate_video_chain(self, prompt: str, config: GenerationConfig, segments: int,
                             initial_noise, cond_frames: int = 9, prompts=None,
                             decode_noise=None, cond_noise=None, precomputed_embeddings=None,
                             anchors=None, tail_renorm: float = 0.0,
                             on_progress=None) -> VideoGenerationResult:
        """Long video as a chain of segments, each after the first conditioned
        on the previous one's denoised tail latent (its last (cond_frames -
        1) // 8 + 1 latent frames, no decode and re-encode between), as
        `generate_video_extension` conditions on a clip. Every segment
        denoises first, the DiT staged once; then every segment decodes, the
        VAE staged once, and each after the first drops its first
        cond_frames frames (they re-render the carried tail): num_frames +
        (segments - 1) * (num_frames - cond_frames) frames in all. Segment 0
        is `generate_video` bit for bit on the same draws.

        prompts: one per segment (default `prompt` for all). anchors:
        {segment: [(pixel frame index, source), ...]}, keyframes as
        `generate_video_keyframes`' with per-segment indices, past the
        carried tail after segment 0; an anchored segment is conditioned on
        the tail and its anchors through keyframe indices; anchors={0: kfs}
        with segments=1 is `generate_video_keyframes` bit for bit.
        tail_renorm in [0, 1]: AdaIN of each carried tail toward segment 0's
        tail statistics, blended by this factor (0: off).
        precomputed_embeddings: as `generate_video`'s, for every segment
        (one prompt only).

        Draws, one entry per segment: initial_noise (the latent's shape);
        cond_noise (when config.image_cond_noise_scale > 0, for each
        conditioned segment one draw a step of its conditioned latent:
        (1, C, k_lat, h, w), with anchors (1, C, k_lat + A, h, w); None for
        segment 0 when it is unanchored); decode_noise (optional, each as
        `generate_video`'s). on_progress(i * steps + s, segments * steps,
        sigma)."""
        config.validate()
        segments = int(segments)
        self._check_chain(segments, cond_frames, prompts, config)
        initial_noise = self._per_segment(initial_noise, segments, "initial_noise")
        decode_noise = self._per_segment(decode_noise, segments, "decode_noise", required=False)
        cond_noise = self._per_segment(cond_noise, segments, "cond_noise", required=False)
        guidance = GuidanceSpec.from_config(config)
        seg_prompts = list(prompts) if prompts is not None else [prompt] * segments
        k_lat = (cond_frames - 1) // 8 + 1
        anchor_enc = self._encode_chain_anchors(anchors, segments, k_lat, config)

        if precomputed_embeddings is not None:
            if len(set(seg_prompts)) > 1:
                raise InvalidConfigurationError(
                    "precomputed_embeddings carries ONE embedding set; per-segment prompts "
                    "cannot vary with it")
            pos, neg = self._precomputed(precomputed_embeddings, guidance)
            encoded = {p: pos for p in seg_prompts}
        else:
            encoded, neg = self._encode_chain_prompts(seg_prompts, config, guidance)
        contexts = [self._guidance_context(guidance, encoded[p], neg) for p in seg_prompts]

        shape = self._shape(config)
        sigmas = self._sigmas(config, shape)
        n_steps = len(sigmas) - 1
        latents, tail, tail0 = [], None, None
        for i in range(segments):
            latent = self._initial_latent(initial_noise[i], shape, f"initial_noise[{i}]") \
                * float(sigmas[0])
            sets, cm, c_lat, cf, idx = self._chain_segment_conditioning(
                i, shape, k_lat, tail, anchor_enc.get(i))
            for where, value in sets:
                latent[:, :, where] = value
            scale = config.image_cond_noise_scale if cm is not None else 0.0
            if scale > 0:
                self._check_draws(cond_noise[i], n_steps, c_lat, f"cond_noise[{i}]")
            context, bias = contexts[i]
            latent = self._denoise(
                latent, sigmas, shape, guidance, context, bias, cm, scale, config.fps,
                cond_noise[i], self._chain_progress(on_progress, i, n_steps, segments),
                conditioned_latent=c_lat, cond_frames=cf, cond_frame_idx=idx)
            tail = latent[:, :, -k_lat:].float()
            if i == 0:
                tail0 = tail
            elif tail_renorm > 0:
                tail = adain_filter_latent(tail, tail0, factor=float(tail_renorm))
            latents.append(latent)

        parts = []
        for i, latent in enumerate(latents):
            frames = self._decode_frames(latent, decode_noise[i],
                                         release=i == segments - 1)[: config.num_frames]
            parts.append(frames if i == 0 else frames[cond_frames:])
        return VideoGenerationResult(frames=np.concatenate(parts, axis=0),
                                     timings=diagnostics.active(),
                                     seed=self._seed(config))

    @staticmethod
    def _chain_progress(on_progress, i: int, n_steps: int, segments: int):
        """Segment i's step callback in the chain's count of steps."""
        if on_progress is None:
            return None
        return lambda s, n, sigma: on_progress(i * n_steps + s, segments * n_steps, sigma)

    # ------------------------------------------------------------------
    # Joint audio
    # ------------------------------------------------------------------

    def _require_audio(self, upscaler: bool = False) -> None:
        for name, module in (("av_transformer", self.av_transformer),
                             ("audio_vae", self.audio_vae), ("vocoder", self.vocoder)):
            if module is None:
                raise ModelNotLoadedError(name)
        if upscaler and self.upscaler is None:
            raise ModelNotLoadedError("upscaler")

    def audio_frames(self, config: GenerationConfig) -> int:
        """Audio latent frames of a clip: its seconds (num_frames / fps) at 25
        latent frames a second."""
        return dit_av.audio_frame_count(config.num_frames / config.fps)

    def audio_noise_shape(self, config: GenerationConfig) -> tuple:
        """The raw audio draw's shape, (1, 8, audio frames, mel latent bins)."""
        return (1, 8, self.audio_frames(config), self.tcfg.audio_in_channels // 8)

    def packed_audio_shape(self, config: GenerationConfig, frames: Optional[int] = None):
        """The packed audio latent's shape (1, T, C_a), or that of its first
        `frames` frames: the two-stage path's stage-2 audio draw and an
        audio chain's audio_cond_noise."""
        t = self.audio_frames(config) if frames is None else frames
        return (1, t, self.tcfg.audio_in_channels)

    def audio_overlap_frames(self, config: GenerationConfig, cond_frames: int) -> int:
        """The packed audio frames an audio chain carries with audio_cond:
        max(1, round(audio frames * cond_frames / num_frames))."""
        return max(1, int(round(self.audio_frames(config) * cond_frames / config.num_frames)))

    def _encode_text_with_audio(self, prompt: str, config: GenerationConfig,
                                guidance: GuidanceSpec):
        """The video and audio contexts of the guidance rows, and their one
        key bias."""
        (pos,), neg = self._encode_text([prompt], config, guidance)
        if "audio" not in pos:
            raise TextEncodingFailedError("text encoder lacks the audio connector")
        return self._av_contexts(guidance, pos, neg)

    @staticmethod
    def _av_contexts(guidance: GuidanceSpec, pos: dict, neg: Optional[dict]):
        """(video context, audio context, their one key bias) of a prompt's
        guidance rows."""
        v_ctx, bias = build_guidance_context(
            guidance, pos["video"], pos["mask"],
            neg["video"] if neg else None, neg["mask"] if neg else None)
        a_ctx, _ = build_guidance_context(
            guidance, pos["audio"], pos["mask"],
            neg["audio"] if neg else None, neg["mask"] if neg else None)
        return v_ctx, a_ctx, bias

    def _audio_latent(self, audio_noise, config: GenerationConfig, what: str):
        shape = self.audio_noise_shape(config)
        if tuple(audio_noise.shape) != shape:
            raise ValueError(f"{what} {tuple(audio_noise.shape)} != {shape}")
        return dit_av.pack_audio_latents(audio_noise.to(self.device, torch.float32))

    def _av_denoise(self, video_latent, audio_packed, sigmas, shape, guidance, v_ctx, a_ctx,
                    bias, conditioning_mask, conditioned_latent, config, cond_noise,
                    on_progress, video_euler: str = "scheduler", cond_frames: int = 1,
                    cond_frame_idx=None, audio_cond_frames: int = 0,
                    audio_conditioned_latent=None, audio_cond_noise=None):
        """One dual denoise loop on the AV DiT, which stays on the device."""
        step_fn = make_av_denoise_step(
            self._on_device("av_transformer"), guidance, shape,
            self.audio_frames(config), v_ctx, a_ctx, bias,
            conditioning_mask=conditioning_mask, conditioned_latent=conditioned_latent,
            image_cond_noise_scale=config.image_cond_noise_scale,
            cond_frames=cond_frames, cond_frame_idx=cond_frame_idx,
            audio_cond_frames=audio_cond_frames,
            audio_conditioned_latent=audio_conditioned_latent, fps=config.fps,
            video_euler=video_euler, pp_mesh=self.pp_mesh)
        return run_av_denoise_loop(step_fn, video_latent, audio_packed, sigmas,
                                   cond_noise=cond_noise, audio_cond_noise=audio_cond_noise,
                                   on_step=on_progress or _no_progress)

    def _decode_av(self, video_latent, audio_packed, decode_noise, audio_gain: float):
        """Frames (the dual DiT leaves the device first under phase staging)
        and the waveform (2, samples) on the host, gain applied and clipped
        to [-1, 1]."""
        self._release("av_transformer")
        frames = self._decode_frames(video_latent, decode_noise)
        (waveform,) = self._decode_waveforms([audio_packed], audio_gain)
        return frames, waveform

    def _decode_waveforms(self, packed: list, audio_gain: float) -> list:
        """Each packed audio latent through the audio VAE and the vocoder,
        both placed once -> (2, samples) f32 on the host, gain applied and
        clipped to [-1, 1]."""
        vae = self._on_device("audio_vae")
        vocoder = self._on_device("vocoder")
        out = []
        with span("decode.audio"):
            for audio_packed in packed:
                latents = dit_av.unpack_audio_latents(audio_packed, channels=8,
                                                      mel=self.tcfg.audio_in_channels // 8)
                waveform = decode_audio(vae, vocoder, latents.to(vae.latents_mean.dtype))
                if audio_gain != 1.0:
                    waveform = torch.clamp(waveform * audio_gain, -1.0, 1.0)
                out.append(waveform[0].float().cpu().numpy())
        self._release("audio_vae")
        self._release("vocoder")
        return out

    @_one_clip
    @torch.inference_mode()
    def generate_video_with_audio(self, prompt: str, config: GenerationConfig,
                                  initial_noise, audio_noise, decode_noise=None,
                                  image_latent=None, cond_noise=None,
                                  audio_gain: float = 1.0, video_path: Optional[str] = None,
                                  video_frames=None, cond_frames: int = 9,
                                  on_progress=None) -> VideoGenerationResult:
        """Joint video + audio through the dual DiT: the audio lasts as long
        as the clip (num_frames / fps), round(seconds * 25) latent frames.
        T2V, or I2V when `image_latent` (see `encode_image`) or
        `config.image_path` is given; CFG with the negative prompt on both
        streams (STG is not defined on this path and is dropped).

        video_path / video_frames extend a clip with a soundtrack, as
        `generate_video_extension` extends one (its last cond_frames frames,
        8k + 1, the first latent frames conditioned); not with image
        conditioning. cond_frames=1 on a one-frame clip is I2V bit for bit.

        initial_noise: the video latent's shape, as `generate_video`'s;
        audio_noise: `audio_noise_shape(config)` standard normal, the raw
        (1, 8, T, mel) audio latent before packing; cond_noise (of the image
        latent's, or the clip's latent's shape) and decode_noise as
        `generate_video`'s. audio_gain scales the waveform, clipped to
        [-1, 1]. Returns frames (F, H, W, 3) in [0, 1] and audio (2,
        samples) in [-1, 1] on the host."""
        config.validate()
        self._require_audio()
        guidance = dataclasses.replace(GuidanceSpec.from_config(config), stg_scale=0.0)

        is_i2v = image_latent is not None or config.image_path is not None
        ext = video_path is not None or video_frames is not None
        if ext and is_i2v:
            raise InvalidConfigurationError(
                "clip-tail conditioning (video_path/video_frames) is mutually exclusive with "
                "image conditioning")
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(config.image_path, config.width,
                                                 config.height)
        cond_latent = None
        if image_latent is not None:
            cond_latent = image_latent.to(self.device, torch.float32)
        elif ext:
            self._check_cond_frames(cond_frames, config)
            video_frames = self._clip_frames(video_path, video_frames, config, cond_frames,
                                             "tail")
            cond_latent = self.encode_video(video_frames)
        prompt = self._maybe_enhance(prompt, config, is_i2v)
        v_ctx, a_ctx, bias = self._encode_text_with_audio(prompt, config, guidance)

        shape = self._shape(config)
        sigmas = self._sigmas(config, shape)
        video_latent = self._initial_latent(initial_noise, shape, "initial_noise") \
            * float(sigmas[0])
        audio_packed = self._audio_latent(audio_noise, config, "audio_noise") \
            * float(sigmas[0])
        conditioning_mask, k_lat = None, 1
        if cond_latent is not None:
            k_lat = cond_latent.shape[2]
            video_latent[:, :, :k_lat] = cond_latent
            conditioning_mask = self._conditioning_mask(shape, frames=k_lat)
            if ext and config.image_cond_noise_scale > 0:
                self._check_draws(cond_noise, len(sigmas) - 1, cond_latent, "cond_noise")

        video_latent, audio_packed = self._av_denoise(
            video_latent, audio_packed, sigmas, shape, guidance, v_ctx, a_ctx, bias,
            conditioning_mask, cond_latent, config, cond_noise, on_progress,
            cond_frames=k_lat)
        frames, audio = self._decode_av(video_latent, audio_packed, decode_noise, audio_gain)
        return VideoGenerationResult(frames=frames[: config.num_frames],
                                     timings=diagnostics.active(),
                                     seed=self._seed(config), audio=audio)

    @_one_clip
    @torch.inference_mode()
    def generate_video_with_audio_two_stage(
            self, prompt: str, config: GenerationConfig, stage1_noise, stage1_audio_noise,
            stage2_noise, stage2_audio_noise, decode_noise=None, image_latent=None,
            full_res_image_latent=None, stage1_cond_noise=None, stage2_cond_noise=None,
            audio_gain: float = 1.0, on_progress=None) -> VideoGenerationResult:
        """Two-stage joint video + audio: a half-resolution dual denoise on
        the distilled schedule -> the video latent upscaled 2x with AdaIN
        toward stage 1 (the audio is not upscaled) -> both re-noised -> a
        3-step full-resolution dual refine whose video steps are plain Euler
        -> decode both. No CFG or STG on either stage (one row a step).

        I2V: with config.image_path the image is encoded at half resolution
        for stage 1 and again at full resolution for stage 2; image_latent
        and full_res_image_latent are hooks that take the place of those
        encodes. stage1_noise / stage2_noise: the video latent's shape at
        half / full resolution; stage1_audio_noise: `audio_noise_shape`,
        the raw audio draw; stage2_audio_noise: the packed audio's shape
        (1, T, C_a), mixed as s * noise + (1 - s) * audio with s =
        STAGE_2_SIGMAS[0], as the video; stage{1,2}_cond_noise: per-step
        re-noise draws of each stage's image latent, when
        config.image_cond_noise_scale > 0."""
        config.validate()
        self._require_audio(upscaler=True)
        guidance = dataclasses.replace(GuidanceSpec.from_config(config, use_cfg=False),
                                       stg_scale=0.0)

        is_i2v = (config.image_path is not None or image_latent is not None
                  or full_res_image_latent is not None)
        if image_latent is None and config.image_path is not None:
            image_latent = self._encode_image_at(
                config.image_path, config.width // 2, config.height // 2)
        prompt = self._maybe_enhance(prompt, config, is_i2v)
        v_ctx, a_ctx, bias = self._encode_text_with_audio(prompt, config, guidance)

        # === stage 1: half resolution, always the distilled schedule ===
        s1_shape, s2_shape = self.stage_shapes(config)
        s1_sigmas = self.stage1_sigmas(config, s1_shape, audio=True)
        video_latent = self._initial_latent(stage1_noise, s1_shape, "stage1_noise") \
            * float(s1_sigmas[0])
        audio_packed = self._audio_latent(stage1_audio_noise, config, "stage1_audio_noise") \
            * float(s1_sigmas[0])
        s1_cond_mask = None
        if image_latent is not None:
            image_latent = image_latent.to(self.device, torch.float32)
            video_latent[:, :, :1] = image_latent
            s1_cond_mask = self._conditioning_mask(s1_shape)
        video_latent, audio_packed = self._av_denoise(
            video_latent, audio_packed, s1_sigmas, s1_shape, guidance, v_ctx, a_ctx, bias,
            s1_cond_mask, image_latent, config, stage1_cond_noise, on_progress)
        stage1_output = video_latent

        # === the video upscaled 2x, AdaIN toward stage 1; the audio as it is ===
        upscaler = self._on_device("upscaler")
        with span("upscale"):
            mean = self.vae_decoder.mean_of_means.to(self.device)
            std = self.vae_decoder.std_of_means.to(self.device)
            video_latent = adain_filter_latent(
                upsample_latents(upscaler, video_latent, mean, std), stage1_output)
            _sync(self.device)
        self._release("upscaler")

        # === stage 2: re-noise both, 3 full-resolution steps ===
        s2_sigmas = schedule.STAGE_2_SIGMAS
        noise_scale = float(s2_sigmas[0])
        video_latent = (noise_scale * self._initial_latent(stage2_noise, s2_shape,
                                                           "stage2_noise")
                        + (1.0 - noise_scale) * video_latent)
        if tuple(stage2_audio_noise.shape) != tuple(audio_packed.shape):
            raise ValueError(f"stage2_audio_noise {tuple(stage2_audio_noise.shape)} != "
                             f"{tuple(audio_packed.shape)}")
        audio_packed = (noise_scale * stage2_audio_noise.to(self.device, torch.float32)
                        + (1.0 - noise_scale) * audio_packed.float())
        if full_res_image_latent is None and config.image_path is not None:
            full_res_image_latent = self._encode_image_at(
                config.image_path, config.width, config.height)
        s2_cond_mask = None
        if full_res_image_latent is not None:
            full_res_image_latent = full_res_image_latent.to(self.device, torch.float32)
            video_latent[:, :, :1] = full_res_image_latent
            s2_cond_mask = self._conditioning_mask(s2_shape)
        video_latent, audio_packed = self._av_denoise(
            video_latent, audio_packed, s2_sigmas, s2_shape, guidance, v_ctx, a_ctx, bias,
            s2_cond_mask, full_res_image_latent, config, stage2_cond_noise,
            on_progress, video_euler="plain")

        frames, audio = self._decode_av(video_latent, audio_packed, decode_noise, audio_gain)
        return VideoGenerationResult(frames=frames[: config.num_frames],
                                     timings=diagnostics.active(),
                                     seed=self._seed(config), audio=audio)

    @_one_clip
    @torch.inference_mode()
    def generate_video_chain_with_audio(
            self, prompt: str, config: GenerationConfig, segments: int, initial_noise,
            audio_noise, cond_frames: int = 9, prompts=None, decode_noise=None,
            cond_noise=None, audio_cond_noise=None, audio_gain: float = 1.0,
            audio_cond: bool = False, anchors=None, on_progress=None) -> VideoGenerationResult:
        """`generate_video_chain` with a soundtrack: each segment runs the
        dual DiT as `generate_video_with_audio` does (segments=1 is that
        entry point bit for bit), the video tail carried in latent space;
        the segments' waveforms are joined with a linear crossfade over the
        trimmed overlap, round(samples * cond_frames / num_frames) samples.

        audio_cond=True also carries the previous segment's audio tail: its
        last k_a = max(1, round(audio frames * cond_frames / num_frames))
        packed audio frames condition the next segment's first k_a (timestep
        0, re-noised from the clean tail when config.image_cond_noise_scale
        > 0, carried through the audio Euler). anchors: as
        `generate_video_chain`'s. No tail renormalisation on this path.

        Draws, one entry per segment: initial_noise, audio_noise (as
        `generate_video_with_audio`'s), decode_noise (optional), cond_noise
        (as `generate_video_chain`'s) and audio_cond_noise (with audio_cond
        and config.image_cond_noise_scale > 0, for every segment after the
        first one draw a step of shape (1, k_a, C_a); None for segment 0)."""
        config.validate()
        self._require_audio()
        segments = int(segments)
        self._check_chain(segments, cond_frames, prompts, config)
        k_lat = (cond_frames - 1) // 8 + 1
        af = self.audio_frames(config)
        k_a = self.audio_overlap_frames(config, cond_frames) if audio_cond else 0
        if audio_cond and k_a >= af:
            raise InvalidConfigurationError(
                f"audio overlap {k_a} >= audio_frames {af} (cond_frames too close to "
                "num_frames for audio_cond)")
        initial_noise = self._per_segment(initial_noise, segments, "initial_noise")
        audio_noise = self._per_segment(audio_noise, segments, "audio_noise")
        decode_noise = self._per_segment(decode_noise, segments, "decode_noise", required=False)
        cond_noise = self._per_segment(cond_noise, segments, "cond_noise", required=False)
        audio_cond_noise = self._per_segment(audio_cond_noise, segments, "audio_cond_noise",
                                             required=False)
        guidance = dataclasses.replace(GuidanceSpec.from_config(config), stg_scale=0.0)
        seg_prompts = list(prompts) if prompts is not None else [prompt] * segments
        anchor_enc = self._encode_chain_anchors(anchors, segments, k_lat, config)
        encoded, neg = self._encode_chain_prompts(seg_prompts, config, guidance,
                                                  need_audio=True)
        contexts = [self._av_contexts(guidance, encoded[p], neg) for p in seg_prompts]

        shape = self._shape(config)
        sigmas = self._sigmas(config, shape)
        n_steps = len(sigmas) - 1
        scale = config.image_cond_noise_scale
        seg_latents, tail, audio_tail = [], None, None
        for i in range(segments):
            video_latent = self._initial_latent(initial_noise[i], shape,
                                                f"initial_noise[{i}]") * float(sigmas[0])
            audio_packed = self._audio_latent(audio_noise[i], config,
                                              f"audio_noise[{i}]") * float(sigmas[0])
            sets, cm, c_lat, cf, idx = self._chain_segment_conditioning(
                i, shape, k_lat, tail, anchor_enc.get(i))
            for where, value in sets:
                video_latent[:, :, where] = value
            seg_k_a = k_a if i > 0 else 0
            if seg_k_a:
                audio_packed[:, :seg_k_a] = audio_tail
            if cm is not None and scale > 0:
                self._check_draws(cond_noise[i], n_steps, c_lat, f"cond_noise[{i}]")
            if seg_k_a and scale > 0:
                self._check_draws(audio_cond_noise[i], n_steps, audio_tail,
                                  f"audio_cond_noise[{i}]")
            v_ctx, a_ctx, bias = contexts[i]
            video_latent, audio_packed = self._av_denoise(
                video_latent, audio_packed, sigmas, shape, guidance, v_ctx, a_ctx, bias, cm,
                c_lat, config, cond_noise[i],
                self._chain_progress(on_progress, i, n_steps, segments), cond_frames=cf,
                cond_frame_idx=idx, audio_cond_frames=seg_k_a,
                audio_conditioned_latent=audio_tail if seg_k_a and scale > 0 else None,
                audio_cond_noise=audio_cond_noise[i])
            tail = video_latent[:, :, -k_lat:].float()
            if audio_cond:
                audio_tail = audio_packed[:, -k_a:].float()
            seg_latents.append((video_latent, audio_packed))

        self._release("av_transformer")
        parts = []
        for i, (video_latent, _) in enumerate(seg_latents):
            frames = self._decode_frames(video_latent, decode_noise[i],
                                         release=i == segments - 1)[: config.num_frames]
            parts.append(frames if i == 0 else frames[cond_frames:])
        waves = self._decode_waveforms([a for _, a in seg_latents], audio_gain)
        return VideoGenerationResult(frames=np.concatenate(parts, axis=0),
                                     timings=diagnostics.active(),
                                     seed=self._seed(config),
                                     audio=crossfade(waves, cond_frames, config.num_frames))


def crossfade(waves: list, cond_frames: int, num_frames: int) -> np.ndarray:
    """Join a chain's (2, samples) waveforms: each next one overlaps the
    joined audio by k = round(samples * cond_frames / num_frames) samples
    (at most either's length), blended by a linear ramp from 0 to 1 (k
    steps, the end excluded) in float32."""
    audio = waves[0]
    for w in waves[1:]:
        s = w.shape[-1]
        k = min(int(round(s * cond_frames / num_frames)), audio.shape[-1], s)
        if k > 0:
            ramp = np.linspace(0.0, 1.0, k, endpoint=False, dtype=np.float32)
            blended = audio[..., -k:] * (1.0 - ramp) + w[..., :k] * ramp
            audio = np.concatenate([audio[..., :-k], blended, w[..., k:]], axis=-1)
        else:
            audio = np.concatenate([audio, w], axis=-1)
    return audio
