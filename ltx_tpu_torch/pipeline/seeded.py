"""The seeded front of the pipeline: the reference's entry points, called by
prompt, config and seed.

The port's `LTXPipeline` takes every random draw as a tensor argument.
`SeededPipeline(pipe)` has the reference's call signatures for the entry
points the server and the CLI call, and draws each tensor the port's method
needs from one `torch.Generator(device=pipe.device)` seeded with
`config.seed` (the time when it is None, as the pipeline reports it). Every
other attribute (`gemma`, `tokenizer`, `upscaler`, `device`, ...) is the
pipeline's.

Order of the draws (each `torch.randn` of float32 on the pipeline's device,
at the shape the port's method checks):
  1. the initial latent noise (stage 1's, at half size, for two-stage);
  2. with audio, the raw audio latent noise (`audio_noise_shape`);
  3. when the clip has conditioned frames (I2V, extension, keyframes) and
     config.image_cond_noise_scale > 0, one re-noise draw a denoise step of
     the conditioned latent's shape;
  4. two-stage: stage 2's latent noise, with audio its packed audio noise,
     then stage 2's re-noise draws as in 3;
  5. with a timestep-conditioned VAE decoder, one decode-noise tensor a
     decode tile (`decode_noise_shapes`).
A chain draws 1-3 segment by segment (then the audio tail's re-noise draws
of that segment, with audio_cond), and 5 for every segment after all of
them. `generate_videos` draws row i from its own generator seeded with
seeds[i], so row i's noise is a solo call's at that seed.

Deviation by design: these are not jax.random's numbers, so a seed gives
other frames than the reference gives for it. The same seed on the same
device gives the same frames, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ltx_tpu_torch.config import GenerationConfig
from ltx_tpu_torch.ops.latents import VideoLatentShape


class _Draws:
    """One generator's stream of standard normal draws."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def steps(self, n: int, shape) -> list:
        return [self.normal(shape) for _ in range(n)]

    def each(self, shapes) -> Optional[list]:
        return [self.normal(s) for s in shapes] or None


class SeededPipeline:
    """`pipe` behind the reference's seeded entry points."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    # -- seeds and shapes ------------------------------------------------

    def _seeded(self, config: GenerationConfig):
        """(config with its seed fixed, the draws of that seed)."""
        seed = config.seed if config.seed is not None else int(time.time())
        config = dataclasses.replace(config, seed=seed)
        return config, _Draws(seed, self.pipe.device)

    def _steps(self, config: GenerationConfig, shape: VideoLatentShape) -> int:
        return len(self.pipe._sigmas(config, shape)) - 1

    def _renoise(self, draws: _Draws, config: GenerationConfig, steps: int,
                 frames: Optional[int]) -> Optional[list]:
        """The re-noise draws of a conditioned latent of `frames` latent
        frames, when the config re-noises (None otherwise)."""
        if not frames or config.image_cond_noise_scale <= 0:
            return None
        return draws.steps(steps, self.pipe.cond_latent_shape(config, frames))

    @staticmethod
    def _clip_frames(config: GenerationConfig, cond_frames: int) -> int:
        """Latent frames of a clip's last `cond_frames` pixel frames."""
        return VideoLatentShape.from_pixels(1, cond_frames, config.height, config.width).frames

    # -- one clip ----------------------------------------------------------

    def generate_video(self, prompt: str, config: GenerationConfig, on_progress=None,
                       image_latent=None, precomputed_embeddings=None, initial_noise=None,
                       checkpoint=None):
        """T2V, or I2V through `image_latent` or config.image_path."""
        config, draws = self._seeded(config)
        shape = self.pipe._shape(config)
        noise = draws.normal(shape.shape)
        if initial_noise is not None:
            noise = torch.as_tensor(initial_noise)
        i2v = image_latent is not None or config.image_path is not None
        cond = self._renoise(draws, config, self._steps(config, shape), 1 if i2v else None)
        return self.pipe.generate_video(
            prompt, config, noise, decode_noise=draws.each(self.pipe.decode_noise_shapes(shape)),
            image_latent=image_latent, cond_noise=cond, on_progress=on_progress,
            precomputed_embeddings=precomputed_embeddings, checkpoint=checkpoint)

    def generate_videos(self, prompts, config: GenerationConfig, seeds=None) -> list:
        """B prompts through one batched denoise; row i drawn from seeds[i]
        (default config.seed + i)."""
        prompts = list(prompts)
        if seeds is None:
            base = config.seed if config.seed is not None else int(time.time())
            seeds = [base + i for i in range(len(prompts))]
        if len(seeds) != len(prompts):
            raise ValueError(f"{len(seeds)} seeds for {len(prompts)} prompts")
        shape = self.pipe._shape(config)
        noise, decode = [], []
        for seed in seeds:
            draws = _Draws(seed, self.pipe.device)
            noise.append(draws.normal(shape.shape))
            decode.append(draws.each(self.pipe.decode_noise_shapes(shape)))
        if not prompts:
            return []
        return self.pipe.generate_videos(
            prompts, config, torch.cat(noise, dim=0), seeds=list(seeds),
            decode_noise=decode if any(d is not None for d in decode) else None)

    def generate_video_two_stage(self, prompt: str, config: GenerationConfig, on_progress=None,
                                 image_latent=None, full_res_image_latent=None):
        config, draws = self._seeded(config)
        s1, s2 = self.pipe.stage_shapes(config)
        i2v = config.image_path is not None
        stage1 = draws.normal(s1.shape)
        c1 = self._stage_renoise(draws, config, s1, i2v or image_latent is not None)
        stage2 = draws.normal(s2.shape)
        c2 = self._stage_renoise(draws, config, s2, i2v or full_res_image_latent is not None,
                                 stage=2)
        return self.pipe.generate_video_two_stage(
            prompt, config, stage1, stage2,
            decode_noise=draws.each(self.pipe.decode_noise_shapes(s2)),
            image_latent=image_latent, full_res_image_latent=full_res_image_latent,
            stage1_cond_noise=c1, stage2_cond_noise=c2, on_progress=on_progress)

    def _stage_renoise(self, draws: _Draws, config: GenerationConfig,
                       shape: VideoLatentShape, conditioned: bool, stage: int = 1,
                       audio: bool = False):
        """A two-stage stage's re-noise draws of its one-frame image latent,
        one a step of its schedule (stage 2: STAGE_2_SIGMAS)."""
        if not conditioned or config.image_cond_noise_scale <= 0:
            return None
        from ltx_tpu_torch.ops import schedule

        sigmas = self.pipe.stage1_sigmas(config, shape, audio=audio) if stage == 1 \
            else schedule.STAGE_2_SIGMAS
        return draws.steps(len(sigmas) - 1, dataclasses.replace(shape, frames=1).shape)

    # -- long video -------------------------------------------------------

    def generate_video_from_video(self, prompt: str, config: GenerationConfig,
                                  video_path: Optional[str] = None, video_frames=None,
                                  strength: float = 0.6, on_progress=None):
        config, draws = self._seeded(config)
        shape = self.pipe._shape(config)
        noise = draws.normal(shape.shape)
        return self.pipe.generate_video_from_video(
            prompt, config, noise, video_path=video_path, video_frames=video_frames,
            strength=strength, decode_noise=draws.each(self.pipe.decode_noise_shapes(shape)),
            on_progress=on_progress)

    def generate_video_extension(self, prompt: str, config: GenerationConfig,
                                 video_path: Optional[str] = None, video_frames=None,
                                 cond_frames: int = 9, on_progress=None):
        config, draws = self._seeded(config)
        shape = self.pipe._shape(config)
        noise = draws.normal(shape.shape)
        cond = self._renoise(draws, config, self._steps(config, shape),
                             self._clip_frames(config, cond_frames))
        return self.pipe.generate_video_extension(
            prompt, config, noise, video_path=video_path, video_frames=video_frames,
            cond_frames=cond_frames, decode_noise=draws.each(self.pipe.decode_noise_shapes(shape)),
            cond_noise=cond, on_progress=on_progress)

    def generate_video_keyframes(self, prompt: str, config: GenerationConfig, keyframes,
                                 on_progress=None, audio: bool = False,
                                 audio_gain: float = 1.0):
        config, draws = self._seeded(config)
        shape = self.pipe._shape(config)
        noise = draws.normal(shape.shape)
        audio_noise = draws.normal(self.pipe.audio_noise_shape(config)) if audio else None
        cond = self._renoise(draws, config, self._steps(config, shape), len(keyframes))
        return self.pipe.generate_video_keyframes(
            prompt, config, keyframes, noise, audio_noise=audio_noise,
            decode_noise=draws.each(self.pipe.decode_noise_shapes(shape)), cond_noise=cond,
            audio=audio, audio_gain=audio_gain, on_progress=on_progress)

    def _chain_draws(self, draws: _Draws, config: GenerationConfig, segments: int,
                     cond_frames: int, anchors, audio: bool = False,
                     audio_cond: bool = False):
        """Per segment: its noise, audio noise, re-noise draws and audio
        re-noise draws; then every segment's decode noise."""
        shape = self.pipe._shape(config)
        steps = self._steps(config, shape)
        frames = self.pipe.chain_cond_frames(segments, cond_frames, anchors)
        k_a = self.pipe.audio_overlap_frames(config, cond_frames) if audio_cond else 0
        renoise = config.image_cond_noise_scale > 0
        noise, audio_noise, cond, audio_cond_noise = [], [], [], []
        for i in range(segments):
            noise.append(draws.normal(shape.shape))
            if audio:
                audio_noise.append(draws.normal(self.pipe.audio_noise_shape(config)))
            cond.append(self._renoise(draws, config, steps, frames[i]))
            audio_cond_noise.append(
                draws.steps(steps, self.pipe.packed_audio_shape(config, k_a))
                if i and k_a and renoise else None)
        decode = [draws.each(self.pipe.decode_noise_shapes(shape)) for _ in range(segments)]
        return noise, audio_noise, cond, audio_cond_noise, decode

    def generate_video_chain(self, prompt: str, config: GenerationConfig, segments: int,
                             cond_frames: int = 9, prompts=None, on_progress=None,
                             precomputed_embeddings=None, anchors=None,
                             tail_renorm: float = 0.0):
        config, draws = self._seeded(config)
        segments = int(segments)
        noise, _, cond, _, decode = self._chain_draws(draws, config, max(segments, 0),
                                                      cond_frames, anchors)
        return self.pipe.generate_video_chain(
            prompt, config, segments, noise, cond_frames=cond_frames, prompts=prompts,
            decode_noise=decode, cond_noise=cond,
            precomputed_embeddings=precomputed_embeddings, anchors=anchors,
            tail_renorm=tail_renorm, on_progress=on_progress)

    # -- joint audio -------------------------------------------------------

    def generate_video_with_audio(self, prompt: str, config: GenerationConfig,
                                  on_progress=None, image_latent=None, audio_gain: float = 1.0,
                                  video_path: Optional[str] = None, video_frames=None,
                                  cond_frames: int = 9):
        """T2V or I2V with audio; video_path / video_frames extend a clip
        with a soundtrack."""
        config, draws = self._seeded(config)
        shape = self.pipe._shape(config)
        noise = draws.normal(shape.shape)
        audio_noise = draws.normal(self.pipe.audio_noise_shape(config))
        if video_path is not None or video_frames is not None:
            frames = self._clip_frames(config, cond_frames)
        else:
            frames = 1 if image_latent is not None or config.image_path is not None else None
        cond = self._renoise(draws, config, self._steps(config, shape), frames)
        return self.pipe.generate_video_with_audio(
            prompt, config, noise, audio_noise,
            decode_noise=draws.each(self.pipe.decode_noise_shapes(shape)),
            image_latent=image_latent, cond_noise=cond, audio_gain=audio_gain,
            video_path=video_path, video_frames=video_frames, cond_frames=cond_frames,
            on_progress=on_progress)

    def generate_video_with_audio_two_stage(self, prompt: str, config: GenerationConfig,
                                            on_progress=None, audio_gain: float = 1.0):
        config, draws = self._seeded(config)
        s1, s2 = self.pipe.stage_shapes(config)
        i2v = config.image_path is not None
        stage1 = draws.normal(s1.shape)
        stage1_audio = draws.normal(self.pipe.audio_noise_shape(config))
        c1 = self._stage_renoise(draws, config, s1, i2v, audio=True)
        stage2 = draws.normal(s2.shape)
        stage2_audio = draws.normal(self.pipe.packed_audio_shape(config))
        c2 = self._stage_renoise(draws, config, s2, i2v, stage=2, audio=True)
        return self.pipe.generate_video_with_audio_two_stage(
            prompt, config, stage1, stage1_audio, stage2, stage2_audio,
            decode_noise=draws.each(self.pipe.decode_noise_shapes(s2)),
            stage1_cond_noise=c1, stage2_cond_noise=c2, audio_gain=audio_gain,
            on_progress=on_progress)

    def generate_video_chain_with_audio(self, prompt: str, config: GenerationConfig,
                                        segments: int, cond_frames: int = 9, prompts=None,
                                        audio_gain: float = 1.0, on_progress=None,
                                        audio_cond: bool = False, anchors=None):
        config, draws = self._seeded(config)
        segments = int(segments)
        noise, audio_noise, cond, audio_cond_noise, decode = self._chain_draws(
            draws, config, max(segments, 0), cond_frames, anchors, audio=True,
            audio_cond=audio_cond)
        return self.pipe.generate_video_chain_with_audio(
            prompt, config, segments, noise, audio_noise, cond_frames=cond_frames,
            prompts=prompts, decode_noise=decode, cond_noise=cond,
            audio_cond_noise=audio_cond_noise, audio_gain=audio_gain,
            audio_cond=audio_cond, anchors=anchors, on_progress=on_progress)
