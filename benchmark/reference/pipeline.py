"""The reference generation's shared steps, in float32 with TF32 off, or
under the fp8 control; each pipeline's own steps are in its file under
`reference/paths/`, which calls these.

Byte tokens, Gemma-3's hidden states and the connector(s); the distilled
sigmas shifted by the token count; one Euler loop of the DiT or of the dual
DiT, one guidance row (cfg 1); the tiled VAE decode.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import decoders, dit, text
from benchmark.reference.layers import (
    assign,
    distilled_sigmas,
    euler_step,
    patchify,
    set_precision,
    unpatchify,
)


def transformer_dims(t: dict) -> dict:
    """The DiT config with its derived widths."""
    out = dict(t)
    out["inner_dim"] = t["num_heads"] * t["head_dim"]
    out["ffn_dim"] = out["inner_dim"] * t["ffn_mult"]
    if "audio_num_heads" in t:
        out["audio_inner_dim"] = t["audio_num_heads"] * t["audio_head_dim"]
    return out


def audio_frame_count(num_frames: int, fps: float) -> int:
    """round(seconds * 16000 / 160 / 4): 25 audio latent frames a second."""
    return int(round(num_frames / fps * 16000 / 160 / 4))


def video_latent_shape(config: dict, traffic: dict) -> tuple:
    """The video latent (1, C, F', H', W') of a clip of `traffic`'s size."""
    return (1, config["transformer"]["in_channels"], (traffic["frames"] - 1) // 8 + 1,
            traffic["height"] // 32, traffic["width"] // 32)


def video_tokens(traffic: dict) -> int:
    """The DiT's video tokens of a clip of `traffic`'s size: F' H' W'."""
    return ((traffic["frames"] - 1) // 8 + 1) * (traffic["height"] // 32) \
        * (traffic["width"] // 32)


def text_and_decoder(config: dict, include_audio: bool) -> dict:
    """The reference's Gemma, text encoder (with the audio connector when
    `include_audio`) and VAE decoder of `config`, without weights."""
    return {
        "gemma": text.Gemma(config["gemma"]),
        "text_encoder": text.TextEncoder(config["text_encoder"], include_audio=include_audio),
        "vae_decoder": decoders.VideoDecoder(config["vae"]),
    }


def hold(modules: dict, weights: dict, precision: str) -> dict:
    """`modules` holding `weights` ({component: {parameter name: tensor}}),
    in `precision`."""
    for name, module in modules.items():
        set_precision(assign(module, weights[name]), precision)
    return modules


@contextlib.contextmanager
def full_f32():
    """float32 products and convolutions in full float32 (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encode_text(modules: dict, config: dict, prompt: str, device) -> tuple:
    """(the text encoder's outputs {"video"[, "audio"]}, the all-zero key
    bias) of `prompt`: byte tokens, Gemma-3's hidden states, the connector(s)."""
    g, te = config["gemma"], config["text_encoder"]
    ids, mask = text.byte_tokens(prompt, g["vocab_size"], te["max_length"])
    hidden = modules["gemma"].hidden_states(ids, mask)
    enc = modules["text_encoder"](hidden, mask)
    del hidden
    return enc, torch.zeros(1, 1, 1, enc["video"].shape[1], device=device)


def denoise_video(model, tcfg: dict, latent, context, bias, sigmas, fps: float):
    """The latent after one Euler step of the DiT per sigma (`sigmas`, the
    first the latent's own)."""
    device = latent.device
    one = torch.ones(1, dtype=torch.float32, device=device)
    frames_l, height_l, width_l = latent.shape[2:]
    rope = dit.video_rope(tcfg, frames_l, height_l, width_l, fps, device)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        vel = model(patchify(latent), context, one * float(sigma), rope, bias)
        latent = euler_step(latent, unpatchify(vel, latent.shape), float(sigma),
                            float(sigma_next))
    return latent


def denoise_av(model, tcfg: dict, latent, audio, enc: dict, bias, sigmas, fps: float):
    """(latent, audio tokens) after one Euler step of the dual DiT per sigma."""
    device = latent.device
    one = torch.ones(1, dtype=torch.float32, device=device)
    frames_l, height_l, width_l = latent.shape[2:]
    ropes = dit.av_ropes(tcfg, frames_l, height_l, width_l, audio.shape[1], fps, device)
    for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        v_vel, a_vel = model(patchify(latent), audio, enc["video"], enc["audio"],
                             one * float(sigma), one * float(sigma), ropes, bias)
        latent = euler_step(latent, unpatchify(v_vel, latent.shape), float(sigma),
                            float(sigma_next))
        dt = torch.tensor(float(sigma_next), dtype=torch.float32, device=device) \
            - torch.tensor(float(sigma), dtype=torch.float32, device=device)
        audio = audio + dt * a_vel
    return latent, audio


def initial_latent(noise):
    """(the noised latent, the distilled sigmas shifted by its token count)."""
    frames_l, height_l, width_l = noise.shape[2:]
    sigmas = distilled_sigmas(frames_l * height_l * width_l)
    return noise.float() * float(sigmas[0]), sigmas


def decode(modules: dict, config: dict, latent, num_frames: int):
    """The frames (F, H, W, 3), float32 in [0, 1] on the host: the tiled VAE
    decode, cut to `num_frames`."""
    d = config["decode"]
    frames = decoders.decode_frames(modules["vae_decoder"], latent, d["tile"], d["overlap"])
    return frames[:num_frames]
