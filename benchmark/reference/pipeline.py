"""The reference generation: prompt and noise -> frames (and a waveform), in
float32 with TF32 off, or under the fp8 control.

T2V with one guidance row (cfg 1): byte tokens, Gemma-3's hidden states,
the connector(s), the distilled sigmas shifted by the token count, the DiT
(or the dual DiT) and the Euler step per sigma, the tiled VAE decode, and
for audio the plain audio Euler, the audio VAE and the vocoder.
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


def build(config: dict, weights: dict, precision: str = "f32") -> dict:
    """The reference's modules for `config`, holding `weights`
    ({component: {parameter name: tensor}}), in `precision`."""
    audio = config["pipeline"] == "audio_video"
    tcfg = transformer_dims(config["transformer"])
    modules = {
        "gemma": text.Gemma(config["gemma"]),
        "text_encoder": text.TextEncoder(config["text_encoder"], include_audio=audio),
        "vae_decoder": decoders.VideoDecoder(config["vae"]),
    }
    if audio:
        modules["av_transformer"] = dit.AVDiT(tcfg)
        modules["audio_vae"] = decoders.AudioVAE(config["audio_vae"])
        modules["vocoder"] = decoders.Vocoder(config["vocoder"])
    else:
        modules["transformer"] = dit.VideoDiT(tcfg)
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


@torch.inference_mode()
def generate(modules: dict, config: dict, traffic: dict, prompt: str, noise,
             audio_noise=None) -> dict:
    """{"frames": (F, H, W, 3) float32 in [0, 1], "audio": (2, samples) or
    None} on the host, for one clip of `traffic`'s shape."""
    with full_f32():
        return _generate(modules, config, traffic, prompt, noise, audio_noise)


def _generate(modules, config, traffic, prompt, noise, audio_noise):
    g, te = config["gemma"], config["text_encoder"]
    tcfg = transformer_dims(config["transformer"])
    device = noise.device
    ids, mask = text.byte_tokens(prompt, g["vocab_size"], te["max_length"])
    hidden = modules["gemma"].hidden_states(ids, mask)
    enc = modules["text_encoder"](hidden, mask)
    del hidden
    bias = torch.zeros(1, 1, 1, enc["video"].shape[1], device=device)

    frames_l, height_l, width_l = noise.shape[2:]
    sigmas = distilled_sigmas(frames_l * height_l * width_l)
    latent = noise.float() * float(sigmas[0])
    fps = traffic["fps"]
    one = torch.ones(1, dtype=torch.float32, device=device)
    audio = None
    if config["pipeline"] == "audio_video":
        model = modules["av_transformer"]
        ropes = dit.av_ropes(tcfg, frames_l, height_l, width_l, audio_noise.shape[2], fps,
                             device)
        audio = audio_noise.float().transpose(1, 2).reshape(1, audio_noise.shape[2], -1) \
            * float(sigmas[0])
        for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            v_vel, a_vel = model(patchify(latent), audio, enc["video"], enc["audio"],
                                 one * float(sigma), one * float(sigma), ropes, bias)
            latent = euler_step(latent, unpatchify(v_vel, latent.shape), float(sigma),
                                float(sigma_next))
            dt = torch.tensor(float(sigma_next), dtype=torch.float32, device=device) \
                - torch.tensor(float(sigma), dtype=torch.float32, device=device)
            audio = audio + dt * a_vel
    else:
        model = modules["transformer"]
        rope = dit.video_rope(tcfg, frames_l, height_l, width_l, fps, device)
        for sigma, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            vel = model(patchify(latent), enc["video"], one * float(sigma), rope, bias)
            latent = euler_step(latent, unpatchify(vel, latent.shape), float(sigma),
                                float(sigma_next))
    decode = config["decode"]
    frames = decoders.decode_frames(modules["vae_decoder"], latent, decode["tile"],
                                    decode["overlap"])
    wave = None
    if audio is not None:
        mel = modules["audio_vae"](audio)
        wave = modules["vocoder"](mel)[0].cpu().numpy()
    return {"frames": frames[: traffic["frames"]], "audio": wave}


def clip_shapes(config: dict, traffic: dict) -> dict:
    """The draws of one clip: the video latent noise (1, C, F', H', W') and,
    for audio, the raw audio latent (1, 8, T_a, mel latent bins)."""
    t = config["transformer"]
    shapes = {"noise": (1, t["in_channels"], (traffic["frames"] - 1) // 8 + 1,
                        traffic["height"] // 32, traffic["width"] // 32)}
    if config["pipeline"] == "audio_video":
        a = config["audio_vae"]
        shapes["audio_noise"] = (1, a["latent_channels"],
                                 audio_frame_count(traffic["frames"], traffic["fps"]),
                                 t["audio_in_channels"] // a["latent_channels"])
    return shapes

