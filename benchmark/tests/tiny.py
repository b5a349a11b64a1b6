"""Tiny configurations of the benchmark's configurations, for CPU tests: the
port's test sizes (two DiT blocks, a 7-layer Gemma) with the full-size
configurations' structure and init rules."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.traffic import Traffic

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def tiny_config(name: str) -> dict:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["transformer"].update(num_layers=2, num_heads=4, head_dim=32, in_channels=16,
                              out_channels=16, cross_attention_dim=128, caption_channels=64)
    if "audio_vae" in cfg:
        cfg["transformer"].update(audio_num_heads=4, audio_head_dim=16, audio_in_channels=16,
                                  audio_out_channels=16)
        cfg["audio_vae"].update(base_channels=16, num_res_blocks=0, mel_bins=8,
                                mel_latent_bins=2)
        cfg["vocoder"].update(in_channels=16, hidden_channels=32, upsample_factors=[2, 2],
                              upsample_kernels=[4, 4], resnet_kernels=[3],
                              resnet_dilations=[[1, 3]])
    cfg["gemma"].update(hidden_size=64, hidden_layers=7, intermediate_size=128,
                        attention_heads=4, head_dim=16, vocab_size=256, kv_heads=2,
                        query_pre_attn_scalar=16.0, sliding_window=4, sliding_window_pattern=3)
    cfg["text_encoder"].update(hidden_dim=64, num_gemma_layers=8, connector_heads=4,
                               connector_head_dim=16, num_registers=4, max_length=16)
    cfg["vae"].update(latent_channels=16, base_channels=64, blocks_per_group=1)
    cfg["decode"] = {"tile": 3, "overlap": 2}
    return cfg


def tiny_traffic() -> Traffic:
    """33 frames at 64x64: 5 latent frames, decoded in two overlapping tiles."""
    return Traffic("tiny", {"frames": 33, "height": 64, "width": 64, "fps": 24.0, "steps": 8,
                            "cfg_scale": 1.0, "prompt_words": [1, 3],
                            "words": ["a", "beaver", "river", "dam"]})
