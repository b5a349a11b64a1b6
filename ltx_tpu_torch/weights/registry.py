"""Which component files a models directory holds.

Port of ltx_tpu/weights/registry.py's status checks: `component_inventory`
(each component's subdirectory and expected files, the layout of
`download.download_all_components`), `missing_files` and `is_downloaded`.
The reference's `recommended_model` sizes the model by a TPU chip's memory
and is not ported (ROADMAP A9).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ltx_tpu_torch.config import LTXModel
from ltx_tpu_torch.weights.download import (
    AUDIO_VAE_FILE,
    CONNECTOR_FILE,
    DISTILLED_LORA_FILE,
    UPSCALER_FILE,
    VAE_CONFIG,
    VAE_FILE,
    VOCODER_FILE,
    default_models_dir,
)


def component_inventory(model: LTXModel = LTXModel.DISTILLED
                        ) -> Dict[str, Tuple[str, List[str]]]:
    """{component: (subdirectory, expected file names)}."""
    fn = Path
    return {
        "gemma": ("vlm-gemma", ["config.json", "tokenizer.json"]),
        "unified": (f"ltx-{model.value}", [model.unified_weights_filename]),
        "connector": ("ltx-connector", [fn(CONNECTOR_FILE).name]),
        "vae": ("ltx-vae", [fn(VAE_FILE).name, fn(VAE_CONFIG).name]),
        "upscaler": ("ltx-upscaler", [fn(UPSCALER_FILE).name]),
        "distilled_lora": ("ltx-lora", [fn(DISTILLED_LORA_FILE).name]),
        "audio_vae": ("ltx-audio-vae", [fn(AUDIO_VAE_FILE).name]),
        "vocoder": ("ltx-vocoder", [fn(VOCODER_FILE).name]),
    }


def missing_files(component: str, models_dir: Optional[str] = None,
                  model: LTXModel = LTXModel.DISTILLED) -> List[str]:
    """The component's expected files that are absent."""
    subdir, files = component_inventory(model)[component]
    base = Path(models_dir or default_models_dir()) / subdir
    missing = [f for f in files if not (base / f).exists()]
    if component == "gemma" and not missing:
        # a sharded snapshot has no fixed file name
        if not any(base.glob("*.safetensors")):
            missing.append("*.safetensors")
    return missing


def is_downloaded(component: str, models_dir: Optional[str] = None,
                  model: LTXModel = LTXModel.DISTILLED) -> bool:
    return not missing_files(component, models_dir, model)
