"""Which component files a models directory holds.

Port of ltx_tpu/weights/registry.py: `component_inventory` (each
component's subdirectory and expected files, the layout of
`download.download_all_components`), `missing_files`, `is_downloaded`, and
`recommended_model`, which sizes the model by the devices' memory, here an
H100's 80 GB read with torch.cuda, not a TPU chip's 15.5 GB.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

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

# the 19B checkpoint's transformer in bf16 (with the audio stream) and its
# activations, in GB: the reference's figure
_BF16_19B_GB = 38.0


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


def recommended_model(n_devices: Optional[int] = None,
                      memory_per_device_gb: Optional[float] = None,
                      ) -> Tuple[LTXModel, Optional[str]]:
    """(model, transformer quantization or None) for the devices at hand,
    the reference's rule: the dev model in bf16 when the devices' memory
    together clears 1.25 x 38 GB, else the distilled model in int4. The
    count and each device's memory default to the CUDA devices' (device 0's
    total memory; none without CUDA)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    if memory_per_device_gb is None:
        memory_per_device_gb = (torch.cuda.get_device_properties(0).total_memory / 1e9
                                if n_devices else 0.0)
    if n_devices * memory_per_device_gb >= _BF16_19B_GB * 1.25:
        return LTXModel.DEV, None
    return LTXModel.DISTILLED, "int4"
