"""The reference's per-component weight layout, resolved on the local disk.

Port of ltx_tpu/weights/download.py without the downloads: nothing here
opens a network connection. `download_all_components` keeps the
reference's name, signature and layout (one subdirectory per component
under the models directory, the hub's file names flattened into it) and
returns the paths the reference's skip-if-exists download returns when
every file is already there; a missing file raises the reference's
DownloadFailedError naming the hub repository and file, to be fetched by
other means. `load_safetensors` reads through the port's own reader.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ltx_tpu_torch.config import LTXModel
from ltx_tpu_torch.errors import DownloadFailedError
from ltx_tpu_torch.weights import safetensors_io

# the component files on the Hugging Face hub
LTX_REPO = "Lightricks/LTX-2"
GEMMA_REPO = "mlx-community/gemma-3-12b-it-qat-4bit"
CONNECTOR_FILE = "connectors/diffusion_pytorch_model.safetensors"
VAE_FILE = "vae/diffusion_pytorch_model.safetensors"
VAE_CONFIG = "vae/config.json"
UPSCALER_FILE = "latent_upsampler/diffusion_pytorch_model.safetensors"
DISTILLED_LORA_FILE = "ltx-2-19b-distilled-lora-384.safetensors"
AUDIO_VAE_FILE = "audio_vae/diffusion_pytorch_model.safetensors"
VOCODER_FILE = "vocoder/diffusion_pytorch_model.safetensors"


def default_models_dir() -> str:
    return os.environ.get(
        "LTX_MODELS_DIR", os.path.join(os.path.expanduser("~"), ".cache", "ltx-tpu"))


def _local_file(repo: str, filename: str, dest_dir: Path) -> Path:
    local = dest_dir / Path(filename).name
    if not local.exists():
        raise DownloadFailedError(f"{repo}/{filename}: not at {local} (nothing is "
                                  "downloaded: place the file there)")
    return local


def _local_gemma(models_dir: Optional[str]) -> Path:
    base = Path(models_dir or default_models_dir()) / "vlm-gemma"
    if not (base.exists() and any(base.glob("*.safetensors"))):
        raise DownloadFailedError(f"{GEMMA_REPO}: no *.safetensors snapshot at {base} "
                                  "(nothing is downloaded: place it there)")
    return base


def download_gemma(models_dir: Optional[str] = None, hf_token: Optional[str] = None) -> Path:
    """The Gemma snapshot's local directory (`vlm-gemma` under the models
    directory) with its config.json, tokenizer.json and *.safetensors; a
    missing file raises DownloadFailedError naming it. `hf_token` is
    accepted for the reference's signature."""
    base = _local_gemma(models_dir)
    for name in ("config.json", "tokenizer.json"):
        _local_file(GEMMA_REPO, name, base)
    return base


def download_all_components(
    model: LTXModel,
    models_dir: Optional[str] = None,
    hf_token: Optional[str] = None,
    force: bool = False,
    include_audio: bool = False,
    include_upscaler: bool = True,
) -> Dict[str, Path]:
    """{component: local path} of everything a generation run needs, in the
    reference's layout. `hf_token` and `force` are accepted for the
    reference's signature; nothing is downloaded, so `force` (download
    again) raises."""
    if force:
        raise DownloadFailedError("force=True asks for a new download; this package "
                                  "downloads nothing")
    base = Path(models_dir or default_models_dir())
    out: Dict[str, Path] = {"gemma": _local_gemma(models_dir)}
    out["connector"] = _local_file(LTX_REPO, CONNECTOR_FILE, base / "ltx-connector")
    out["vae"] = _local_file(LTX_REPO, VAE_FILE, base / "ltx-vae")
    out["unified"] = _local_file(LTX_REPO, model.unified_weights_filename,
                                 base / f"ltx-{model.value}")
    out["vae_config"] = _local_file(LTX_REPO, VAE_CONFIG, base / "ltx-vae")
    if include_upscaler:
        out["upscaler"] = _local_file(LTX_REPO, UPSCALER_FILE, base / "ltx-upscaler")
    out["distilled_lora"] = _local_file(LTX_REPO, DISTILLED_LORA_FILE, base / "ltx-lora")
    if include_audio:
        out["audio_vae"] = _local_file(LTX_REPO, AUDIO_VAE_FILE, base / "ltx-audio-vae")
        out["vocoder"] = _local_file(LTX_REPO, VOCODER_FILE, base / "ltx-vocoder")
    return out


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} of a safetensors file (mapped, no copy)."""
    return safetensors_io.load(path)


def load_safetensors_dir(directory) -> Dict[str, torch.Tensor]:
    """All *.safetensors of a directory merged (a sharded checkpoint),
    except the quantized-weight caches (`*.qcache.safetensors`)."""
    out: Dict[str, torch.Tensor] = {}
    for p in sorted(Path(directory).glob("*.safetensors")):
        if p.name.endswith(".qcache.safetensors"):
            continue
        out.update(load_safetensors(p))
    return out
