"""Training: flow-matching LoRA fine-tuning of the DiT.

Port of ltx_tpu/train/ (the parallel modes are not ported yet, see ROADMAP
A18):

* flow_match.py: the rectified-flow objective, the scheduler's conventions,
  for the video DiT and the dual audio-video DiT;
* lora.py: trainable LoRA side paths on the DiT's linears (bf16 or int4
  bases: QLoRA), read by the linears themselves;
* step.py: the train steps, video and joint audio-video (full fine-tune or
  LoRA-only), the optax-equal optimizer, rematerialisation per block or per
  segment, EMA;
* prepare.py: clips and captions to latent shards (`prepare-data`);
* checkpoint.py, export.py, data.py: checkpoints in the reference's key
  paths, the ComfyUI adapter file, latent shards and device prefetch;
* cli.py: the driver, `python -m ltx_tpu_torch.train.cli`.

On the card every DiT attention runs the statistics forward and the two
backward kernels, and an int4 base runs `int4_matmul` forward and
`dequant_int4` in its straight-through backward.
"""

from ltx_tpu_torch.train.checkpoint import load_train_checkpoint, save_train_checkpoint
from ltx_tpu_torch.train.export import lora_state_dict, save_lora
from ltx_tpu_torch.train.flow_match import av_flow_match_loss, flow_match_loss, sample_sigmas
from ltx_tpu_torch.train.lora import add_lora, lora_param_mask, merge_lora, strip_lora
from ltx_tpu_torch.train.step import (
    TrainConfig,
    combine_params,
    ema_init,
    init_train_state,
    make_av_train_step,
    make_ema_update,
    make_optimizer,
    make_train_step,
    partition_trainable,
)

__all__ = [
    "flow_match_loss", "av_flow_match_loss", "sample_sigmas", "make_av_train_step",
    "add_lora", "lora_param_mask", "merge_lora", "strip_lora",
    "TrainConfig", "make_optimizer", "make_train_step", "partition_trainable",
    "combine_params", "init_train_state", "ema_init", "make_ema_update",
    "lora_state_dict", "save_lora",
    "save_train_checkpoint", "load_train_checkpoint",
]
