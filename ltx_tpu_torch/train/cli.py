"""LoRA fine-tune driver: latent shards -> adapter safetensors.

    python -m ltx_tpu_torch.train.cli --data SHARDS --out adapter.safetensors \
        --random-init full --quant int4 --rank 16 --steps 1000 [--device cuda]

Port of ltx_tpu/train/cli.py (the trainer behind `scripts/train_lora.py`):
dataset (train/data.py shards) -> QLoRA/LoRA flow-matching steps on one
device -> periodic checkpoints with the dataset cursor -> the adapter in
the ComfyUI LoRA schema (the EMA adapter when --ema is on). The flags and
defaults are the reference's, plus --device (default cuda; the CPU runs the
kernels' plain versions). The base is random (--random-init) or the DiT of
a unified checkpoint (--weights: `keymaps.split_unified`, then
`keymaps.load_transformer_params`, as the reference; the depth and widths
come from the file's tensors, so a checkpoint cut to fewer blocks trains
too). The frozen base is quantized unless --quant none or --random-init
tiny: W8A8 (the reference's default) or int4.

Parallel training, as the reference: --coordinator / --num-processes /
--process-id (or torchrun's environment) join the process group, --mesh
DATA,MODEL shards the LoRA'd base under the inference rules
(`parallel.sharding.shard_transformer`: dp+tp, the data ranks each on
their own rows, seeded with seed + data rank * 100003, each process with
its own dataset cursor), --mesh-slices lays the mesh out over slices, and --sdpa
ring registers the mesh's model axis for sequence-parallel attention (it
needs --mesh). A model that --mesh shards over heads runs each attention on
its rank's heads of every token, which is the whole attention of those heads
with no collective, so the ring itself runs only for a model that stays
whole on its ranks. Checkpoints and the adapter are written once, by
rank 0, in the reference's whole layout; a resume re-shards them.

Each step's noise levels and noise come from a torch.Generator seeded with
(seed + 2, step), and the checkpoint's dataset cursor is that of the last
batch a step consumed, so a resumed run draws what the uninterrupted run
drew. The EMA is not checkpointed: a resumed run restarts it from the
restored adapter.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ltx_tpu_torch.ops.attention import set_sequence_parallel
from ltx_tpu_torch.parallel import runtime, sharding

_SEED_STRIDE = 1_000_003


def add_train_arguments(ap) -> None:
    """Register the trainer's flags on an argparse parser or subparser."""
    ap.add_argument("--data", required=True, help="shard directory")
    ap.add_argument("--out", required=True, help="adapter .safetensors path")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat-segments", type=int, default=0,
                    help="segmented remat over the 48 blocks: S checkpointed "
                         "groups of 48/S blocks instead of one per block")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA decay (0 = off); exports the EMA adapter")
    ap.add_argument("--quant", choices=("none", "w8a8", "int4"),
                    default="w8a8", help="frozen-base quantization")
    ap.add_argument("--weights", default=None,
                    help="unified checkpoint (.safetensors) whose DiT is the base")
    ap.add_argument("--random-init", choices=("tiny", "full"), default=None,
                    help="random base instead of --weights (tiny is not quantized)")
    ap.add_argument("--compute", choices=("bf16", "f32"), default="bf16",
                    help="compute dtype; on the card f32 attention runs in bf16 "
                         "(cast at the kernel boundary, ops.attention)")
    ap.add_argument("--ckpt", default=None, help="checkpoint .npz path")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="dp+tp train over a (data, model) mesh of processes "
                         "(params sharded by the inference rules)")
    ap.add_argument("--sdpa", choices=("xla", "pallas", "ring"), default="xla",
                    help="attention for the loss: xla and pallas compute the "
                         "same function here (the flash forward and backward "
                         "kernels on the card, their plain versions on the "
                         "CPU); ring = sequence-parallel over the mesh's model "
                         "axis (needs --mesh; a model sharded over heads "
                         "attends on its local heads instead)")
    ap.add_argument("--mesh-slices", type=int, default=None, metavar="N")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")


def _check_args(args) -> None:
    if not args.random_init and not args.weights:
        raise SystemExit("pass --weights UNIFIED.safetensors or --random-init {tiny,full}")


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed + 2) * _SEED_STRIDE + step)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _atomic_np_save(path, obj) -> None:
    """np.save through a pid-unique temporary file and os.replace."""
    tmp = f"{path}.tmp.{os.getpid()}.npy"
    try:
        np.save(tmp, obj, allow_pickle=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_base(path):
    """(the LTXTransformer state dict of a unified checkpoint's DiT, its
    config, seconds): split_unified, then the DiT key map, depth and widths
    read from the tensors."""
    from ltx_tpu_torch.weights import keymaps
    from ltx_tpu_torch.weights.download import load_safetensors

    t0 = time.perf_counter()
    tr_raw, _, _ = keymaps.split_unified(load_safetensors(path))
    layers = len({k.split(".")[1] for k in tr_raw if k.startswith("transformer_blocks.")})
    state = keymaps.load_transformer_params(tr_raw, layers)
    return state, keymaps.transformer_config_from_state_dict(state), time.perf_counter() - t0


def run(args, report=None) -> int:
    """Train per `args` (the flags of add_train_arguments). With `report`
    (a callable), it is called after every step with a dict of that step's
    number, loss, grad_norm, synchronised seconds and peak device memory,
    and once before the first step with the set-up seconds."""
    from ltx_tpu_torch.config import TransformerConfig
    from ltx_tpu_torch.models.common import assign_, init_random_
    from ltx_tpu_torch.models.dit import LTXTransformer, quantize_transformer
    from ltx_tpu_torch.ops.rope import video_rope
    from ltx_tpu_torch.train.checkpoint import load_train_checkpoint, save_train_checkpoint
    from ltx_tpu_torch.train.data import LatentShardDataset, prefetch_to_device
    from ltx_tpu_torch.train.export import save_lora
    from ltx_tpu_torch.train.flow_match import sample_sigmas
    from ltx_tpu_torch.train.lora import add_lora
    from ltx_tpu_torch.train.step import (
        TrainConfig,
        ema_init,
        init_train_state,
        make_ema_update,
        make_train_step,
    )

    _check_args(args)
    device = torch.device(args.device)
    mesh = _mesh(args)
    rank = runtime.world()[0]
    data_index = mesh.index("data") if mesh is not None else 0

    def log(msg):
        if rank == 0:  # rank 0 speaks for the mesh
            print(f"[train_lora] {msg}", file=sys.stderr, flush=True)

    compute_dtype = torch.float32 if args.compute == "f32" else torch.bfloat16
    setup = {}
    base_state = None
    if args.random_init:
        cfg = TransformerConfig()
        if args.random_init == "tiny":
            cfg = cfg.tiny()
    else:
        base_state, cfg, setup["load_s"] = _load_base(args.weights)
        log(f"base DiT from {args.weights}: {cfg.num_layers} blocks, inner "
            f"{cfg.inner_dim}, {setup['load_s']:.2f} s")

    # each data rank samples its own rows (the reference's per-process seed,
    # by the process's index on the data axis: a model group shares rows)
    ds = LatentShardDataset(args.data, args.batch, seed=args.seed + data_index * 100003)
    f, h, w = ds.grid
    if ds.batch_size * (f * h * w) * cfg.in_channels == 0:
        raise SystemExit("empty dataset")
    log(f"dataset: {ds.num_rows} rows, grid {ds.grid}, batch {args.batch}")

    t0 = time.perf_counter()
    if base_state is None:
        model = LTXTransformer(cfg, device=device, dtype=compute_dtype)
        init_random_(model, torch.Generator(device=device).manual_seed(args.seed))
        _sync(device)
        setup["random_init_s"] = time.perf_counter() - t0
        log(f"random {args.random_init} base on {device}: {setup['random_init_s']:.2f} s")
    else:
        # the file's weight dtype (bf16) stands for the compute dtype, as a
        # random base is drawn in it; the f32 tables stay f32
        file_dtype = base_state["patchify_proj.weight"].dtype
        model = assign_(LTXTransformer(cfg, device="meta", dtype=file_dtype),
                        base_state).to(device)
        for p in model.parameters():
            if p.dtype == file_dtype:
                p.data = p.data.to(compute_dtype)
        _sync(device)
        setup["to_device_s"] = time.perf_counter() - t0
    del base_state
    if args.quant != "none" and args.random_init != "tiny":
        t0 = time.perf_counter()
        quantize_transformer(model, bits=8 if args.quant == "w8a8" else 4, group_size=64,
                             w8a8=args.quant == "w8a8")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        _sync(device)
        setup["quantize_s"] = time.perf_counter() - t0
        log(f"frozen base quantized: {args.quant}, {setup['quantize_s']:.2f} s")
    add_lora(model, torch.Generator(device=device).manual_seed(args.seed + 1),
             rank=args.rank, alpha=args.alpha)
    if mesh is not None:
        sharding.shard_transformer(model, mesh)
        log(f"params sharded over {mesh} (tp over heads/FFN; LoRA leaves outer dims)")
    if args.sdpa == "ring":
        if mesh is None:
            raise SystemExit("--sdpa ring needs --mesh (the token axis shards over the "
                             "mesh model axis)")
        set_sequence_parallel(mesh)
        log("sequence-parallel attention registered over the model axis (a model sharded "
            "over heads attends on its local heads: no ring)")

    cos, sin = video_rope(f, h, w, cfg.inner_dim, cfg.num_heads)
    rope = (torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device))
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup, lora_only=True,
                     accum_steps=args.accum, remat_segments=args.remat_segments,
                     sdpa_impl=args.sdpa, compute_dtype=compute_dtype)
    trainable, _, opt_state = init_train_state(model, tc)
    step = make_train_step(model, tc)
    ema = ema_init(trainable) if args.ema > 0 else None
    ema_upd = make_ema_update(args.ema) if args.ema > 0 else None
    log(f"LoRA rank {args.rank}: {len(trainable)} trainable tensors, "
        f"{sum(p.numel() for p in trainable.values())} values")

    # the dataset cursor is per process: each samples its own rows
    cursor_path = f"{args.ckpt}.data.{rank}.npy" if args.ckpt else None
    start = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        whole_t, whole_o = _whole_state(model, trainable, opt_state)
        whole_t, whole_o, start = load_train_checkpoint(args.ckpt, whole_t, whole_o)
        _reshard_state(model, trainable, opt_state, whole_t, whole_o)
        if os.path.exists(cursor_path):
            ds.restore(np.load(cursor_path, allow_pickle=True).item())
        if ema is not None:
            ema = ema_init(trainable)
        log(f"resumed from {args.ckpt} at step {start}")
    if report is not None:
        report({"setup": setup, "start": start})

    it = prefetch_to_device(iter(ds), depth=2, device=device)
    t_run = time.perf_counter()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        batch = next(it)
        # the model group's ranks share rows and draws; data ranks differ
        gen = _step_generator(args.seed + data_index * 100003, i, device)
        sigma = sample_sigmas(gen, batch.tokens.shape[0], tc.sigma_scheme)
        noise = torch.randn(batch.tokens.shape, generator=gen, dtype=torch.float32,
                            device=device)
        trainable, opt_state, aux = step(trainable, opt_state, batch.tokens, batch.context,
                                         rope, sigma, noise, context_bias=batch.bias)
        if ema is not None:
            ema = ema_upd(ema, trainable)
        loss, gnorm = float(aux["loss"]), float(aux["grad_norm"])  # reads back: a sync
        seconds = time.perf_counter() - t_step
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss at step {i + 1}")
        if report is not None:
            peak = (torch.cuda.max_memory_allocated(device) / 2**30
                    if device.type == "cuda" else None)
            report({"step": i + 1, "loss": loss, "grad_norm": gnorm, "seconds": seconds,
                    "peak_gib": peak})
        if (i + 1) % args.log_every == 0 or i == start:
            log(f"step {i + 1}/{args.steps} loss={loss:.4f} gnorm={gnorm:.3f} "
                f"({(time.perf_counter() - t_run) / (i + 1 - start):.2f} s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            whole_t, whole_o = _whole_state(model, trainable, opt_state)
            if rank == 0:
                save_train_checkpoint(args.ckpt, whole_t, whole_o, i + 1)
            _atomic_np_save(cursor_path, batch.cursor)
            _barrier(mesh)
            log(f"checkpoint @ step {i + 1} -> {args.ckpt}")

    set_sequence_parallel(None)
    adapter = sharding.gather_params(ema if ema is not None else trainable, model)
    if rank == 0:
        n = save_lora(adapter, args.out)
        log(f"exported {'EMA ' if ema is not None else ''}adapter: {n} tensors -> {args.out}")
    _barrier(mesh)
    print(f"TRAIN LORA OK: {args.steps - start} steps, adapter {args.out}")
    return 0


def _mesh(args):
    """Join the process group when asked (the flags, or a launcher's
    environment), then the --mesh, or None."""
    runtime.initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                   device=args.device)
    if not args.mesh:
        return None
    d, m = (int(x) for x in args.mesh.split(","))
    mesh = runtime.make_hybrid_mesh(data=d, model=m, slices=args.mesh_slices)
    if runtime.world()[0] == 0:
        print(f"[train_lora] mesh: ({d},{m}) over {d * m} ranks, {runtime.world()[1]} "
              "process(es)", file=sys.stderr, flush=True)
    return mesh


def _barrier(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier()


def _state_map(state: dict, fn) -> dict:
    """The optimizer state with fn applied to each {parameter: tensor} dict."""
    return {k: (fn(v) if k in ("mu", "nu", "acc_grads") else _state_map(v, fn))
            if isinstance(v, dict) else v for k, v in state.items()}


def _whole_state(model, trainable, opt_state):
    """(trainable, opt_state) with every sharded leaf gathered whole: the
    reference's layout, the same on every rank."""
    def whole(d):
        return sharding.gather_params(d, model)

    return whole(trainable), _state_map(opt_state, whole)


def _reshard_state(model, trainable, opt_state, whole_t, whole_o) -> None:
    """Copy a whole checkpoint's values into this rank's shards, in place."""
    sharding.scatter_params_(trainable, whole_t, model)
    for key in opt_state:
        value, src = opt_state[key], whole_o[key]
        if isinstance(value, dict):
            if key in ("mu", "nu", "acc_grads"):
                sharding.scatter_params_(value, src, model)
            else:
                _reshard_state(model, {}, value, {}, src)
        else:
            opt_state[key] = src


def main(argv=None, report=None) -> int:
    """The command line: parse `argv` (default sys.argv) and `run`."""
    ap = argparse.ArgumentParser(description="LoRA fine-tune of the LTX-2 DiT")
    add_train_arguments(ap)
    return run(ap.parse_args(argv), report)


if __name__ == "__main__":
    raise SystemExit(main())
