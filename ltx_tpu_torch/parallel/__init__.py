"""Tensor, sequence and pipeline parallelism on torch.distributed.

Port of ltx_tpu/parallel/ (runtime.py, sharding.py, ring_attention.py,
pipeline.py):

* `runtime`: `initialize_distributed`, the (data, model) `Mesh` on
  torch.distributed's DeviceMesh (`make_mesh`, `make_hybrid_mesh`; the
  (data, pipe) `make_pp_mesh`);
* `collectives`: the counted all-reduce, all-gather, all-reduce-max,
  broadcast and the ring's send/recv (a pipeline stage's hop among them),
  and the autograd functions built on them;
* `sharding`: the megatron rules (`COLUMN_PARALLEL`, `ROW_PARALLEL`) that
  slice each rank's shard out of a full module in place
  (`shard_transformer`, `shard_gemma`), the row-parallel linear forward and
  the flat QK norm over the model group (`sharded_rms_norm`);
* `ring_attention`: sequence-parallel attention, forward and backward,
  through the flash kernels' statistics forward and backward pair;
* `pipeline`: GPipe over both DiTs' block stacks (`shard_pp` keeps a
  stage's blocks in place), forward and backward.

The reference expresses all of it as shardings that XLA partitions; here
every rank runs its own process and the collectives are explicit.
"""
