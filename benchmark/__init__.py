"""The benchmark of the PyTorch/CUDA port (`ltx_tpu_torch`).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the card it starts
on. Data, one file each: configurations (`configs/`), traffic mixes
(`traffic/`), limits of the correctness check (`checks/`) and metric
readers (`metrics/`); code: the traffic generator (`traffic.py`), the
weights drawn from the seed (`weights.py`), the system under test
(`program.py`), the window and the check (`harness.py`), the device trace
(`trace.py`), the yardstick (`flops.py`), the plain reference
(`reference/`) and the readings its limits come from (`calibrate.py`).
Nothing here imports JAX or the JAX package `ltx_tpu`.
"""
