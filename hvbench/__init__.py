"""The benchmark of the PyTorch and CUDA port (`hypervisor_tpu_torch`).

`python3 -m hvbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one NVIDIA card
(`run`). Configurations are `configs/*.json`, traffic mixes
`traffic/*.json`, per-layer metrics `metrics/<name>.py`, the kernels the
roofline divides by `kernels/*.json`; the plain reference that decides
`correct` is `reference/`, and `control.py` runs its lower-precision
control. Nothing here imports JAX or the JAX package.
"""
