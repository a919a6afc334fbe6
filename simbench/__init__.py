"""The benchmark of the PyTorch and CUDA port (``softbody_tpu_torch``):
data-driven cells of configurations (``configs/``), traffic mixes
(``traffic/``) and per-layer metrics (``metrics/``), held against a
plain PyTorch reference (``reference/``).  Run one cell once with
``python3 -m simbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the checkout's root."""
