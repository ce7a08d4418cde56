"""fluxbench: the benchmark of ``aerobulk_tpu_torch`` on an NVIDIA H100
(``python3 fluxbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; README.md)."""
