"""The benchmark of the PyTorch / CUDA port (``claragenomicsanalysis_tpu_torch``):
``python cga_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
