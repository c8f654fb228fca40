"""portbench: the benchmark of the PyTorch + CUDA port (`homulator_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once; README.md says how
the folder is laid out and how to add a configuration, a traffic mix, a
cell or a metric.
"""
