"""The PyTorch and CUDA port's benchmark (``BENCHMARK.json``); run one cell with
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
