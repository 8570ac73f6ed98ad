"""cgbench: the benchmark of tpucg_torch (the PyTorch and CUDA port of tpucg).

Run from the root of a checkout:

    python3 cgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells, configurations and metrics; every piece
is found by name under this folder (``configs/``, ``workloads/``,
``metrics/``, ``gen/``). ``reference/`` holds the plain solver that decides
``correct``; it imports nothing of the program.
"""
