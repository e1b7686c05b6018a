"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration, traffic mix, per-layer metric and limit sits in a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it; the
reference (``reference.py``) imports nothing of the program.
"""
