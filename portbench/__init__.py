"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell once (``python3 portbench/run.py --workload NAME --seed N
--seconds S --trace 0|1``). Everything that belongs to a configuration, a
traffic mix, a per-layer metric or a kernel sits in a file of its own, found
by the name ``BENCHMARK.json`` gives it."""
