"""The benchmark of the PyTorch / CUDA port (``cuda_optical_flow_2_torch``).

One command runs one cell once and prints one JSON line::

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, loop kind or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``flowbench/README.md``).  Nothing here imports
JAX or the JAX package; the port is imported only as the code under test, and
``flowbench/reference/`` imports neither.
"""
