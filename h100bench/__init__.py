"""The H100 benchmark of the PyTorch and CUDA port (``detikzify_torch``).

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic
mix, kernel class or per-layer metric sits in a file of its own, found by
its name (``README.md``). Importing this package imports neither the port
nor JAX: only ``port.py`` and the drivers touch the system under test.
"""
