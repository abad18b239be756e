"""The benchmark of the PyTorch and CUDA port of KPynq (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything that measures lives here: the data
generator, the plain reference, the comparison that decides
``correct``, the roofline counts and the per-layer readers. From the
program it takes only the fit, its counters, its profiler ranges and its
kernel names.
"""
