"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``mixes/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``; a configuration's
model (leaves, plain reference loss, FLOP count) is
``reference/<model>.py``, which the configuration names (``"model"``;
``lm`` without it).
"""
