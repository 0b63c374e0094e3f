"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, entry-point driver or per-layer
metric is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``drivers/<kind>.py``, ``metrics/<metric>.py`` and
``reference/arch_<arch>.py``. Nothing here imports JAX or the JAX package.
"""
