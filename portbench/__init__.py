"""The benchmark of the PyTorch and CUDA port (``fluid_llm_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration, traffic mix, per-layer metric and set of limits is a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model and training configuration as run;
- ``traffic/<traffic>.json``: the parameters of a mix, read by the driver
  ``drivers/<kind>.py`` that its ``kind`` names;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limits of a cell's comparison with the
  plain reference (``reference/``).

``lib/`` holds what the harness shares (the spec, the trace arithmetic, the
table of peaks, the operation and byte counts), ``inputs/`` the generators
of data and weights.
"""
