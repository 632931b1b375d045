"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. Everything that belongs to one of them, or to one metric, is a
file of its own that the harness finds by name:

* ``bench/configs/<config>.json``: the model as it is run, its source, the
  comparison's reference family and the engine's settings;
* ``bench/traffic/<mix>.json``: the driver kind (``bench/drivers/<kind>.py``),
  arrivals, lengths and the limits of the correctness check;
* ``bench/metrics/<metric>.py``: one reader per metric, ``read(record)``
  returning a number or ``None`` when the run holds nothing to read.

The yardstick lives here too: the traffic generator (``traffic.py``), the
counts of operations and bytes and the chip's peaks (``roofline.py``), the
reduction of profiler traces (``trace.py``), the plain float32 references
(``reference/``) and the comparison that decides ``correct``
(``compare.py``). Nothing here imports ``jax`` or the JAX package ``repro``,
and ``reference/`` imports nothing of ``repro_torch``.
"""
