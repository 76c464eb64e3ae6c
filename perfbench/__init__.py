"""The benchmark of the PyTorch and CUDA counting stack (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON result line.  Everything a cell is made of is found by
name: ``configs/<config>.json`` (the database and its search settings),
``traffic/<mix>.json`` (a mix's parameters, and the ``kind`` of traffic
that reads them, ``kinds/<kind>.py``; see :mod:`perfbench.generator`)
and ``metrics/<metric>.py`` (one reader a per-layer metric).  The
yardstick lives here too: the frozen database generator
(:mod:`perfbench.synth`), the plain counting reference
(:mod:`perfbench.reference`), the comparison that decides ``correct``
(:mod:`perfbench.compare`), K2's count of bytes and operations
(:mod:`perfbench.roofline`) and the reading of the device trace
(:mod:`perfbench.devtrace`).  Nothing here imports JAX or the JAX package.
"""
