"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the GPU it is started on and prints
one JSON line.  Everything a cell is made of is found by name:

* ``configs/<config>.json``: the model's sizes, its source and the laws its
  weights are drawn from;
* ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  driver its ``kind`` names (``drivers/<kind>.py``);
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``: the reader of a per-layer metric (the part of
  the name before the first dot);
* ``kernels/<kernel>.py``: a kernel's operations and bytes by shape;
* ``families/<family>.py``: a model family's kernel launches and model
  FLOPs by shape;
* ``reference/<family>.py``: the plain float32 reference of a family.

The yardstick (traffic, reduction of traces, peaks, formulas, reference
and comparison) lives here and nowhere in the program.  Nothing here
imports ``jax`` or the JAX package ``repro``; the reference imports
nothing of ``repro_torch``.
"""
