"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One run is one cell (a model configuration under one traffic mix) run
once in a fresh process: ``python3 gappbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  Everything is found by name:

* ``configs/<config>.json``: a model configuration as it is run, with its
  published source, what was cut and what was assumed, and its ``family``;
* ``families/<family>.py`` and ``reference/<family>.py``: an architecture's
  shapes, parameter and cache layout and counts, and its plain reference
  (see ``cell.py``);
* ``traffic/<traffic>.json``: the parameters of one job (the entry it
  drives, its sizes, whether a GAPP session is attached), read by the one
  generator in ``traffic/generate.py``;
* ``workloads/<cell>.json``: a cell's configuration, traffic and the
  limits of its correctness check;
* ``metrics/<metric>.py``: one reader a metric, over the run's record.

The yardstick (peaks, operation and byte counts, the plain reference in
``reference/``) lives here and imports nothing of the port.
"""
