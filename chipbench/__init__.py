"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python -m chipbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output.  Everything a cell needs is found by
name: ``configs/<config>.json`` (sizes and the driver that builds the
system), ``traffic/<mix>.json`` (the load's parameters, read by
``load.py``), ``workloads/<cell>.json`` (the cell's own overrides of its
traffic, such as its rate) and ``metrics/<metric>.py`` (one reader a
metric).  ``reference/`` is the plain version the outputs are held
against; it imports nothing of the program.
"""
