"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  ``BENCHMARK.json`` at that root names the
cells; each cell names a configuration (its file, named there, with the
plain reference it names under ``perfbench/references/``), a traffic mix
(``perfbench/traffic/<name>.json``) and has a file of its own
(``perfbench/cells/<name>.json``: the offered rate and the check's
limits); each per-layer metric is a reader ``perfbench/metrics/<name>.py``.
So a configuration, a mix, a cell or a metric is added as files and
entries.  ``sweep.py`` finds a cell's knee and ``control.py`` reads the
check's limits on the card; the runs do not use them.  Nothing here
imports JAX or the JAX package, and the references import nothing of the
port either.
"""
