"""gvebench: the benchmark of the PyTorch and CUDA port of GVE-Louvain
(``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` on the card:

    python3 gvebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``: a graph generator
from ``gen/``, its sizes, the Louvain parameters and the guarantees) and a
traffic mix (``traffic/<name>.json``: the parameters of one of the general
loops in ``loops/``).  Per-layer metrics are small readers in
``metrics/<name>.py``.  ``reference/`` holds the plain PyTorch reference
that decides ``correct``; it imports nothing of the program.  The harness
finds every one of these files by the names in ``BENCHMARK.json``, so a
later change adds a configuration, a mix or a metric as new files and new
entries without editing any file here.
"""
