"""The plain reference that decides ``correct``: GVE-Louvain's semantics
written out in plain PyTorch (``louvain``), the edge-set semantics of a
stream of edge batches (``edges``) and float64 modularity.  It imports
nothing of the program and takes nothing the program made: it works from
the edge lists the benchmark drew and, where it follows a stream step by
step, from the memberships the program returned, which it judges."""
