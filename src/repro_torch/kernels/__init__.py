"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1/K2 in ``louvain_scan``, K3 in ``aggregate``, K4 in
``batch_apply``."""
