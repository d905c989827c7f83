"""The ELL scan kernels K1 (``fused.py``) and K2 (``louvain_scan.py``) and
their inputs.  On the card a kernel takes one degree bucket's rows and the
CSR, and gathers the community state itself; the plain versions (CPU
tensors) build the bucket's padded tile and gather per slot with torch ops,
as ``repro.kernels.louvain_scan.ops`` leaves the gathers to XLA
(``prepare_ell_inputs`` / ``prepare_fused_inputs``)."""

from __future__ import annotations

from repro_torch.kernels.louvain_scan.fused import (
    launch_louvain_fused, louvain_fused, louvain_fused_rows_ref,
    prepare_fused_inputs)
from repro_torch.kernels.louvain_scan.louvain_scan import (
    block_rows_for_width, launch_louvain_scan, louvain_scan,
    louvain_scan_rows_ref, prepare_ell_inputs)

__all__ = ["block_rows_for_width", "launch_louvain_fused",
           "launch_louvain_scan", "louvain_fused", "louvain_fused_rows_ref",
           "louvain_scan", "louvain_scan_rows_ref", "prepare_ell_inputs",
           "prepare_fused_inputs"]
