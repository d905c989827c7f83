"""Registry of the ten architectures of the PyTorch port
(``repro.configs.registry``).

Every entry exposes the arch protocol:
    .arch_id  .family  .shapes  .skip_notes
    .input_specs(shape, smoke=False) -> {field: (shape, dtype)}
    .build_step(shape, group, smoke=False, ...) -> the step over the ranks
        of a ``ShardGroup``

``EXTRA_ARCHS`` holds ``louvain_arch.ARCH``, the paper's own distributed
phases as dry-run targets (not among the assigned cells; ``--arch louvain``
of ``launch/dryrun.py``), as the reference's does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (deepseek_v2_236b, dimenet_cfg, equiformer_v2,
                                 fm, gat_cora, gemma3_12b, gin_tu,
                                 internlm2_20b, mixtral_8x22b, qwen2_1p5b)

ALL_ARCHS = {
    a.ARCH.arch_id: a.ARCH
    for a in (gemma3_12b, qwen2_1p5b, internlm2_20b, mixtral_8x22b,
              deepseek_v2_236b, equiformer_v2, gin_tu, gat_cora, dimenet_cfg,
              fm)
}

# The paper's own distributed phases as dry-run targets.
from repro_torch.configs import louvain_arch  # noqa: E402

EXTRA_ARCHS: Dict[str, object] = {louvain_arch.ARCH.arch_id:
                                  louvain_arch.ARCH}


def get_arch(arch_id: str):
    if arch_id in ALL_ARCHS:
        return ALL_ARCHS[arch_id]
    if arch_id in EXTRA_ARCHS:
        return EXTRA_ARCHS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; have "
                   f"{sorted(ALL_ARCHS) + sorted(EXTRA_ARCHS)}")


def all_cells() -> List[Tuple[str, str]]:
    """Every assigned (arch, shape) cell."""
    return [(aid, shape) for aid, arch in ALL_ARCHS.items()
            for shape in arch.shapes]


def skipped_cells() -> Dict[Tuple[str, str], str]:
    """Cells skipped by the assignment's rules, with the reason."""
    return {(aid, shape): why for aid, arch in ALL_ARCHS.items()
            for shape, why in arch.skip_notes.items()}
