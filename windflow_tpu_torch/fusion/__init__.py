"""Whole-chain fusion (the port of ``windflow_tpu/fusion`` and the chain
walk of ``windflow_tpu/analysis/fusion.py``): :mod:`.chains` finds the
maximal fusible operator chains over the graph's topology, and
:mod:`.executor` runs each executable one as a single hop."""

from windflow_tpu_torch.fusion.chains import fusible_chains
from windflow_tpu_torch.fusion.executor import (apply_fusion,
                                                attribute_member_stats,
                                                build_prelude, fused_name,
                                                plan_segments)

__all__ = ["apply_fusion", "attribute_member_stats", "build_prelude",
           "fused_name", "fusible_chains", "plan_segments"]
