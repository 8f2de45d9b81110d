"""Hand-written CUDA kernels of the port (see ``ffat_cuda.py`` and
``reduce_cuda.py``)."""

from windflow_tpu_torch.kernels.ffat_cuda import (  # noqa: F401
    fold_leaf_plain, fold_supported, grouping_rank_hist,
    grouping_rank_hist_plain, grouping_supported, kernel_build_count,
    launch_counts, monoid_identity, order_hist, reset_launch_counts,
    resolve_kernels, sliding_fold)
from windflow_tpu_torch.kernels.reduce_cuda import (  # noqa: F401
    dense_monoid_table, dense_monoid_table_plain, routed_monoid_tables,
    table_leaf_ok, table_supported)
