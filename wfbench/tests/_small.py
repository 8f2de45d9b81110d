"""Test-sized parameters of the cells: the same shapes, a CPU's scale."""

SMALL = {
    "ysb.catchup": (
        {"batch": 4096, "warmup_batches": 4, "window_usec": 1_000_000},
        {"pool_records": 400_000, "chunk_bytes": 65536}),
}


def overrides(cell):
    cfg, traffic = SMALL[cell]
    return {"cfg_override": cfg, "traffic_override": traffic}
