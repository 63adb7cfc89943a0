"""Multi-rank FlashSketch on ``torch.distributed`` (port of
``repro/distributed``).

  sharded_apply — row-, column- and batch-sharded sketch application.  The
                  row-sharded path all-reduces per-ℓ partials, so its
                  result is the same bits on every rank and for every
                  shard count; S is never gathered and no rank holds all
                  of A.
  dist_solvers  — distributed sketch-and-precondition least squares:
                  sharded sketch → replicated R → LSQR with sharded
                  products and norms injected into
                  ``solvers.lsqr_operator``.
  spawn         — ``run_ranks``: a function on P local ranks of a fresh
                  process group (tests, benches, ``chip_smoke.py``).
"""
from repro_torch.distributed.sharded_apply import (  # noqa: F401
    check_row_partition,
    local_partial_apply,
    partial_tables,
    plan_for_mesh,
    rank_world,
    shard_batch,
    shard_cols,
    shard_rows,
    sketch_apply_batched_sharded,
    sketch_apply_colsharded,
    sketch_apply_sharded,
)
from repro_torch.distributed.dist_solvers import (  # noqa: F401
    dist_sketch_precondition_lstsq,
    sharded_matvec_ops,
)
