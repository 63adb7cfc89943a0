"""One import surface for "how will this sketch launch, and what will it
cost" (port of ``repro/engine.py``)::

    from repro_torch import engine

    plan = make_plan(65_536, 4096)
    lw = engine.lower(plan, engine.LaunchSpec(n=1024, device="cuda"))
    print(lw.describe())                       # the frozen launch record
    print(engine.explain(plan, n=1024, device="cuda"))   # its decisions
    engine.cost_of(lw).bound_us                # the H100 model, same record

The engine proper is ``repro_torch.kernels.lowering`` (resolution and
execution) and ``repro_torch.roofline.sketch_model.cost_of``; this module
only re-exports them.
"""
from repro_torch.kernels.lowering import (  # noqa: F401
    GATHER_OPS,
    IMPLS,
    OPS,
    SHARDS,
    LaunchSpec,
    Lowering,
    clear_lowering_cache,
    execute,
    explain,
    lower,
    lowering_cache_size,
)
from repro_torch.roofline.sketch_model import cost_of  # noqa: F401
