"""Core BLOCKPERM-SJLT library: hashing, wiring, precision, plans and the
sketch families (port of ``repro.core``)."""
from repro_torch.core.blockperm import BlockPermPlan, make_plan  # noqa: F401
