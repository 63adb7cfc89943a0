"""Core BLOCKPERM-SJLT library: hashing, wiring, precision and plans
(port of ``repro.core``)."""
from repro_torch.core.blockperm import BlockPermPlan, make_plan  # noqa: F401
