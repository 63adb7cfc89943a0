"""Core BLOCKPERM-SJLT library: hashing, wiring, precision, plans, the
sketch families and coherence (port of ``repro.core``)."""
from repro_torch.core.blockperm import BlockPermPlan, make_plan  # noqa: F401
