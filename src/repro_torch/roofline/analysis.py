"""Roofline terms of a dry-run cell's per-device graphs (port of
``repro/roofline/analysis.py``).

    compute term    = device flops       / PEAK_FLOPS_BF16
    memory term     = device HBM bytes   / HBM_BW
    collective term = device wire bytes  / (LINK_BW × LINKS)

The device numbers come from ``hlo_parse.entry_cost`` over the graphs
that ``launch/dryrun.py`` records (per-device shapes; per-device × chips
= global), and the constants are the H100's published figures
(``roofline/hw.py``), where the reference's are a TPU v5e's.
MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline import hlo_parse, hw


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device (the graphs' shapes are local to one device)
    device_flops: float
    device_hbm_bytes: float
    device_coll_bytes: float
    coll_breakdown: Dict[str, float]
    # terms in seconds
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    # context
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    bottleneck: str = ""
    step_time_s: float = 0.0
    # memory analysis
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    fits_hbm: bool = True
    note: str = ""

    def finish(self):
        self.compute_s = self.device_flops / hw.PEAK_FLOPS_BF16
        self.memory_s = self.device_hbm_bytes / hw.HBM_BW
        self.collective_s = self.device_coll_bytes / (hw.LINK_BW * hw.LINKS)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.step_time_s = max(terms.values())
        global_flops = self.device_flops * self.chips
        self.useful_ratio = (self.model_flops / global_flops) if global_flops else 0.0
        total_state = self.arg_bytes_per_device + self.temp_bytes_per_device
        self.fits_hbm = total_state <= hw.HBM_PER_CHIP
        return self

    def roofline_fraction(self) -> float:
        """Fraction of the ideal (model-flops-only) time: how close the step
        is to the best achievable on the dominant resource."""
        ideal = self.model_flops / (self.chips * hw.PEAK_FLOPS_BF16)
        return ideal / self.step_time_s if self.step_time_s > 0 else 0.0

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D with N = active params; decode: D = batch tokens (1 step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze_compiled(graphs: Sequence[hlo_parse.Graph], cfg: ModelConfig,
                     shape: ShapeConfig, mesh_name: str, chips: int,
                     arg_bytes: float, temp_bytes: float,
                     note: str = "") -> RooflineReport:
    """The report of one cell from its per-device graphs (the node lists
    of ``hlo_parse.graph_nodes``) and its memory numbers (the reference
    reads both from the compiled executable)."""
    cost = hlo_parse.entry_cost(graphs, chips)
    rep = RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        device_flops=cost.flops,
        device_hbm_bytes=cost.hbm_bytes,
        device_coll_bytes=cost.coll_wire_bytes,
        coll_breakdown=dict(cost.coll_bytes),
        model_flops=model_flops_for(cfg, shape),
        arg_bytes_per_device=float(arg_bytes),
        temp_bytes_per_device=float(temp_bytes),
        note=note,
    )
    return rep.finish()


def save_report(rep: RooflineReport, outdir: str):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{rep.arch}_{rep.shape}_{rep.mesh}.json")
    with open(path, "w") as f:
        json.dump(rep.to_json(), f, indent=2)
    return path


def format_row(rep: RooflineReport) -> str:
    return (f"| {rep.arch} | {rep.shape} | {rep.mesh} | "
            f"{rep.compute_s*1e3:.1f} | {rep.memory_s*1e3:.1f} | "
            f"{rep.collective_s*1e3:.1f} | {rep.bottleneck} | "
            f"{rep.useful_ratio:.2f} | {rep.roofline_fraction()*100:.0f}% | "
            f"{(rep.arg_bytes_per_device+rep.temp_bytes_per_device)/2**30:.1f} GiB |")
