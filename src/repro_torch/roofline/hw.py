"""NVIDIA H100 constants of the cost model (port of ``repro/roofline/hw.py``,
which holds a TPU v5e's: VMEM, the MXU, ICI links and 512-byte HBM
transactions have no counterpart here).

Two kinds of number:

  * the SKU's published figures, NVIDIA H100 80GB HBM3 (SXM) at 700 W
    (NVIDIA's H100 Tensor Core GPU data sheet and the Hopper white paper),
    among them the dry-run's roofline terms (``roofline/analysis.py``):
    the dense bf16 rate, the memory size and NVLink 4;
  * rates measured on the card by ``tools/torch_hw_probe.py`` (NVIDIA H100
    80GB HBM3, power limit 700.00 W, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` read it in that
    run).  A card set below 700 W runs slower under load.
"""
from repro_torch.kernels.flashsketch import MAX_SMEM_BYTES  # noqa: F401

SKU = "NVIDIA H100 80GB HBM3, 700 W"

# --- published figures of the SKU ------------------------------------------
HBM_BW = 3.35e12              # bytes/s of device memory: every bound's rate
SMS = 132                     # streaming multiprocessors
L2_BYTES = 50 * 2**20         # L2 cache
SECTOR_BYTES = 32             # the smallest transfer of L2 and of memory
PEAK_FLOPS_FP32 = 67e12       # fp32 outside the tensor cores (the sums)
# MAX_SMEM_BYTES (imported above): 227 KB of shared memory a block
# Dense bf16 tensor-core rate (the data sheet's 1 979 TFLOPS is with 2:4
# sparsity; dense is half): the compute term of roofline/analysis.py.
PEAK_FLOPS_BF16 = 989.4e12
# Device memory, "80GB" on the data sheet; the card reports 79.6 GiB
# (chip_smoke.py phase 8 holds it within 2 % of total_memory).
HBM_PER_CHIP = 80 * 2**30
# NVLink 4: 18 links, 50 GB/s each counting both directions (900 GB/s a
# card, the data sheet's figure), so 25 GB/s a link in each direction.  A
# ring collective sends its wire bytes one way while it receives them the
# other, so the collective term reads the rate of one direction.  In an
# HGX H100 system eight cards share one NVLink domain: a 16-wide ``model``
# axis spans two domains, whose traffic crosses InfiniBand (400 Gb/s a
# card), so the collective term is a floor.
LINK_BW = 25e9                # bytes/s a link, one direction
LINKS = 18

# --- measured on the card (tools/torch_hw_probe.py) ------------------------
# L2's read rate as the row-split kernels see it: the forward's κ·s reads
# of A (κ·s·d_pad·n·4 bytes, each from L2 while its column tile's slice of
# A stays there) over its device time at the solver's main plan (d = 65 536,
# k = 4 096, n = 1 024: 0.3012 ms), replayed from a CUDA graph.  The same
# probe's torch.mv over an L2-resident matrix read 2.2-4.5 TB/s (8-32 MiB):
# launch-bound, a floor and not the rate.
L2_READ_BW = 7.13e12
# Host µs of one kernel wrapper's call (flashsketch_fwd at a plan whose
# kernel takes a few µs), 2 000 calls, one synchronise: what a launch at the
# GraSS chunk costs beyond its device time.  Four probe runs read 25.2,
# 40.2, 19.8 and 21.3 µs; this is the last.
DISPATCH_US = 21.3
# gloo all-reduce of ranks that share the one card (CUDA tensors pass
# through the host): 16 MiB fp32 all-reduced by P = 4 ranks in 31.41 ms in
# the last of four probe runs (25.08-35.42 ms), i.e. the ring's
# 2·(P−1)/P · 16 MiB each rank moves, per second.
GLOO_RING_BW = 2.0 * 3 / 4 * (16 * 2**20) / 31.41e-3
