#!/usr/bin/env python3
"""Build and drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

  1. set-up: the card's name and power limit, the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` (timed), TF32 off;
  2. each CUDA kernel against its plain PyTorch version on the card, for
     all six precision policies, at a ragged-n plan with d < d_pad, at
     κ ∈ {1, 2, 4} × s ∈ {1, 2, 4}, and at the main plan (the GraSS chunk
     for the GraSS kernels, whose gathers run in both operand layouts, with
     one plan whose Bc is not a power of two); plus the exact checks
     S·I == S, ⟨S x, y⟩ == ⟨x, Sᵀ y⟩, each gather == its kernel on the
     zero-padded materialized gather (the gather-fused forward also under
     every row split R it takes), and an identity row_index == the
     non-gather kernel; the forwards of the row-split kernel
     split_vec_kernel under every row split R (the fused forward at the
     main plan and at a Br = 32, Bc = 8 192 plan, FLASHBLOCKROW at the main
     plan and the GraSS chunk's, the global forward at the CountSketch and
     graph plans of the main shape): within each policy's tolerance, the
     same bits for every R, S·E == S on slabs E of the identity, and each
     gather == its forward on the materialized gather under every R, both
     source layouts; the fused transpose at the main plan (n, and the
     ragged 1 000 and 37) on both its routes forced, the staged kernel and
     the L2 route: the same bits, also under every stage count and three
     grids of the staged kernel and every tile and row split of the L2
     route, Sᵀ·I == Sᵀ and the adjoint pair on both; the narrow kernels at
     n = 1 (the ragged plan, κ × s ∈ {1, 2, 4}², the main plan, every
     policy): within tolerance of their plain versions and torch.equal to
     the forced wide route under every stage count that fits and two grids
     and on operands off 16-byte alignment (all three copy modes), and the
     adjoint pair on the narrow route;
  3. the main path at the paper's size (d = 65 536, n = 1 024): the
     ``default``, ``fast`` and ``precise`` solver presets on a cond-1e4
     least-squares problem in float64, each solved twice (the first solve
     also sets up the libraries) and checked against
     ``torch.linalg.lstsq``; one more ``default`` solve under
     ``torch.profiler`` (device time by kernel, busy share of the wall
     time); one autograd backward through
     ``sketch_apply`` and one ``sketch_apply_t``; the launch counts of
     both kernels over this phase;
  4. timing (CUDA events, warm-up, median): each kernel, its plain
     version, its bound and one PyTorch library call computing the same
     product (``torch.sparse.mm`` of S in CSR form, after an
     ``index_select`` for the gathers): the forward and transpose at the
     main shape; the gather-fused forward and both FLASHBLOCKROW kernels
     at the GraSS chunk (d_src = 109 386, d = 4 096, n = 64, k = 1 024) and
     at a bandwidth-sized shape (d_src = 262 144, d = 65 536, n = 1 024,
     k = 4 096), the gathers in both operand layouts; for the row-split
     kernels (the fused, gather-fused and v1 forwards, the compact
     partial, the v1 transpose and FLASHBLOCKROW) also their split R or
     their time over the library's, and for the gather and v1 the time of
     the kernel they replaced (the v1 forward beside the fused forward of
     the same run); the fused transpose on its staged route and, forced,
     on its L2 route in the same run, each with its device time;
  5. GraSS data attribution at the paper's width (784 → 128 → 64 → 10,
     109 386 parameters; sparse dim 4 096, k ∈ {1024, 2048, 4096}, κ = 4,
     s = 2, chunks of 64; 5 000 train and 500 test examples, m = 50 LDS
     retrains at α = 0.5): LDS > 0 at every k; fused features equal to
     unfused ones for ``blockperm`` and ``blockrow``; one gather launch per
     chunk; a NaN-poisoned example quarantined; one warm ``build_cache``
     under ``torch.profiler``; the launch counts of this phase;
  6. every sketch family at the paper's main shape (``paper_main`` of
     ``benchmarks/torch_pareto_bench.py``: d = 65 536, n = 1 024,
     k = 4 096, gaussian data, cond 1e4): ``score_family`` of all eleven
     families, one trial (OSE error on U = orth(A), preconditioned-LSQR
     iterations, warm apply µs), the front; a BlockPerm apply at
     Br = 2 048, whose lowering runs the row-split forward with no
     downgrade (the reference's ``pallas_v1``), its transpose, whose
     lowering takes the L2 route (its stage does not fit shared memory),
     and the same apply under ``impl="cuda_v1"``; a backward under ``impl="cuda_v1"``; FLASHBLOCKROW under ``impl="cuda_v1"``;
     CountSketch's fused gather (== its apply on the materialized gather)
     and backward; the launch counts of this phase, which must show every
     v1 and global kernel.

  7. the distributed path (``repro_torch.distributed``): P = 1 in this
     process, P = 2 and 4 in one spawn of four processes on this card, a
     ``gloo`` group (NCCL refuses two ranks on one device): the P = 2
     checks on the subgroup of ranks {0, 1}, then the P = 4 checks on all
     four (each spawn costs seconds of process start and imports): the
     row-sharded apply at the main plan (fp32, bf16,
     FLASHBLOCKROW) the same bits on every rank (``all_gather``) and for
     every P, and within the policy's tolerance of the single-device
     kernels and of ``impl="torch"``; column- and batch-sharded applies
     (with a ``row_index`` gather) equal to one device; each rank's masked
     partial the same bits under every row split R; at P = 2 GraSS
     featurize batch-sharded at the paper's width equal to one device,
     with a NaN-poisoned example quarantined once; at P = 4 the paper's
     largest shape (d = 262 144, n = 512, k = 2 048) with per-rank kernel,
     all-reduce and fold times beside the single-device forward, and the
     distributed solve of phase 3's problem with the main plan and with
     the default ``plan_for_mesh`` plan, each within ``10·cond·tol`` of
     ``torch.linalg.lstsq``; the launch counts of the phase (all ranks),
     which must show both partial kernels; at P = 4 also the guarded
     distributed solve (``guard=True``: the replica guard over an
     ``all_gather`` of SA, the finite and condition guards), healthy in
     one attempt, x the same bits on every rank and as the unguarded
     solve.  A failure in any rank fails the run.
  8. the tuner, the cost model and the health guards, after every path
     above ran on the fixed rules: ``tune.autotune`` of every variant at
     all six policies on a small plan (every candidate's output
     ``torch.equal`` to the rule's), then timed at the main plan (``fwd``
     fp32 and bf16, ``transpose``, ``blockrow``), at the GraSS chunk
     (``blockrow``; ``fwd_gather`` and ``blockrow_gather`` in the (D, c)
     view) and at the CountSketch plan of the main shape (``fwd``,
     ``fwd_gather``), each
     candidate's (tn, R) with its events and device time, the winner
     beside the rule; ``save_cache`` / ``load_cache`` and the main path's
     entry point running the loaded (tn, R) (a spy on the wrapper, the
     launch count, the rule's bits); ``roofline.hw`` against the card's
     properties and ``engine.cost_of``'s bound and modeled time beside
     every kernel of the kernels line (its bound within 1 % of the
     line's), ``hw.HBM_PER_CHIP`` within 2 % of the card's
     ``total_memory``; the ``default`` preset with ``guard=True`` at the main size
     (healthy in one attempt, x the unguarded solve's bits, its extra wall
     time), once with ``probe=True``, an adversarial input on the card
     recovered in ≥ 2 attempts, and the injector suite on the card.
  9. the sketch server (``repro_torch.serving``) at the main plan, requests
     of n = 128 fp32 columns (32 MiB), groups of at most 8 (a full group
     folds to n = 1 024), queue bound 32: a group of 8 is one launch of
     the row-split forward (a loaded winner of the batched shape class,
     its R not the rule's, reaching the launch: a spy on the wrapper) and
     another seed one of its own, each coalesced result ``torch.equal`` to
     its own launch; one warm guarded group's wall time split (launch,
     guards, the rest; the launch's device time by part under
     ``torch.profiler``; the stack, fold, kernel and the guards' own
     kernels by CUDA events); backpressure driving the
     degrade ladder to each level 1–4 (fp32, bf16, fp8 with stochastic
     rounding, fp8 on the κ = 2 plan), each level's group through the CUDA
     kernel within its policy's tolerance of the plain version, timed
     beside level 1; a NaN operand failed in one attempt, the annihilated
     direction of the κ = 1, s = 1 plan recovered by redraw, the breaker
     tripped and recovered in virtual time; phase 3's problem as a guarded
     solve request, x ``torch.equal`` to the direct call's and within
     ``10·cond·tol`` of ``torch.linalg.lstsq``; the threaded server under
     2 s of Poisson arrivals with faults (no lost response, no silent
     failure, p50 and p99); ``benchmarks/torch_serve_bench.py``'s
     guarded and unguarded runs of one schedule (p50, p99, throughput,
     the guarded overhead).  Its launches are added to row 1's count.
 10. the trainer (``repro_torch.train``) at the full width and depth of
     qwen3-0.6b (28 layers, d_model 1 024, 16 heads, GQA kv 8, head_dim
     128, d_ff 3 072, vocab 151 936; bf16 weights, f32 optimizer state),
     ``launch/train.py``'s defaults (batch 4, seq 128, lr 3e-3) with
     ``--grad-compress 8``, random weights from a seed, 12 steps through
     ``Trainer.fit``: exactly 10 narrow forward and 10 narrow transpose
     launches a step (the five n = 1 plans of the ten compressed leaves; no
     wide launch), no call of a plain version, every loss finite and the mean of the last three below
     the first; the checkpoint of step 12 restored into a fresh Trainer,
     every tensor ``torch.equal`` to the live state, and its first loss
     equal to the live run's at step 12 bit for bit; the step's host wall
     split into forward+backward, compression and optimizer; the CSR bytes
     held and the peak memory; at each of the five plans the narrow
     forward and transpose within fp32's ``exactness_atol`` of their plain
     versions and torch.equal to the forced wide route at every stage
     count, the adjoint identity in fp64 at the embedding's plan, and side
     by side the CUDA-event times of the narrow kernels (at every stage
     count that fits, at most six), the forced wide route and
     ``torch.sparse.mm`` of S (Sᵀ) in CSR at n = 1, ``engine.cost_of``'s
     bound and the CSR floor (the bound plus the CSR read once);
     ``compress_gradients`` on the card held to the CPU for three steps of
     the roll at the smoke config.  Its launches are the narrow rows' of
     the kernels line, whose times are the embedding plan's.
 11. the moe, ssm, hybrid, encdec and vlm families at every width of
     their config files, depth cut (``FAMILY_CUTS``), batch 4, seq 128,
     lr 3e-3, ratio 8, the earlier phases' CSRs cleared first:
     qwen3-moe-30b-a3b (1 layer) through ``Trainer.fit`` for 6 steps with
     its checkpoint restored into a fresh Trainer after the live one is
     freed, the resumed loss ``torch.equal`` to the live one; rwkv6-7b (1
     layer), zamba2-7b (6) and seamless-m4t-large-v2 (1 + 1) compressed
     and llama-3.2-vision-11b (5) uncompressed through ``build_train_step``
     on ``make_train_batch`` batches; each family's launches (one narrow
     forward and one narrow transpose a compressed leaf and step, nothing
     else, no plain version), losses (finite), step split, CSR bytes and
     peak memory; at
     the moe embedding's plan (2.68 G nonzeros, past int32) phase 10's
     n = 1 comparisons (narrow, forced wide, ``torch.sparse.mm``,
     ``cost_of``'s bound, the CSR floor) and the adjoint identity.  Its
     launches are added to the narrow rows.
 12. decode and generation (``launch/generate.py``), phase 11's CSRs
     cleared first: (a) qwen3-0.6b at full width and depth (bf16, random
     weights from a seed) generating at the launcher's defaults (batch 4,
     a prompt of 16 teacher-forced tokens, 32 greedy ones) twice, the
     tokens ``torch.equal`` across the runs and every logit finite; tok/s,
     the median warm ms a step (each step between two synchronisations),
     the weight and KV bytes, the peak memory, one decode step under
     ``torch.profiler`` (device busy, idle share, device operations a
     step); (b) decode == prefill in fp32 (TF32 off) at full width,
     B = 2, S = 8, teacher-forced, for qwen3-0.6b at full depth and each
     family at phase 11's depth cut (``FAMILY_CUTS``), within the
     reference test's tolerance (atol 2e-3, rtol 1e-2; atol 5e-2 for
     rwkv6), zamba2-7b recorded but not gated (its prefill rounds the SSD
     operands to bf16 and misses on the CPU too, ``DECODE_VIA_CPU``); (c)
     qwen3-0.6b's and zamba2-7b's fp32 decode on the card against the same
     code and weights on the CPU, four teacher-forced steps, within (b)'s
     tolerance.  No sketch kernel launches and no plain version runs in
     this phase (decode reaches no TPU kernel in the reference).
 13. the sharding slice (``repro_torch.sharding``, ``launch/mesh.py``,
     the pod-axis mean of ``optim/grad_compress.py``,
     ``train/fault_tolerance.py``): (c) ``train_state_specs`` (compressed)
     and ``decode_state_specs`` (each decode cell) of all ten archs of
     ``configs/registry.py`` on both production meshes, in fake mode:
     leaves and bytes a device holds, the card's memory (allocated and
     peak) unchanged; (a) qwen3-0.6b at full width and depth (bf16) on two
     ranks of a gloo group sharing the card, each the gradient of its half
     of phase 10's batch (2 × 128, ``make_batch(host_id=rank)``),
     compressed at ratio 8 with the mean over the pod axis of a (2,) mesh
     (``pod_axis="pod"``) at step 1, the roll on: ĝ ``torch.equal`` across
     the ranks, the dense leaves the f32 mean, each rank's error state its
     own g′ − ĝ, both within fp32's ``exactness_atol`` of
     γ·Sᵀ((S g′₀ + S g′₁)/2) composed from the same wrappers; one narrow
     forward and one narrow transpose a compressed leaf a rank, no plain
     version, the all-reduced bytes ``wire_bytes``'; each rank's peak
     memory, each leaf's all-reduce ms beside its narrow kernels' ms; (b)
     ``TrainSupervisor`` around the ``Trainer``: qwen3-0.6b at full width
     cut to 2 layers, ratio 8, 6 steps in segments of up to 4 with a
     checkpoint every 2 steps, the second segment raising after its first
     step: 6 steps done, 1 restart, the final parameters, AdamW and error state and every loss
     ``torch.equal`` to an uninterrupted run, the restore times.  The
     launches of (a) and (b) (one narrow forward and one narrow transpose
     a compressed leaf and step, no plain version) are added to the narrow
     rows.
 14. the dry-run and the roofline (``launch/dryrun.py``,
     ``roofline/{hlo_parse,analysis}.py``): (a) ``python -m
     repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
     --multi-pod single --no-skip-existing --also 1x1:4x128`` in a child
     process (the CPU only, ``DRYRUN_OUT`` a temporary directory): exit 0,
     ``"status": "ok"`` for the (16, 16) cell, CUDA never initialised in
     the child, its ``format_row`` printed, this process's
     ``torch.__version__`` printed; (b) meanwhile, in this process,
     qwen3-0.6b (bf16, 28 layers, random weights from a seed) through
     ``build_train_step`` uncompressed at phase 10's batch (4 × 128): two
     warm steps, one under ``torch.profiler`` (device busy, host wall),
     one under ``FlopCounterMode``; the child's ``--also`` record (the same
     step on a one-device mesh) gives the roofline floor, modeled from the
     H100 SXM's published figures, which must not exceed the measured
     device busy time; the walker's flops beside ``FlopCounterMode``'s.
     The model and its state are freed before the phase ends.  No sketch
     kernel launches in this phase (the dry-run compresses nothing).
 15. the train and decode steps over a (data, model) mesh
     (``train_step.shard_*``, ``sharding/spmd.py``), qwen3-0.6b at full
     width (bf16, f32 AdamW) on gloo ranks sharing the card, the
     collectives that gloo lacks for CUDA tensors built by
     ``spmd.gloo_collectives``: (a) 4 ranks on (2, 2), phase 10's batch (4
     × 128) and lr, 3 uncompressed steps from one seed: step 1's loss
     within 2⁻⁸ relative of one device's step on the card; step 1's
     gradients held leaf by leaf, each rank's chunk, to one device's f32
     step (the truth, taken on every rank): each leaf's largest error,
     relative to its largest gradient, within twice one device's own bf16
     error plus 2⁻⁸, and the same check shown to fail for an unchanged
     state and for data shard 0 alone (one device's step on half the
     batch, on rank 1); losses finite and
     equal on every rank; per rank the step walls, the second step under
     ``CommDebugMode``, ``FlopCounterMode`` and a log of the built
     collectives (kind, count, bytes, ms with the device synchronised),
     the third under ``torch.profiler`` (device busy, idle share, the
     largest device times), the peak; (c) the same ranks, fresh weights:
     greedy generation of 8 tokens after 8 (B = 4) over the mesh and on
     one device, every step's logits recorded: each row compared up to
     its first differing token, the mesh's logits within twice one
     device's own bf16 error of the f32 decode (teacher-forced over one
     device's tokens), a differing token only where one device's top-2
     margin is within twice the row's difference; tok/s of both; (b) 2
     ranks on (1, 2), compressed at ratio 8, 3 steps: one narrow forward
     and one narrow transpose a compressed leaf a step a rank, no plain
     version; step 1's loss within 2⁻⁸ of (a)'s one device's; in the
     last step each leaf's ĝ the same bits on both ranks, the gathered
     gradient and error state holding each rank's own chunks, and each
     rank's chunk of the placed ĝ and error state ``torch.equal`` to the
     same chunk (DTensor's rule) of one device's compression of the
     gathered gradient and error state; its launches add to the narrow
     rows;
     (d) meanwhile, in a child (CPU only, at a lower priority),
     ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
     train_4k --multi-pod none --also 2x2:4x128``: the (2, 2) floor must
     not exceed a rank's device busy, the walker's product flops within
     5 % of ``FlopCounterMode``'s over rank 0's step.  At most 150 s.
 16. checkpoints of sharded state and the elastic re-mesh
     (``train/checkpoint.py``'s group save of DTensor leaves and
     ``restore(shardings=)``, ``Trainer(mesh=)``,
     ``launch.mesh.mesh_for_plan``, ``train/fault_tolerance.py``):
     qwen3-0.6b at full width cut to 2 layers (bf16, f32 AdamW), phase
     10's batch (4 × 128) and lr, 4 steps, a checkpoint every 2 (two kept,
     in a temporary directory deleted at the end), ``TrainSupervisor``
     over segments that are each a fresh gloo group of its plan's size:
     (a) uncompressed, ``ElasticPlanner(model_parallel=2)`` over four
     hosts: 4 ranks on (2, 2) to step 3, then the last host's heartbeat
     stops and the segment raises; 2 ranks on (1, 2) restore step 2 and run
     to the end: the report (4 steps, 1 restart, meshes (2, 2), (1, 2)),
     the state restored on (1, 2), gathered, bit-equal (sha256 of every
     leaf) to the state (2, 2) gathered when it saved (parameters, m, v,
     step), the losses equal on every rank of a segment and within 2⁻⁸
     relative of one device's uninterrupted run of the same cut model, no
     sketch kernel launched; (b) compressed at ratio 8 over two hosts:
     (2, 1), then (1, 1): the restored state, error-feedback state
     included, bit-equal to the saved one, one narrow forward and one
     narrow transpose a compressed leaf a step a rank, no plain version.
     Each save's gather, write and publish wait, the bytes each rank
     writes, each restore's seconds, each segment's step walls, the peak
     per rank.  At most 180 s.  Its launches add to the narrow rows.
 17. the example twins (``examples/torch_*.py``), each ``main(argv)``
     called in this process at the example's own full size, the earlier
     phases' CSRs cleared first: quickstart (d = 8 192, n = 256,
     k = 1 024), least_squares (d = 4 096, n = 64, cond 1e4),
     randnla_tasks (d = 8 192, n = 128, k = 1 024), grass_attribution
     ``--full`` (784 → 256 → 256, 1 024 train examples, m = 50, k = 1 024)
     and train_lm ``--preset 100m --grad-compress 8 --steps 300`` (12
     layers, d_model 768, vocab 32 000, f32; the reference docstring's
     300 steps: the compressed loss stays flat for about 140 steps, so at
     100 the last ten steps' mean sat 0.004 below the first ten's, within
     a step's noise, and at 300 it falls by about 1.05).
     For each: the launch counts from zero (``EXAMPLE_KERNELS``: the
     forward, transpose and FLASHBLOCKROW for quickstart, the forward for
     least_squares and randnla_tasks, both gathers for grass, the narrow
     forward and transpose for train_lm, each at least once), no call of a
     plain version, every kernel it launched held element by element to
     its plain version (``PlainHold``: the inputs and output of the first
     launch of each (kernel, plan, n) kept, the plain version run on them
     after the twin, within the plan's exactness_atol x max|plain| as in
     phases 2 and 4), its lines and seconds, and the example's own checks:
     least_squares' asserts; every Gram error and residual of quickstart
     and randnla_tasks finite, their blockperm lines within 1e-4 relative
     of the same twin's ``--device cpu`` run (run first, not counted);
     grass's LDS finite and blockperm's above 0; train_lm's losses finite
     and the last ten steps' mean below the first ten's, and whether the
     reference's drop > 0.5 held.  At most ``EXAMPLES_BUDGET_S``.  Its
     launches add to the kernels line's rows.

Phase 2 also holds the three v1 kernels (ragged n with d < d_pad, κ × s ∈
{1,2,4}², a Br = 2 048 plan, the main plan; each also under every row
split R: the v1 forward within tolerance with S·I == S at a Br = 2 048
plan, the v1 transpose and FLASHBLOCKROW the same bits for every R, at the
main plan too, with Sᵀ·I == Sᵀ) and
the global forward, transpose and gather (CountSketch and graph plans,
ragged n, the CountSketch plan of the main shape) to their plain versions
under all six policies, and at the main shape the plans phase 6 runs
through them: graph (s = 4, one row chunk per block) and localized (κ = 1,
also through the fused forward and transpose); with the exact checks S·I == S for v1 and the
global forward, the adjoint pairs, and global gather == global forward on
the zero-padded materialized gather; phase 4 times them (v1 at the main
plan, with the split R, ÷ lib and device time of the v1 transpose and
FLASHBLOCKROW, the global kernels at the CountSketch plan of the main
shape).  It
holds both partial kernels (phase 7's) to their plain version under all
six policies at the ragged plan, κ × s ∈ {1,2,4}², the main plan and its
``plan_for_mesh`` plan (Br = 1 024, tn = 32), the ranks of P ∈ {1, 2, 4}
emulated in turn: the folded partials equal across P, non-owned pairs of
the masked kernel exact zeros, the masked kernel the same bits under every
row split R, S·I (S_row·I) partials folded == S (S_row); and the
Br = 2 048 plan (``make_plan(65 536, 4 096, kappa=4, block_rows=2048)``,
which the reference sends to its jnp oracle) row-sharded at P = 2 through
the compact kernel, held to the plain partial and to the single-device
apply; and a masked partial whose level's Br·s words would outgrow shared
memory (Br = 8 192, s = 8) at P ∈ {1, 2}, held likewise; phase 4 times
them at the main plan for one rank of P = 4 (M_loc = 8) and for P = 1,
beside ``torch.sparse.mm`` of the rank's slice of S.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc as pygc
import gzip
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
POLICIES = ("float32", "bfloat16", "fp8_e4m3", "fp8_e5m2", "fp8_e4m3_sr",
            "fp8_e5m2_sr")
KERNEL_INFO = {
    "flashsketch_fwd": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
    # the fused transpose's L2 route (plans whose stage does not fit)
    "flashsketch_transpose_l2": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:619"),
    "flashsketch_fwd_gather": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_fwd.cu",
        replaces="src/repro/kernels/flashsketch.py:642"),
    "blockrow_fwd": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:711"),
    "blockrow_fwd_gather": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:682"),
    "flashsketch_fwd_v1": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_v1.cu",
        replaces="src/repro/kernels/flashsketch.py:883"),
    "flashsketch_transpose_v1": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:905"),
    "blockrow_fwd_v1": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:927"),
    # both bodies of the row-sharded partial (distributed slice)
    "flashsketch_fwd_partial": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:736"),
    "blockrow_fwd_partial": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:736"),
    # the global families' branch (_phi_global_tile) of kernels 1-3
    "flashsketch_fwd_global": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose_global": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
    "flashsketch_fwd_gather_global": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:642"),
    # the narrow route at n = 1 (the training path's gradient leaves)
    "flashsketch_fwd_narrow": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose_narrow": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
}
# the kernels of the main path (phase 3) and of the GraSS path (phase 5)
MAIN_KERNELS = ("flashsketch_fwd", "flashsketch_transpose")
GRASS_KERNELS = ("flashsketch_fwd_gather", "blockrow_fwd",
                 "blockrow_fwd_gather")
# the kernels of the family tournament's path (phase 6)
V1_KERNELS = ("flashsketch_fwd_v1", "flashsketch_transpose_v1",
              "blockrow_fwd_v1")
L2_KERNELS = ("flashsketch_transpose_l2",)
GLOBAL_KERNELS = ("flashsketch_fwd_global", "flashsketch_transpose_global",
                  "flashsketch_fwd_gather_global")
# the kernels of the distributed path (phase 7)
PARTIAL_KERNELS = ("flashsketch_fwd_partial", "blockrow_fwd_partial")
# the kernels of the training path (phases 10 and 11: n = 1)
NARROW_KERNELS = ("flashsketch_fwd_narrow", "flashsketch_transpose_narrow")
# ranks of the spawned phase-7 groups; a hung rank fails the run
SPAWN_TIMEOUT_S = 300.0
# GraSS (paper App. E): 109 386-parameter MLP, sparse dim 4 096, κ = 4, s = 2
GRASS_D_SRC, GRASS_D, GRASS_CHUNK, GRASS_K = 109_386, 4096, 64, 1024
# ms of the kernels the row-split and staged designs replaced, as PERF.md
# records them (NVIDIA H100 80GB HBM3 at a 700 W power limit; a range over
# two runs): the gather-fused forward and both FLASHBLOCKROW kernels at the
# GraSS chunk in the (D, c) view, the v1 kernels and the fused transpose at
# the main plan, the masked partial for one rank of P = 4 there, the global
# forward and gather at the CountSketch plan of the main shape
REPLACED_MS = {"flashsketch_transpose": (0.4505, 0.4753),
               "blockrow_fwd_partial": (0.0622, 0.0862),
               "flashsketch_fwd_gather": (0.603, 0.603),
               "flashsketch_fwd_v1": (3.485, 3.485),
               "flashsketch_transpose_v1": (0.847, 0.883),
               "blockrow_fwd_v1": (0.139, 0.149),
               "blockrow_fwd": (0.098, 0.101),
               "blockrow_fwd_gather": (0.097, 0.100),
               "flashsketch_fwd_global": (0.331, 0.338),
               "flashsketch_fwd_gather_global": (0.343, 0.363)}


def replaced(name):
    """'it replaced a ... ms kernel' for ``name``, from REPLACED_MS."""
    lo, hi = REPLACED_MS[name]
    ms = f"{lo}" if lo == hi else f"{lo}-{hi}"
    return f"it replaced a {ms} ms kernel"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed(label, fn, *args):
    """``fn(*args)``, printing its host seconds (the run's time budget)."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"[{label}: {time.perf_counter() - t:.1f} s]")
    return out


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median of ``reps`` timed calls of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of the kernels ``fn`` launches, from
    ``torch.profiler`` over ``reps`` warm calls: at a shape where the host's
    dispatch sets ``cuda_ms``, what the card itself spends."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _err(got, want, plan, what):
    """Max abs error of a kernel against its plain version; raises past
    the plan's exactness_atol x max|plain|."""
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape/finite")
    err = float((got - want).abs().max())
    check(err <= plan.precision.exactness_atol * float(want.abs().max()),
          f"{what}: err {err}")
    return err


def compare_kernels(fsk, ref, plan, n, gen):
    """Max abs error of both kernels against their plain versions at one
    plan, all policies; raises past the policy's tolerance."""
    errs = {}
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        want = ref.flashsketch_ref(p, fsk._stream(p, A).float())
        errs[("flashsketch_fwd", pol)] = _err(
            fsk.flashsketch_fwd(p, A), want, p, f"fwd {pol} {plan.describe()}")
        full = dataclasses.replace(p, d=p.d_pad)    # all d_pad rows
        want = ref.flashsketch_transpose_ref(full, fsk._stream(p, Y).float())
        errs[("flashsketch_transpose", pol)] = _err(
            fsk.flashsketch_transpose(p, Y), want, p,
            f"transpose {pol} {plan.describe()}")
    return errs


def fitting_splits(rt, plan, rows_pattern=False):
    """The row splits R a gather takes at ``plan`` (FLASHBLOCKROW's with
    ``rows_pattern``): every allowed R whose blocks' nonzeros fit shared
    memory."""
    fsk = rt["fsk"]
    return [R for R in fsk.split_allowed(plan)
            if 4 * fsk._csr_block_cap(plan, torch.device("cuda"), R,
                                      rows_pattern) <= fsk.MAX_SMEM_BYTES]


def compare_grass_kernels(rt, plan, n, d_src, gen):
    """The gather-fused forward and both FLASHBLOCKROW kernels against
    their plain versions at one plan, all policies, the gathers in both
    operand layouts (a row-major (d_src, n) source and the (d_src, n) view
    of a row-major (n, d_src) one); plus the exact checks: each gather
    equals its non-gather kernel on the zero-padded materialized gather
    bit for bit, the gather-fused forward under every row split R it
    takes.  Returns the max abs errors by (kernel, policy)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    errs = {}
    layouts = {"rows": torch.randn(d_src, n, generator=gen, device="cuda") * 3,
               "view": torch.randn(n, d_src, generator=gen,
                                   device="cuda").T * 3}
    B = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    ri = torch.randperm(d_src, generator=gen,
                        device="cuda")[:plan.d].sort().values
    rmap = lowering.row_map_for(plan, ri, "cuda")
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        want = ref.blockrow_ref(p, fsk._stream(p, B).float())
        e = _err(fsk.blockrow_fwd(p, B), want, p, f"blockrow_fwd {key}")
        errs[("blockrow_fwd", pol)] = e
        for layout, A in layouts.items():
            G = ref.gather_rows(p, fsk._stream(p, A), rmap)
            Gp = ref.pad_input(p, A[ri])            # zero-padded A[ri]
            for name, plain, flat in (
                    ("flashsketch_fwd_gather", ref.flashsketch_ref,
                     fsk.flashsketch_fwd),
                    ("blockrow_fwd_gather", ref.blockrow_ref,
                     fsk.blockrow_fwd)):
                got = getattr(fsk, name)(p, A, rmap)
                e = _err(got, plain(p, G), p, f"{name} {layout} {key}")
                errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
                want_bits = flat(p, Gp)
                check(torch.equal(got, want_bits),
                      f"{name} {layout} {key}: not bit-equal to "
                      f"{flat.__name__} on the materialized gather")
                if name != "flashsketch_fwd_gather":
                    continue
                for R in fitting_splits(rt, p):
                    check(torch.equal(getattr(fsk, name)(
                        p, A, rmap, row_splits=R), want_bits),
                        f"{name} {layout} {key} R={R}: not bit-equal to "
                        f"{flat.__name__} on the materialized gather")
    return errs


def phase_kernels(rt, main_plan, n_main):
    fsk, ref, blockperm, ops = rt["fsk"], rt["ref"], rt["blockperm"], rt["ops"]
    make_plan = blockperm.make_plan
    gen = torch.Generator(device="cuda").manual_seed(1)
    print("phase 2: kernel vs plain version; tolerance = the policy's "
          "exactness_atol x max|plain| (fp32 sums in another order)")
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]   # ragged, d<d_pad
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    # κ·Br too large to stage in shared memory: the transpose's L2 route
    plans.append((make_plan(8192, 2048, kappa=8, s=2, seed=5), 64))
    worst = {}
    for plan, n in plans:
        for key, err in compare_kernels(fsk, ref, plan, n, gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    main_errs = compare_kernels(fsk, ref, main_plan, n_main, gen)
    for (name, pol), err in sorted(main_errs.items()):
        print(f"  main plan {name:22s} {pol:12s} max_abs_err {err:.3e} "
              f"(small plans worst {worst[(name, pol)]:.3e})")

    # exact: each entry of S·I is one ±scale term
    plan = make_plan(512, 64, kappa=4, s=2, seed=3)
    eye = torch.eye(plan.d, device="cuda")
    SI = ops.sketch_apply(plan, eye)
    S = blockperm.materialize_sketch_matrix(plan, "cuda")[:, :plan.d]
    check(torch.equal(SI, S), "sketch_apply(plan, I) != S")
    # adjoint: <S x, y> == <x, S^T y> to fp32 rounding
    x = torch.randn(plan.d, 3, generator=gen, device="cuda")
    y = torch.randn(plan.k, 3, generator=gen, device="cuda")
    lhs = float((ops.sketch_apply(plan, x).double() * y.double()).sum())
    rhs = float((x.double() * ops.sketch_apply_t(plan, y).double()).sum())
    check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
          f"adjoint: {lhs} vs {rhs}")
    print(f"  exact: sketch_apply(plan, I) == S (torch.equal); "
          f"<Sx,y>={lhs:.9g} <x,S^T y>={rhs:.9g}")
    return {name: main_errs[(name, "float32")] for name in MAIN_KERNELS}


def phase_transpose_routes(rt, main_plan, n):
    """Phase 2 for the fused transpose's two routes at the main plan, every
    policy, n and the ragged n = 1 000 and 37 (TMA boxes, 4-byte cp.async
    and plain loads fill the staged kernel's stages): the staged kernel and
    the L2 route forced, within the policy's tolerance of the plain version
    and the same bits; the staged kernel under every stage count that fits
    and three grids (one block walking every item, 7 blocks, the SMs'),
    the L2 route at every tile and under every row split of its default
    tile, all the same bits; Sᵀ·I == Sᵀ and the adjoint pair with the
    forward on both routes."""
    fsk, ref, ops = rt["fsk"], rt["ref"], rt["ops"]
    blockperm = rt["blockperm"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    print("phase 2 (fused transpose routes): the staged kernel and its L2 "
          "route forced at the main plan, every policy")
    fit = (fsk.MAX_SMEM_BYTES - 128) // (
        fsk.transpose_stage_bytes(main_plan) + 8)
    forced, err_l2 = 0, 0.0
    for nn in (n, 1000, 37):
        Y = torch.randn(main_plan.k_pad, nn, generator=gen,
                        device="cuda") * 3
        for pol in POLICIES:
            p = main_plan.with_dtype(pol)
            key = f"{pol} n={nn}"
            check(fsk.transpose_route(p) == "staged", f"route at {key}")
            staged = fsk.flashsketch_transpose(p, Y, route="staged")
            l2 = fsk.flashsketch_transpose(p, Y, route="l2")
            want = ref.flashsketch_transpose_ref(
                dataclasses.replace(p, d=p.d_pad), fsk._stream(p, Y).float())
            _err(staged, want, p, f"staged transpose {key}")
            e = _err(l2, want, p, f"L2 transpose {key}")
            if pol == "float32" and nn == n:
                err_l2 = e
            check(torch.equal(staged, l2), f"staged != L2 route at {key}")
            for st in range(1, fit + 1):
                for blocks in (1, 7, None):
                    check(torch.equal(fsk.flashsketch_transpose(
                        p, Y, stages=st, blocks=blocks), staged),
                        f"staged stages={st} blocks={blocks} at {key}")
                    forced += 1
            for tn in (32, 64, 128, 256):
                check(torch.equal(fsk.flashsketch_transpose(
                    p, Y, route="l2", tn=tn), staged),
                    f"L2 route tn={tn} at {key}")
                forced += 1
            for R in fsk.split_allowed(p, "transpose"):
                check(torch.equal(fsk.flashsketch_transpose(
                    p, Y, route="l2", row_splits=R), staged),
                    f"L2 route R={R} at {key}")
                forced += 1
        del Y
    eye = torch.eye(main_plan.k_pad, device="cuda")
    St = blockperm.materialize_sketch_matrix(main_plan, "cuda").T
    for route in ("staged", "l2"):
        check(torch.equal(fsk.flashsketch_transpose(main_plan, eye,
                                                    route=route), St),
              f"Sᵀ·I != Sᵀ on the {route} route")
    del eye, St
    x = torch.randn(main_plan.d, 3, generator=gen, device="cuda")
    y = torch.randn(main_plan.k, 3, generator=gen, device="cuda")
    lhs = float((ops.sketch_apply(main_plan, x).double() * y.double()).sum())
    yp = ref.pad_rows(y, main_plan.k_pad)
    for route in ("staged", "l2"):
        Xt = fsk.flashsketch_transpose(main_plan, yp, route=route)
        rhs = float((x.double() * Xt[:main_plan.d].double()).sum())
        check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
              f"adjoint on the {route} route: {lhs} vs {rhs}")
    print(f"  {main_plan.describe()}: staged == L2 route (torch.equal) at "
          f"n in ({n}, 1000, 37), all policies, both within tolerance of "
          f"the plain version; the same bits under {forced} forced launches "
          f"(stages 1..{fit} x grids (1, 7, the SMs'), L2 tiles 32-256, L2 "
          f"R in {fsk.split_allowed(main_plan, 'transpose')}); Sᵀ·I == Sᵀ "
          f"and <Sx,y> == <x,Sᵀy> on both routes; L2 route fp32 max_abs_err "
          f"{err_l2:.3e}")
    return {"flashsketch_transpose_l2": err_l2}


def phase_narrow_kernels(rt, main_plan):
    """Phase 2 for the narrow kernels at n = 1: at the ragged plan (d <
    d_pad), κ × s ∈ {1, 2, 4}² and the main plan, every policy, each narrow
    kernel within the policy's tolerance of its plain version and
    torch.equal to the forced wide route (the row-split forward, the staged
    transpose) under every stage count that fits and two grids (one block
    walking every output block through its ring, and the SMs'), and on
    operands off 16-byte alignment (the 4-byte cp.async and load copy
    modes); the adjoint pair on the narrow route at the main plan."""
    fsk, ref, make_plan = rt["fsk"], rt["ref"], rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(14)
    print("phase 2 (narrow kernels): n = 1, every policy, against the plain "
          "versions and the forced wide route")
    plans = [make_plan(1000, 96, kappa=4, s=2, seed=1)]
    plans += [make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    plans.append(main_plan)
    worst, forced, modes = {}, 0, {}
    for plan in plans:
        a = torch.randn(plan.d_pad, 1, generator=gen, device="cuda") * 3
        y = torch.randn(plan.k_pad, 1, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            key = f"{pol} {plan.describe()}"
            full = dataclasses.replace(p, d=p.d_pad)
            for op, fn, x, plain in (
                    ("fwd", fsk.flashsketch_fwd, a,
                     lambda x_: ref.flashsketch_ref(p, x_)),
                    ("transpose", fsk.flashsketch_transpose, y,
                     lambda x_: ref.flashsketch_transpose_ref(full, x_))):
                check(fsk.narrow_fits(p, op), f"narrow {op} at {key}")
                name = f"flashsketch_{op}_narrow"
                before = fsk.LAUNCHES[name]
                got = fn(p, x)
                check(fsk.LAUNCHES[name] == before + 1,
                      f"{op} at {key}: not the narrow route")
                e = _err(got, plain(fsk._stream(p, x).float()), p,
                         f"narrow {op} {key}")
                worst[op, pol] = max(worst.get((op, pol), 0.0), e)
                want = fn(p, x, route="wide")
                check(torch.equal(got, want),
                      f"narrow {op} != the wide route at {key}")
                fit = (fsk.MAX_SMEM_BYTES - 128) // (
                    fsk.narrow_stage_bytes(p, op) + 8)
                for st in range(1, fit + 1):
                    for blocks in (1, None):
                        check(torch.equal(fn(p, x, route="narrow", stages=st,
                                             blocks=blocks), want),
                              f"narrow {op} stages={st} blocks={blocks} at "
                              f"{key}")
                        forced += 1
        # operands off 16-byte alignment: 4-byte cp.async (fp32 or bf16 4
        # bytes off) and plain loads (bf16 2 bytes off) fill the stages
        for pol, off in (("float32", 1), ("bfloat16", 2), ("bfloat16", 1)):
            p = plan.with_dtype(pol)
            for op, fn, x in (("fwd", fsk.flashsketch_fwd, a),
                              ("transpose", fsk.flashsketch_transpose, y)):
                src = fsk._stream(p, x)
                view = torch.empty(src.shape[0] + off, 1, dtype=src.dtype,
                                   device="cuda")[off:]
                view.copy_(src)
                mode = 1 if view.data_ptr() % 4 == 0 else 2
                check(view.data_ptr() % 16 != 0, "an aligned view")
                modes[mode] = modes.get(mode, 0) + 1
                check(torch.equal(fn(p, view), fn(p, view, route="wide")),
                      f"narrow {op} {pol} {off} element(s) off alignment "
                      f"(copy mode {mode}) != the wide route at "
                      f"{plan.describe()}")
    x = torch.randn(main_plan.d, 1, generator=gen, device="cuda")
    y = torch.randn(main_plan.k, 1, generator=gen, device="cuda")
    lhs = float((rt["ops"].sketch_apply(main_plan, x).double()
                 * y.double()).sum())
    rhs = float((x.double() * rt["ops"].sketch_apply_t(
        main_plan, y).double()).sum())
    check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
          f"adjoint on the narrow route: {lhs} vs {rhs}")
    check(set(modes) == {1, 2}, f"copy modes exercised: {modes}")
    print(f"  {len(plans)} plans x {len(POLICIES)} policies: narrow == wide "
          f"(torch.equal) under {forced} forced launches (every stage count "
          f"that fits x grids (1, the SMs')), and on operands off 16-byte "
          f"alignment ({modes[1]} launches by 4-byte cp.async, {modes[2]} by "
          f"loads; the rest by bulk copies); <Sx,y> == <x,Sᵀy> at the main "
          f"plan, n = 1 ({lhs:.9g}, {rhs:.9g})")
    for op in ("fwd", "transpose"):
        errs = {pol: f"{worst[op, pol]:.2e}" for pol in POLICIES}
        print(f"  narrow {op}: worst err vs plain by policy {errs}")


def dense_blockrow(rt, plan):
    """FLASHBLOCKROW's S_row of ``plan``, (k_pad, d_pad) on the card, scaled:
    its nonzeros (collisions added) from ``blockrow_entries``."""
    rows, cols, signs = blockrow_entries(rt, plan)
    S = torch.zeros(plan.k_pad, plan.d_pad, device="cuda")
    S.index_put_((rows, cols), signs, accumulate=True)
    return S * rt["fsk"].blockrow_scale(plan)


def phase_fwd_splits(rt, main_plan, n):
    """The forwards of split_vec_kernel under every row split R: the fused
    forward at the main plan and at a Br = 32, Bc = 8 192 plan (2 048
    nonzeros a row), FLASHBLOCKROW at the main plan and the GraSS chunk's
    plan, the global forward at the CountSketch and graph plans of the main
    shape (phase 6's): within each policy's tolerance of its plain version
    and the same bits for every R; exact: S·E == S[:, slab] for two slabs E
    of 1 024 columns of the identity (every entry a sum of ±1, then ×
    scale), and each gather == its forward on the zero-padded materialized
    gather under every R the gather takes, in both source layouts."""
    fsk, ref, blockperm = rt["fsk"], rt["ref"], rt["blockperm"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    d, k = main_plan.d, main_plan.k_req
    wide = blockperm.make_plan(d, 256, kappa=4, s=2, seed=0)
    check((wide.Br, wide.Bc) == (32, 8192), f"wide plan {wide.describe()}")
    count = blockperm.make_plan(d, k, family="countsketch", s=1, seed=0)
    graph = rt["variants"].make_sketch(
        "graph", d, k, seed=0, **rt["pareto"].FAMILY_KWARGS["graph"]).plan
    grass = blockperm.make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    fused = (fsk.flashsketch_fwd, fsk.flashsketch_fwd_gather,
             ref.flashsketch_ref)
    kinds = {"fused": fused, "global": fused,
             "blockrow": (fsk.blockrow_fwd, fsk.blockrow_fwd_gather,
                          ref.blockrow_ref)}
    print("phase 2 (row-split forwards): every row split R, every policy")
    worst = {}
    for kind, plan in (("fused", main_plan), ("fused", wide),
                       ("blockrow", main_plan), ("blockrow", grass),
                       ("global", count), ("global", graph)):
        fwd, gather, plain = kinds[kind]
        rows = kind == "blockrow"
        what = f"{fwd.__name__} {plan.describe()}"
        splits = fsk.split_allowed(plan)
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            want = plain(p, fsk._stream(p, A).float())
            base = fwd(p, A)
            err = _err(base, want, p, f"{what} {pol}")
            worst[kind, pol] = max(worst.get((kind, pol), 0.0), err)
            for R in splits:
                check(torch.equal(fwd(p, A, row_splits=R), base),
                      f"{what} {pol} R={R}: bits differ from the default "
                      f"split")
        del A
        S = dense_blockrow(rt, plan) if rows else \
            blockperm.materialize_sketch_matrix(plan, "cuda")
        for c0 in (0, plan.d_pad // 2 + 512):
            E = torch.zeros(plan.d_pad, 1024, device="cuda")
            E[torch.arange(c0, c0 + 1024, device="cuda"),
              torch.arange(1024, device="cuda")] = 1.0
            for R in splits:
                check(torch.equal(fwd(plan, E, row_splits=R),
                                  S[:, c0:c0 + 1024]),
                      f"S·E != S: {what} R={R} columns {c0}+")
        del S, E
        gsplits = fitting_splits(rt, plan, rows)
        ri = torch.randperm(2 * plan.d, generator=gen,
                            device="cuda")[:plan.d].sort().values
        rmap = rt["lowering"].row_map_for(plan, ri, "cuda")
        for layout in ("rows", "view"):
            src = (torch.randn(2 * plan.d, n, generator=gen, device="cuda")
                   if layout == "rows" else
                   torch.randn(n, 2 * plan.d, generator=gen, device="cuda").T)
            flat = fwd(plan, ref.pad_input(plan, src[ri]))
            for R in gsplits:
                check(torch.equal(gather(plan, src, rmap, row_splits=R),
                                  flat),
                      f"{gather.__name__} {layout} R={R} at "
                      f"{plan.describe()}: not bit-equal to the forward on "
                      f"the materialized gather")
            del src, flat
        tn = fsk.fwd_tn(plan, n)
        print(f"  {what} n={n}: R in {splits} the same bits (default "
              f"R={fsk.vec_splits(plan, tn)}, tn={tn}); S·E == S on 2 slabs "
              f"of 1 024 columns under every R; {gather.__name__} == the "
              f"forward on the materialized gather under R in {gsplits}, "
              f"both layouts")
    for kind in kinds:
        print(f"  {kind}: worst err vs plain by policy "
              f"{ {pol: f'{worst[kind, pol]:.2e}' for pol in POLICIES} }")


def phase_grass_kernels(rt):
    fsk, ref, make_plan = rt["fsk"], rt["ref"], rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the GraSS path's kernels: ragged n with d < d_pad, κ × s ∈ {1,2,4}²,
    # a non-power-of-two Bc (blockrow's hash_mod is a true modulo), and the
    # GraSS chunk itself
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37, 3000)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100, 9000)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    odd = make_plan(3000, 64, kappa=2, s=2, seed=7)
    check(odd.Bc & (odd.Bc - 1) != 0, f"Bc={odd.Bc} is a power of two")
    plans.append((odd, 33, 5000))
    worst = {}
    for plan, n, d_src in plans:
        for key, err in compare_grass_kernels(rt, plan, n, d_src,
                                              gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    grass_plan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    grass_errs = compare_grass_kernels(rt, grass_plan, GRASS_CHUNK,
                                       GRASS_D_SRC, gen)
    for (name, pol), err in sorted(grass_errs.items()):
        print(f"  GraSS chunk {name:22s} {pol:12s} max_abs_err {err:.3e} "
              f"(small plans worst {worst[(name, pol)]:.3e})")
    print(f"  exact: every gather == its kernel on the zero-padded "
          f"materialized gather (torch.equal), both layouts, all policies, "
          f"{len(plans) + 1} plans, Bc={odd.Bc} among them; the gather-fused "
          f"forward under every row split R that fits (GraSS chunk: R in "
          f"{fitting_splits(rt, grass_plan)})")
    # an identity row_index is the non-gather kernel
    p, n = plans[0][0], 37
    A = torch.randn(p.d, n, generator=gen, device="cuda")
    rmap = rt["lowering"].row_map_for(p, torch.arange(p.d), "cuda")
    Ap = ref.pad_input(p, A)
    check(torch.equal(fsk.flashsketch_fwd_gather(p, A, rmap),
                      fsk.flashsketch_fwd(p, Ap)), "identity gather (fwd)")
    check(torch.equal(fsk.blockrow_fwd_gather(p, A, rmap),
                      fsk.blockrow_fwd(p, Ap)), "identity gather (blockrow)")
    print("  exact: identity row_index == the non-gather kernel, both "
          "families")
    return {name: grass_errs[(name, "float32")] for name in GRASS_KERNELS}


def compare_family_kernels(rt, plan, n, gen):
    """The v1 kernels (every plan) and the global forward, transpose and
    gather (global plans) against their plain versions at one plan, all
    policies; the global gather in both source layouts, and equal bit for
    bit to the global forward on the zero-padded materialized gather.
    Returns the max abs errors by (kernel, policy)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    errs = {}
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
    full = dataclasses.replace(plan, d=plan.d_pad)    # all d_pad rows
    if plan.is_global:
        d_src = 3 * plan.d
        layouts = {
            "rows": torch.randn(d_src, n, generator=gen, device="cuda") * 3,
            "view": torch.randn(n, d_src, generator=gen,
                                device="cuda").T * 3}
        ri = torch.randperm(d_src, generator=gen,
                            device="cuda")[:plan.d].sort().values
        rmap = lowering.row_map_for(plan, ri, "cuda")
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        x = fsk._stream(p, A).float()
        y = fsk._stream(p, Y).float()
        got = {"flashsketch_fwd_v1": (fsk.flashsketch_fwd_v1(p, A),
                                      ref.flashsketch_v1_ref(p, x)),
               "flashsketch_transpose_v1": (
                   fsk.flashsketch_transpose_v1(p, Y),
                   ref.flashsketch_transpose_v1_ref(full, y))}
        if plan.is_global:
            got["flashsketch_fwd_global"] = (fsk.flashsketch_fwd(p, A),
                                             ref.flashsketch_ref(p, x))
            got["flashsketch_transpose_global"] = (
                fsk.flashsketch_transpose(p, Y),
                ref.flashsketch_transpose_ref(full, y))
        else:
            got["blockrow_fwd_v1"] = (fsk.blockrow_fwd_v1(p, A),
                                      ref.blockrow_v1_ref(p, x))
        for name, (kernel, plain) in got.items():
            errs[(name, pol)] = _err(kernel, plain, p, f"{name} {key}")
        if not plan.is_global:
            continue
        for layout, src in layouts.items():
            name = "flashsketch_fwd_gather_global"
            out = fsk.flashsketch_fwd_gather(p, src, rmap)
            e = _err(out, ref.flashsketch_ref(
                p, ref.gather_rows(p, fsk._stream(p, src), rmap)), p,
                f"{name} {layout} {key}")
            errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
            check(torch.equal(out, fsk.flashsketch_fwd(
                p, ref.pad_input(p, src[ri]))),
                f"{name} {layout} {key}: not bit-equal to the global "
                f"forward on the materialized gather")
    return errs


def phase_family_kernels(rt, main_plan, n_main):
    """Phase 2 for the v1 kernels and the global families."""
    fsk, blockperm, ops = rt["fsk"], rt["blockperm"], rt["ops"]
    make_plan = blockperm.make_plan
    gen = torch.Generator(device="cuda").manual_seed(5)
    # v1: ragged n with d < d_pad, κ × s ∈ {1,2,4}², a Br = 2 048 plan
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    plans.append((make_plan(65536, 4096, kappa=4, s=2, block_rows=2048), 64))
    # global: CountSketch (s = 1, Bc = 125) and graph (s = 4; two row
    # chunks meet each output block, and the default M = 1 plan), ragged n
    plans += [(make_plan(1000, 256, family="countsketch", s=1,
                         block_rows=32, seed=2), 37),
              (make_plan(1000, 128, family="graph", s=4, block_rows=64,
                         seed=4), 37),
              (make_plan(700, 64, family="graph", s=4, seed=4), 33)]
    worst = {}
    for plan, n in plans:
        for key, err in compare_family_kernels(rt, plan, n, gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    # the main shape: the solver's plan, CountSketch (s = 1), and the
    # tournament's graph (s = 4, one row chunk per block, i_lo > 0) and
    # localized (κ = 1) plans, as phase 6 builds them; localized also
    # through the fused forward and transpose, which phase 6 runs for it
    d, k = main_plan.d, main_plan.k_req
    tour = {fam: rt["variants"].make_sketch(
        fam, d, k, seed=0, **rt["pareto"].FAMILY_KWARGS[fam]).plan
        for fam in ("graph", "localized")}
    main_plans = {"main": main_plan,
                  "countsketch": make_plan(d, k, family="countsketch", s=1,
                                           seed=0), **tour}
    main_errs = {}
    for label, plan in main_plans.items():
        errs = compare_family_kernels(rt, plan, n_main, gen)
        if label == "localized":
            errs.update(compare_kernels(fsk, rt["ref"], plan, n_main, gen))
        print(f"  main shape, {label} plan {plan.describe()}, n={n_main}:")
        for (name, pol), err in sorted(errs.items()):
            small = (f" (small plans worst {worst[name, pol]:.3e})"
                     if (name, pol) in worst else "")
            print(f"    {name:30s} {pol:12s} max_abs_err {err:.3e}{small}")
            main_errs[(name, pol)] = max(main_errs.get((name, pol), 0.0), err)
    # exact: each entry of S·I is one ±scale term, for v1 and the global
    # forward; adjoint pairs to fp32 rounding
    for plan in (make_plan(512, 64, kappa=4, s=2, seed=3),
                 make_plan(512, 64, family="countsketch", s=1, seed=3),
                 plans[-2][0]):
        eye = torch.eye(plan.d_pad, device="cuda")
        S = blockperm.materialize_sketch_matrix(plan, "cuda")
        check(torch.equal(fsk.flashsketch_fwd_v1(plan, eye), S),
              f"v1 S·I != S at {plan.describe()}")
        if plan.is_global:
            check(torch.equal(fsk.flashsketch_fwd(plan, eye), S),
                  f"global S·I != S at {plan.describe()}")
        x = torch.randn(plan.d, 3, generator=gen, device="cuda")
        y = torch.randn(plan.k, 3, generator=gen, device="cuda")
        for impl in ("cuda_v1", "auto"):
            lhs = float((ops.sketch_apply(plan, x, impl).double()
                         * y.double()).sum())
            rhs = float((x.double() * ops.sketch_apply_t(
                plan, y, impl).double()).sum())
            check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
                  f"adjoint {impl} {plan.describe()}: {lhs} vs {rhs}")
    # the v1 forward's row split forced to every R: S·I == S at a Br = 2 048
    # plan, within each policy's tolerance of its plain version elsewhere
    tall = make_plan(4096, 4096, kappa=4, s=2, block_rows=2048, seed=5)
    eye = torch.eye(tall.d_pad, device="cuda")
    S = blockperm.materialize_sketch_matrix(tall, "cuda")
    for R in fsk.split_allowed(tall):
        check(torch.equal(fsk.flashsketch_fwd_v1(tall, eye, row_splits=R), S),
              f"v1 S·I != S at {tall.describe()} R={R}")
    # the v1 transpose and FLASHBLOCKROW (split_vec_kernel's v1 mode): the
    # same bits under every row split R at every policy; Sᵀ·I == Sᵀ under
    # every R (at the main plan the default R)
    v1_vec = 0
    for plan, n in [pn for pn in plans[:11] if not pn[0].is_global] + [
            (main_plan, n_main)]:
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            for fn, arg, op in ((fsk.flashsketch_transpose_v1, Y, "transpose"),
                                (fsk.blockrow_fwd_v1, A, "blockrow")):
                base = fn(p, arg)
                for R in fsk.split_allowed(p, op):
                    check(torch.equal(fn(p, arg, row_splits=R), base),
                          f"{fn.__name__} {pol} {p.describe()} n={n} R={R}: "
                          f"bits differ from the default split")
                    v1_vec += 1
        del A, Y
    for plan in (make_plan(512, 64, kappa=4, s=2, seed=3), tall, main_plan):
        eye = torch.eye(plan.k_pad, device="cuda")
        St = blockperm.materialize_sketch_matrix(plan, "cuda").T
        for R in (fsk.split_allowed(plan, "transpose") if plan is not main_plan
                  else (None,)):
            check(torch.equal(fsk.flashsketch_transpose_v1(
                plan, eye, row_splits=R), St),
                f"v1 Sᵀ·I != Sᵀ at {plan.describe()} R={R}")
        del eye, St
    forced = 0
    for plan, n in plans[:11]:
        if plan.is_global:
            continue
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            want = rt["ref"].flashsketch_v1_ref(p, fsk._stream(p, A).float())
            for R in fsk.split_allowed(p):
                _err(fsk.flashsketch_fwd_v1(p, A, row_splits=R), want, p,
                     f"flashsketch_fwd_v1 {pol} {p.describe()} R={R}")
                forced += 1
    print(f"  exact: v1 and global S·I == S (torch.equal), v1 also at "
          f"{tall.describe()} under every row split R in "
          f"{fsk.split_allowed(tall)}; <Sx,y> == <x,S^T y> for v1 and the "
          f"global pair; global gather == global forward on the zero-padded "
          f"materialized gather, both layouts, all policies, "
          f"{len(plans) + 2} plans; v1 within tolerance under every forced "
          f"R ({forced} launches, all policies); the v1 transpose and "
          f"FLASHBLOCKROW the same bits under every forced R ({v1_vec} "
          f"launches, all policies, the main plan among them) and v1 "
          f"Sᵀ·I == Sᵀ (torch.equal) under every R at 2 plans, at the "
          f"default R at the main plan")
    return {name: main_errs[(name, "float32")]
            for name in V1_KERNELS + GLOBAL_KERNELS}


def sharded_serial(rt, plan, A, P, rows):
    """The row-sharded apply of P ranks in turn in one process: the ranks'
    partials summed (what the all_reduce does), folded in ℓ order."""
    dist_ = rt["dist"]
    M_loc = plan.M // P
    acc = None
    for r in range(P):
        parts = dist_.local_partial_apply(
            plan, dist_.shard_rows(plan, A, r, P), r * M_loc,
            rows_pattern=rows)
        acc = parts if acc is None else acc + parts
    scale = rt["fsk"].blockrow_scale(plan) if rows else plan.scale
    return rt["fold"](acc, plan, scale)


def compare_partial_kernels(rt, plan, n, gen, shards=(1, 2, 4)):
    """Both partial kernels against their plain version at one plan, all
    policies, in-process (the ranks emulated in turn, no process group),
    on every rank of the largest shard count of ``shards`` that divides M;
    plus the exact checks: non-owned pairs of the masked kernel are exact
    zeros, the masked kernel is the same bits under every row split R, and
    the partials of P shards, summed and folded, are the same bits for
    every P of ``shards`` dividing M.  Returns the max abs errors by
    (kernel, policy) and the count of forced-R launches."""
    fsk, ref, dist_ = rt["fsk"], rt["ref"], rt["dist"]
    errs, forced = {}, 0
    A = torch.randn(plan.d, n, generator=gen, device="cuda") * 3
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        for rows, name in ((False, "flashsketch_fwd_partial"),
                           (True, "blockrow_fwd_partial")):
            counts = [P for P in shards if p.M % P == 0]
            P = counts[-1]
            M_loc = p.M // P
            for r in range(P):
                slab = dist_.shard_rows(p, A, r, P)
                tab = dist_.partial_tables(p, r * M_loc, M_loc, rows, "cuda")
                got = fsk.flashsketch_partial(p, slab, tab, rows_pattern=rows)
                e = _err(got, ref.partial_ref(p, fsk._stream(
                    p, slab).float(), tab, rows), p,
                    f"{name} P={P} rank {r} {key}")
                errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
                if rows:
                    owned = tab[2].bool().repeat_interleave(p.Br, 1)
                    check(bool((got[~owned] == 0).all()),
                          f"{name} {key}: a non-owned pair is not 0")
                    for R in fsk.split_allowed(p):
                        check(torch.equal(fsk.flashsketch_partial(
                            p, slab, tab, rows_pattern=True, row_splits=R),
                            got), f"{name} P={P} rank {r} {key} R={R}: "
                            f"bits differ from the default split")
                        forced += 1
            outs = [sharded_serial(rt, p, A, P, rows) for P in counts]
            check(all(torch.equal(o, outs[0]) for o in outs),
                  f"{name} {key}: folded partials differ across P")
    return errs, forced


def phase_partial_kernels(rt, main_plan, n_main):
    """Phase 2 for the two partial kernels: ragged n with d < d_pad,
    κ × s ∈ {1,2,4}², the main plan and its plan_for_mesh plan (Br = 1 024,
    tn = 32); the sharded results held to the fused forward and
    FLASHBLOCKROW within the policy's tolerance; S·I folded == S."""
    fsk, ops, dist_ = rt["fsk"], rt["ops"], rt["dist"]
    make_plan = rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(8)
    print("phase 2 (partial kernels): each rank's partials against the "
          "plain version (the ranks of the largest P in {1, 2, 4} dividing "
          "M, in turn), the folded partials across P")
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    d, k = main_plan.d, main_plan.k_req
    mesh_plan = dist_.plan_for_mesh(d, k, 4, kappa=4)
    worst, forced = {}, 0
    for plan, n in plans + [(main_plan, n_main), (mesh_plan, n_main)]:
        errs, f = compare_partial_kernels(rt, plan, n, gen)
        forced += f
        for key, e in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
        if plan in (main_plan, mesh_plan):
            for (name, pol), e in sorted(errs.items()):
                print(f"  {plan.describe()} n={n} {name:24s} {pol:12s} "
                      f"max_abs_err {e:.3e}")
        if plan is main_plan:
            main_errs = errs
    # the sharded results against the single-device kernels
    A = torch.randn(d, n_main, generator=gen, device="cuda")
    for plan in (main_plan, mesh_plan):
        for rows, fn in ((False, ops.sketch_apply), (True, ops.blockrow_apply)):
            for pol in ("float32", "bfloat16"):
                p = plan.with_dtype(pol)
                got = sharded_serial(rt, p, A, 4, rows)
                e = _err(got, fn(p, A), p, f"sharded vs fused {pol} "
                         f"{'blockrow' if rows else 'fwd'} {p.describe()}")
                print(f"  {p.describe()} P=4 {'blockrow' if rows else 'fwd':8s}"
                      f" {pol:9s} vs the single-device kernel max_abs_err "
                      f"{e:.3e}")
    plan = make_plan(512, 64, kappa=4, s=2, seed=3)
    eye = torch.eye(plan.d_pad, device="cuda")
    S = rt["blockperm"].materialize_sketch_matrix(plan, "cuda")
    S_row = dense_blockrow(rt, plan)
    for P in (1, 2, 4):
        check(torch.equal(sharded_serial(rt, plan, eye, P, False), S[:plan.k]),
              f"S·I partials folded != S at P={P}")
        check(torch.equal(sharded_serial(rt, plan, eye, P, True),
                          S_row[:plan.k]),
              f"S_row·I masked partials folded != S_row at P={P}")
    # the Br = 2 048 plan the reference sends to its jnp oracle: row-sharded
    # at P = 2 through the compact kernel
    f1 = make_plan(d, k, kappa=4, block_rows=2048, seed=0)
    lw = rt["lowering"].lower(f1, rt["lowering"].LaunchSpec(
        n=64, device="cuda", shard="row", devices=2))
    check(lw.impl == "cuda" and lw.downgrade is None,
          f"Br=2048 row-sharded lowering {lw.describe()}")
    f1_errs, f = compare_partial_kernels(rt, f1, 64, gen, shards=(1, 2))
    forced += f
    A = torch.randn(d, 64, generator=gen, device="cuda")
    for pol in POLICIES:
        p = f1.with_dtype(pol)
        got = sharded_serial(rt, p, A, 2, False)
        e = _err(got, ops.sketch_apply(p, A), p,
                 f"Br=2048 P=2 sharded vs single device {pol}")
        print(f"  {p.describe()} P=2 {pol:12s} partial vs plain "
              f"{f1_errs[('flashsketch_fwd_partial', pol)]:.3e}, sharded vs "
              f"the single-device apply {e:.3e}")
    # a masked partial whose level's Br·s words (65 536) would outgrow
    # shared memory: the row-split kernel reads S_row's CSR where it lies
    big_rows = make_plan(16_384, 16_384, kappa=2, s=8, block_rows=8192,
                         seed=4)
    lw = rt["lowering"].lower(big_rows, rt["lowering"].LaunchSpec(
        op="blockrow", n=40, device="cuda", shard="row", devices=2))
    check(lw.impl == "cuda" and lw.downgrade is None and lw.smem_bytes == 0
          and lw.row_splits == fsk.masked_splits(big_rows, lw.tn),
          f"tall masked partial lowering {lw.describe()}")
    chunk_errs, f = compare_partial_kernels(rt, big_rows, 40, gen,
                                            shards=(1, 2))
    forced += f
    A = torch.randn(big_rows.d, 40, generator=gen, device="cuda")
    for pol in ("float32", "bfloat16"):
        p = big_rows.with_dtype(pol)
        e = _err(sharded_serial(rt, p, A, 2, True), ops.blockrow_apply(p, A),
                 p, f"chunked masked partial P=2 vs single device {pol}")
        print(f"  {p.describe()} masked partial R={lw.row_splits}, "
              f"{pol:9s} vs plain "
              f"{chunk_errs[('blockrow_fwd_partial', pol)]:.3e}, P=2 sharded "
              f"vs the single-device apply {e:.3e}")
    print(f"  exact: {len(plans) + 2} plans x 6 policies: folded partials "
          f"equal across P (torch.equal), non-owned masked pairs exact "
          f"zeros, the masked partial the same bits under every forced R "
          f"({forced} launches), S·I partials folded == S and S_row·I "
          f"masked partials folded == S_row at P in (1, 2, 4); small plans "
          f"worst err "
          f"{ {k: f'{v:.2e}' for k, v in worst.items() if k[1] == 'float32'} }")
    return {name: main_errs[(name, "float32")] for name in PARTIAL_KERNELS}


# ---------------------------------------------------------------------------
# Phase 3: the main path.
# ---------------------------------------------------------------------------

def make_ls_problem(d, n, cond, seed=0):
    """Tall (d, n) float64 problem with cond(A) = ``cond`` and a consistent
    right-hand side, built on the card from a seeded generator (the
    construction of benchmarks/randnla_bench.py:make_ls_problem)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(dtype=torch.float64, device="cuda", generator=gen)
    U, _ = torch.linalg.qr(torch.randn(d, n, **opts))
    V, _ = torch.linalg.qr(torch.randn(n, n, **opts))
    svals = torch.logspace(0.0, -math.log10(cond), n, dtype=torch.float64,
                           device="cuda")
    A = (U * svals) @ V.T
    x_true = torch.randn(n, **opts)
    return A, A @ x_true


def profile_solve(solvers, A, b, name, warm_wall):
    """Device time by kernel over one more solve (``torch.profiler``), and
    the share of the unprofiled solve's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solvers.solve_preset(A, b, name, device="cuda")
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"  profile of {name}: the profiler recorded no device time "
              f"(busy share not measured)")
        return
    print(f"  profile of {name}: device busy {busy_ms:.3f} ms of the "
          f"second solve's {warm_wall * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (warm_wall * 1e3):.3f}); kernels by device time:")
    for e in kernels[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def phase_main_path(rt, main_plan, d, n, cond):
    solvers, ops, fsk, ref = rt["solvers"], rt["ops"], rt["fsk"], rt["ref"]
    presets = rt["presets"]
    print(f"phase 3: main path at d={d}, n={n}, cond={cond:g}, float64 "
          f"iterations")
    t = time.perf_counter()
    A, b = make_ls_problem(d, n, cond)
    x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    torch.cuda.synchronize()
    print(f"  problem + torch.linalg.lstsq reference: "
          f"{time.perf_counter() - t:.1f} s")
    fsk.reset_launch_counts()
    per_solve, warm = {}, {}
    for name in ("default", "fast", "precise"):
        walls = []
        for _ in range(2):      # the first solve also sets up the libraries
            before = dict(fsk.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solvers.solve_preset(A, b, name, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm[name] = walls[1]
        tol = presets[name].tol
        err = float(torch.linalg.vector_norm(res.x - x_ref)
                    / torch.linalg.vector_norm(x_ref))
        per_solve[name] = {k: fsk.LAUNCHES[k] - before[k] for k in before}
        print(f"  {name:8s} iterations {res.iterations:4d} relres "
              f"{res.relres:.3e} (tol {tol:g}) |x-x_lstsq|/|x_lstsq| "
              f"{err:.3e} (bound {10 * cond * tol:.0e}) wall {walls[0]:.4f} s "
              f"first, {walls[1]:.4f} s second; launches per solve "
              f"{per_solve[name]} "
              f"{res.lowering.describe() if res.lowering else ''}")
        check(res.converged and res.relres <= tol,
              f"{name}: not converged ({res.relres})")
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
              f"{name}: x not finite / wrong shape")
        check(err <= 10 * cond * tol, f"{name}: error {err} vs lstsq")
    profile_solve(solvers, A, b, "default", warm["default"])
    # one autograd backward and one transpose apply
    A32 = A.to(torch.float32).requires_grad_(True)
    Y = ops.sketch_apply(main_plan, A32)
    (Y ** 2).sum().backward()
    want = ref.flashsketch_transpose_ref(main_plan, 2 * Y.detach())
    gerr = float((A32.grad - want).abs().max())
    check(gerr <= 1e-5 * float(want.abs().max()), f"backward err {gerr}")
    X = ops.sketch_apply_t(main_plan, Y.detach())
    check(X.shape == (d, n) and bool(torch.isfinite(X).all()),
          "sketch_apply_t shape/finite")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  backward of ||S A||^2: max err vs plain 2 S^T(SA) {gerr:.3e}")
    print(f"  launch counts over phase 3: {launches}")
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches, per_solve


# ---------------------------------------------------------------------------
# Phase 4: timing.
# ---------------------------------------------------------------------------

def _csr(idx, vals, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # beta-state notices
        S = torch.sparse_coo_tensor(idx, vals, shape).coalesce()
        return S.to_sparse_csr()


def sparse_sketch(rt, plan, transpose=False):
    """S (or Sᵀ) of the plan, its first ``plan.d`` columns, as a CSR tensor
    on the card: the yardstick ``torch.sparse.mm`` multiplies with; the
    port never calls it."""
    blockperm, wiring = rt["blockperm"], rt["wiring"]
    dev = "cuda"
    g = torch.arange(plan.M, device=dev)[:, None, None]
    u = torch.arange(plan.Bc, device=dev)[None, :, None]
    i = torch.arange(plan.s, device=dev)[None, None, :]
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, dev)
    rows, cols, vals = [], [], []
    for ell in range(plan.kappa):
        h = pi[ell][:, None, None]
        r, sgn = blockperm.block_rows_signs(plan, g, h, u, i)
        rows.append((g * plan.Br + r).reshape(-1))
        cols.append((h * plan.Bc + u).expand_as(r).reshape(-1))
        vals.append((sgn * plan.scale).reshape(-1))
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    keep = idx[1] < plan.d
    idx, shape = idx[:, keep], (plan.k_pad, plan.d)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return _csr(idx, torch.cat(vals)[keep], shape)


def blockrow_entries(rt, plan):
    """(rows, cols, signs) of every nonzero of FLASHBLOCKROW's S_row, in
    [k_pad] × [d_pad], collisions included (they add)."""
    hashing, ref = rt["hashing"], rt["ref"]
    dev = "cuda"
    g = torch.arange(plan.M, device=dev)[:, None, None]
    r = torch.arange(plan.Br, device=dev)[None, :, None]
    t = torch.arange(plan.s, device=dev)[None, None, :]
    tab = ref.blockrow_wiring(plan, dev)
    rows, cols, signs = [], [], []
    for ell in range(plan.kappa):
        h = tab[ell][:, None, None]
        hsh = hashing.hash_words(plan.seed, ref.BLOCKROW_PHI_TAG, g, h, r, t)
        rows.append((g * plan.Br + r).expand_as(hsh).reshape(-1))
        cols.append((h * plan.Bc + hashing.hash_mod(hsh, plan.Bc)).reshape(-1))
        signs.append(hashing.hash_to_unit_sign(hsh).reshape(-1))
    return torch.cat(rows), torch.cat(cols), torch.cat(signs)


def sparse_blockrow(rt, plan, d):
    """S_row restricted to its first ``d`` columns, in CSR, scaled."""
    rows, cols, signs = blockrow_entries(rt, plan)
    keep = cols < d
    scale = rt["fsk"].blockrow_scale(plan)
    return _csr(torch.stack([rows[keep], cols[keep]]), signs[keep] * scale,
                (plan.k_pad, d))


def phase_timing(rt, plan, n, launches, errs):
    fsk, ref = rt["fsk"], rt["ref"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda")
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda")
    full = dataclasses.replace(plan, d=plan.d_pad)
    S = sparse_sketch(rt, plan)
    St = sparse_sketch(rt, plan, transpose=True)
    item = plan.stream_itemsize
    work = {
        "flashsketch_fwd": dict(
            kernel=lambda: fsk.flashsketch_fwd(plan, A),
            plain=lambda: ref.flashsketch_ref(plan, A),
            library=lambda: torch.sparse.mm(S, A),
            bytes=plan.d_pad * n * item + plan.k_pad * n * 4,
            ops=plan.nnz_per_col * plan.d_pad * n),
        "flashsketch_transpose": dict(
            kernel=lambda: fsk.flashsketch_transpose(plan, Y),
            plain=lambda: ref.flashsketch_transpose_ref(full, Y),
            library=lambda: torch.sparse.mm(St, Y),
            bytes=plan.k_pad * n * item + plan.d_pad * n * 4,
            ops=plan.nnz_per_col * plan.d_pad * n),
        # the same transpose on its L2 route, forced (the route of plans
        # whose stage does not fit), timed in this run beside the staged one
        "flashsketch_transpose_l2": dict(
            kernel=lambda: fsk.flashsketch_transpose(plan, Y, route="l2"),
            plain=lambda: ref.flashsketch_transpose_ref(full, Y),
            library=lambda: torch.sparse.mm(St, Y),
            bytes=plan.k_pad * n * item + plan.d_pad * n * 4,
            ops=plan.nnz_per_col * plan.d_pad * n),
    }
    print(f"phase 4: timing at {plan.describe()}, n={n}, fp32 stream; "
          f"CUDA events, median of 15 after 3 warm-up calls")
    before = dict(fsk.LAUNCHES)
    lib_err = {}
    for name, w in work.items():
        lib_err[name] = float((w["library"]() - w["kernel"]()).abs().max())
    rows = []
    for name, w in work.items():
        row = time_row(name, w, launches[name], errs[name])
        rows.append(row)
        split = ""
        if name == "flashsketch_fwd":
            tn = fsk.fwd_tn(plan, n)
            split = (f"  [row-split R={fsk.vec_splits(plan, tn)}, tn={tn}; "
                     f"kernel / library {row['ms'] / row['library_ms']:.2f}]")
        elif name == "flashsketch_transpose":
            threads, stages, smem = fsk.staged_launch(plan)
            split = (f"  [staged: {stages} stages of "
                     f"{fsk.transpose_stage_bytes(plan)} B, {threads} threads "
                     f"a block, tn={fsk.staged_tn(plan)}; kernel / library "
                     f"{row['ms'] / row['library_ms']:.2f}; device "
                     f"{device_ms(w['kernel']):.4f} ms; {replaced(name)}]")
        elif name == "flashsketch_transpose_l2":
            tn = fsk.fwd_tn(plan, n)
            split = (f"  [L2 route forced: R="
                     f"{fsk.vec_splits(plan, tn, 'transpose')}, tn={tn}; "
                     f"kernel / library {row['ms'] / row['library_ms']:.2f}; "
                     f"device {device_ms(w['kernel']):.4f} ms]")
        print(f"  {name:22s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library torch.sparse.mm "
              f"{row['library_ms']:.4f} ms (|lib - kernel| "
              f"{lib_err[name]:.2e})  share of bound "
              f"{row['bound_ms'] / row['ms']:.3f}{split}")
    bf = plan.with_dtype("bfloat16")
    k_bf = cuda_ms(lambda: fsk.flashsketch_fwd(bf, A))
    print(f"  flashsketch_fwd bf16 stream (cast included) {k_bf:.4f} ms")
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def time_row(name, w, launches, err):
    """Time one kernel, its plain version and its library call (plain,
    kernel, kernel, plain, then library: compared inside one call, in
    turns); the bound from the bytes and operations of this shape."""
    p1 = cuda_ms(w["plain"])
    k1 = cuda_ms(w["kernel"])
    k2 = cuda_ms(w["kernel"])
    p2 = cuda_ms(w["plain"])
    lib = cuda_ms(w["library"])
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["ops"] / FP32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches, max_abs_err=err, ms=min(k1, k2),
                plain_ms=min(p1, p2), bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib)


def grass_work(rt, plan, d_src, n, layout, gen):
    """The three GraSS kernels at one shape and source layout: callables
    for the kernel, its plain version and the library call, with the
    bytes and operations of the bound (each gathered row read once, Y
    written once; for FLASHBLOCKROW only the rows some nonzero names)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    src = (torch.randn(d_src, n, generator=gen, device="cuda")
           if layout == "rows" else
           torch.randn(n, d_src, generator=gen, device="cuda").T)
    ri = torch.randperm(d_src, generator=gen, device="cuda")[:plan.d]
    ri = ri.sort().values
    rmap = lowering.row_map_for(plan, ri, "cuda")
    A = src[ri]                      # (d, n) for the non-gather blockrow
    A = A if layout == "rows" else A.T.contiguous().T
    A = ref.pad_input(plan, A)
    S = sparse_sketch(rt, plan)
    S_row = sparse_blockrow(rt, plan, plan.d)
    S_row_pad = sparse_blockrow(rt, plan, plan.d_pad)
    _, cols, _ = blockrow_entries(rt, plan)
    named = int(torch.unique(cols).numel())
    named_d = int(torch.unique(cols[cols < plan.d]).numel())
    item, out = plan.stream_itemsize, plan.k_pad * n * 4
    ops = plan.kappa * plan.s * plan.k_pad * n
    return {
        "flashsketch_fwd_gather": dict(
            kernel=lambda: fsk.flashsketch_fwd_gather(plan, src, rmap),
            plain=lambda: ref.flashsketch_ref(
                plan, ref.gather_rows(plan, src, rmap)),
            library=lambda: torch.sparse.mm(S, src.index_select(0, ri)),
            bytes=plan.d * n * item + out,
            ops=plan.kappa * plan.s * plan.d * n),
        "blockrow_fwd": dict(
            kernel=lambda: fsk.blockrow_fwd(plan, A),
            plain=lambda: ref.blockrow_ref(plan, A),
            library=lambda: torch.sparse.mm(S_row_pad, A),
            bytes=named * n * item + out, ops=ops),
        "blockrow_fwd_gather": dict(
            kernel=lambda: fsk.blockrow_fwd_gather(plan, src, rmap),
            plain=lambda: ref.blockrow_ref(
                plan, ref.gather_rows(plan, src, rmap)),
            library=lambda: torch.sparse.mm(S_row, src.index_select(0, ri)),
            bytes=named_d * n * item + out, ops=ops),
    }


def phase_grass_timing(rt, errs):
    """Phase 4 for the GraSS kernels: the GraSS chunk in both source
    layouts (the (D, c) view is the one featurize passes, and the one the
    kernels line reports) and the bandwidth-sized shape."""
    fsk, make_plan = rt["fsk"], rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [("GraSS chunk", GRASS_D_SRC, GRASS_D, GRASS_CHUNK, GRASS_K),
              ("bandwidth", 262_144, 65_536, 1024, 4096)]
    before = dict(fsk.LAUNCHES)
    rows = {}
    print("phase 4 (GraSS kernels): fp32 stream, κ=4, s=2; layout 'view' "
          "is the (D, c) view of row-major (c, D) gradients that featurize "
          "passes, 'rows' a row-major (D, c) source")
    for label, d_src, d, n, k in shapes:
        plan = make_plan(d, k, kappa=4, s=2, seed=0)
        for layout in ("view", "rows"):
            work = grass_work(rt, plan, d_src, n, layout, gen)
            for name, w in work.items():
                row = time_row(name, w, 0, errs[name])
                R = (fsk.vec_splits(plan, fsk.fwd_tn(plan, n))
                     if name == "blockrow_fwd" else fsk.row_splits(plan, 64))
                split = (f"  R={R} (row-split; kernel / library "
                         f"{row['ms'] / row['library_ms']:.2f}")
                if label == "GraSS chunk":
                    split += f"; device {device_ms(w['kernel']):.4f} ms"
                if label == "GraSS chunk" and layout == "view":
                    split += f"; {replaced(name)}"
                split += ")"
                print(f"  {label:11s} {layout:4s} {name:22s} kernel "
                      f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                      f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})  "
                      f"library {row['library_ms']:.4f} ms  share of bound "
                      f"{row['bound_ms'] / row['ms']:.4f}  "
                      f"[{plan.describe()}, d_src={d_src}, n={n}]{split}")
                if label == "GraSS chunk" and layout == "view":
                    rows[name] = row
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return [rows[name] for name in GRASS_KERNELS]


def global_sketch(rt, plan, transpose=False):
    """S (or Sᵀ) of a global plan, its first ``plan.d`` columns, in CSR on
    the card: the library yardstick, never called by the port."""
    u = torch.arange(plan.d, device="cuda")
    rows, cols, vals = [], [], []
    for i in range(plan.s):
        r, sgn = rt["blockperm"].global_rows_signs(plan, u, i)
        rows.append(r)
        cols.append(u)
        vals.append(sgn * plan.scale)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    shape = (plan.k_pad, plan.d)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return _csr(idx, torch.cat(vals), shape)


def phase_family_timing(rt, main_plan, n, errs):
    """Phase 4 for the v1 kernels (the main plan) and the global kernels
    (the CountSketch plan of the main shape; the gather from a row-major
    source of 4·d rows)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    make_plan = rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = main_plan
    A = torch.randn(p.d_pad, n, generator=gen, device="cuda")
    Y = torch.randn(p.k_pad, n, generator=gen, device="cuda")
    full = dataclasses.replace(p, d=p.d_pad)
    S, St = sparse_sketch(rt, p), sparse_sketch(rt, p, transpose=True)
    S_row = sparse_blockrow(rt, p, p.d_pad)
    _, cols, _ = blockrow_entries(rt, p)
    named = int(torch.unique(cols).numel())
    io = p.d_pad * n * 4 + p.k_pad * n * 4
    ops = p.nnz_per_col * p.d_pad * n
    work = {
        "flashsketch_fwd_v1": dict(
            kernel=lambda: fsk.flashsketch_fwd_v1(p, A),
            plain=lambda: ref.flashsketch_v1_ref(p, A),
            library=lambda: torch.sparse.mm(S, A), bytes=io, ops=ops),
        "flashsketch_transpose_v1": dict(
            kernel=lambda: fsk.flashsketch_transpose_v1(p, Y),
            plain=lambda: ref.flashsketch_transpose_v1_ref(full, Y),
            library=lambda: torch.sparse.mm(St, Y), bytes=io, ops=ops),
        "blockrow_fwd_v1": dict(
            kernel=lambda: fsk.blockrow_fwd_v1(p, A),
            plain=lambda: ref.blockrow_v1_ref(p, A),
            library=lambda: torch.sparse.mm(S_row, A),
            bytes=named * n * 4 + p.k_pad * n * 4,
            ops=p.kappa * p.s * p.k_pad * n),
    }
    g = make_plan(p.d, p.k_req, family="countsketch", s=1, seed=0)
    d_src = 4 * g.d
    src = torch.randn(d_src, n, generator=gen, device="cuda")
    ri = torch.randperm(d_src, generator=gen, device="cuda")[:g.d]
    ri = ri.sort().values
    rmap = lowering.row_map_for(g, ri, "cuda")
    gfull = dataclasses.replace(g, d=g.d_pad)
    G, Gt = global_sketch(rt, g), global_sketch(rt, g, transpose=True)
    gio = g.d_pad * n * 4 + g.k_pad * n * 4
    gops = g.s * g.d_pad * n
    work.update({
        "flashsketch_fwd_global": dict(
            kernel=lambda: fsk.flashsketch_fwd(g, A),
            plain=lambda: ref.flashsketch_ref(g, A),
            library=lambda: torch.sparse.mm(G, A), bytes=gio, ops=gops),
        "flashsketch_transpose_global": dict(
            kernel=lambda: fsk.flashsketch_transpose(g, Y),
            plain=lambda: ref.flashsketch_transpose_ref(gfull, Y),
            library=lambda: torch.sparse.mm(Gt, Y), bytes=gio, ops=gops),
        "flashsketch_fwd_gather_global": dict(
            kernel=lambda: fsk.flashsketch_fwd_gather(g, src, rmap),
            plain=lambda: ref.flashsketch_ref(
                g, ref.gather_rows(g, src, rmap)),
            library=lambda: torch.sparse.mm(G, src.index_select(0, ri)),
            bytes=g.d * n * 4 + g.k_pad * n * 4, ops=g.s * g.d * n),
    })
    print(f"phase 4 (v1 and global kernels): fp32 stream; v1 at "
          f"{p.describe()}, global at {g.describe()} (gather from "
          f"d_src={d_src} row-major), n={n}")
    before = dict(fsk.LAUNCHES)
    rows = []
    for name, w in work.items():
        lib_err = float((w["library"]() - w["kernel"]()).abs().max())
        row = time_row(name, w, 0, errs[name])
        rows.append(row)
        print(f"  {name:30s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library torch.sparse.mm "
              f"{row['library_ms']:.4f} ms (|lib - kernel| {lib_err:.2e})  "
              f"share of bound {row['bound_ms'] / row['ms']:.4f}")
        if name == "flashsketch_fwd_v1":
            fused = cuda_ms(lambda: fsk.flashsketch_fwd(p, A))
            print(f"    row-split R={fsk.row_splits(p, 64)}; kernel / "
                  f"library {row['ms'] / row['library_ms']:.2f}; the fused "
                  f"forward at this plan {fused:.4f} ms in this run; "
                  f"{replaced(name)}")
        elif name in ("flashsketch_transpose_v1", "blockrow_fwd_v1"):
            op = "transpose" if name == "flashsketch_transpose_v1" \
                else "blockrow"
            tn = fsk.fwd_tn(p, n, v1=True)
            print(f"    row-split R={fsk.vec_splits(p, tn, op, True)}, "
                  f"tn={tn} (split_vec_kernel, v1 mode); kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}; device "
                  f"{device_ms(w['kernel']):.4f} ms; {replaced(name)}")
        elif name in REPLACED_MS:         # the global forward and gather
            R = (fsk.vec_splits(g, fsk.fwd_tn(g, n))
                 if name == "flashsketch_fwd_global"
                 else fsk.row_splits(g, 64))
            print(f"    row-split R={R}; kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}; {replaced(name)}")
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def partial_sketch(rt, plan, lo, M_loc, rows):
    """The rank's slice of S, unscaled, in CSR on the card: (κ·M_loc·Br,
    M_loc·Bc) onto the compact layout, or (κ·k_pad, M_loc·Bc) onto the
    masked one (owned pairs only).  The library yardstick; never called by
    the port."""
    blockperm, hashing, ref = rt["blockperm"], rt["hashing"], rt["ref"]
    tab = rt["dist"].partial_tables(plan, lo, M_loc, rows, "cuda").long()
    rows_, cols, vals = [], [], []
    for ell in range(plan.kappa):
        if rows:
            g = torch.arange(plan.M, device="cuda")[:, None, None]
            r = torch.arange(plan.Br, device="cuda")[None, :, None]
            t = torch.arange(plan.s, device="cuda")[None, None, :]
            h = tab[1, ell][:, None, None]
            hsh = hashing.hash_words(plan.seed, ref.BLOCKROW_PHI_TAG, g, h, r,
                                     t)
            keep = tab[2, ell].bool()[:, None, None].expand_as(hsh)
            rr = ((ell * plan.M + g) * plan.Br + r).expand_as(hsh)
            cc = tab[0, ell][:, None, None] * plan.Bc + hashing.hash_mod(
                hsh, plan.Bc)
            rows_.append(rr[keep])
            cols.append(cc[keep])
            vals.append(hashing.hash_to_unit_sign(hsh)[keep])
        else:
            m = torch.arange(M_loc, device="cuda")[:, None, None]
            u = torch.arange(plan.Bc, device="cuda")[None, :, None]
            i = torch.arange(plan.s, device="cuda")[None, None, :]
            g = tab[0, ell][:, None, None]
            h = tab[1, ell][:, None, None]
            r, sgn = blockperm.block_rows_signs(plan, g, h, u, i)
            rows_.append(((ell * M_loc + m) * plan.Br + r).reshape(-1))
            cols.append((m * plan.Bc + u).expand_as(r).reshape(-1))
            vals.append(sgn.reshape(-1))
    out_rows = plan.kappa * (plan.k_pad if rows else M_loc * plan.Br)
    return _csr(torch.stack([torch.cat(rows_), torch.cat(cols)]),
                torch.cat(vals).float(), (out_rows, M_loc * plan.Bc))


def phase_partial_timing(rt, plan, n, errs):
    """Phase 4 for the partial kernels at the main plan: the slab of one of
    P = 4 ranks (M_loc = 8) and of P = 1; the kernels line reports P = 4.
    Bound: the slab read once plus the output written once (compact: the
    κ·M_loc·Br rows; masked: all κ·k_pad rows, zeros included, and only
    the slab rows some owned nonzero names)."""
    fsk, ref, dist_ = rt["fsk"], rt["ref"], rt["dist"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    before = dict(fsk.LAUNCHES)
    print(f"phase 4 (partial kernels): {plan.describe()}, n={n}, fp32 "
          f"stream; library torch.sparse.mm of the rank's unscaled S slice "
          f"in CSR")
    rows_out = {}
    for P in (4, 1):
        M_loc = plan.M // P
        slab = torch.randn(M_loc * plan.Bc, n, generator=gen, device="cuda")
        for rows, name in ((False, "flashsketch_fwd_partial"),
                           (True, "blockrow_fwd_partial")):
            tab = dist_.partial_tables(plan, 0, M_loc, rows, "cuda")
            S = partial_sketch(rt, plan, 0, M_loc, rows)
            if rows:
                owned = int(tab[2].sum())
                named = int(torch.unique(S.col_indices()).numel())
                io = named * n * 4 + plan.kappa * plan.k_pad * n * 4
                ops_ = owned * plan.Br * plan.s * n
            else:
                io = (M_loc * plan.Bc + plan.kappa * M_loc * plan.Br) * n * 4
                ops_ = plan.kappa * plan.s * M_loc * plan.Bc * n
            w = dict(kernel=lambda: fsk.flashsketch_partial(
                         plan, slab, tab, rows_pattern=rows),
                     plain=lambda: ref.partial_ref(plan, slab, tab, rows),
                     library=lambda: torch.sparse.mm(S, slab).reshape(
                         plan.kappa, -1, n),
                     bytes=io, ops=ops_)
            lib_err = float((w["library"]() - w["kernel"]()).abs().max())
            row = time_row(name, w, 0, errs[name])
            tn = fsk.fwd_tn(plan, n)
            R = fsk.masked_splits(plan, tn) if rows else \
                fsk.vec_splits(plan, tn)
            print(f"  P={P} (M_loc={M_loc:2d}) {name:24s} kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{io / 1e6:.1f} MB)  library {row['library_ms']:.4f} ms "
                  f"(|lib - kernel| {lib_err:.2e})  share of bound "
                  f"{row['bound_ms'] / row['ms']:.4f}  kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}  [R={R}, tn={tn}; "
                  f"device {device_ms(w['kernel']):.4f} ms"
                  f"{'; ' + replaced(name) if rows and P == 4 else ''}]")
            if P == 4:
                rows_out[name] = row
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return [rows_out[name] for name in PARTIAL_KERNELS]


# ---------------------------------------------------------------------------
# Phase 6: every sketch family at the paper's main shape.
# ---------------------------------------------------------------------------

def phase_families(rt, main_plan):
    """The family tournament at ``paper_main`` (d = 65 536, n = 1 024,
    k = 4 096, gaussian data, cond 1e4), one trial per family, then the
    v1, global and L2-route entry points a user reaches: the apply of a
    Br = 2 048 BlockPerm sketch and its transpose (the L2 route), a
    backward under ``impl="cuda_v1"``, a
    FLASHBLOCKROW apply under ``impl="cuda_v1"``, and CountSketch's fused
    gather and backward.  Returns the launch counts of the phase."""
    fsk, ref, ops, variants = rt["fsk"], rt["ref"], rt["ops"], rt["variants"]
    pareto = rt["pareto"]
    reg = pareto.PAPER_MAIN
    print(f"phase 6: family tournament at {reg['name']} (d={reg['d']}, "
          f"n={reg['n']}, k={reg['k']}, {reg['dataset']}, cond "
          f"{reg['cond']:g}), one trial per family")
    t = time.perf_counter()
    data = pareto.regime_data(reg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  data (numpy make_dataset / make_ls_problem, QR of A on the "
          f"card): {time.perf_counter() - t:.1f} s")
    fsk.reset_launch_counts()
    rows = []
    for fam, kw in sorted(pareto.FAMILY_KWARGS.items()):
        t = time.perf_counter()
        row = pareto.score_family(fam, kw, reg, data, seed=0, trials=1,
                                  timing_iters=5, max_iters=200)
        rows.append(row)
        check(math.isfinite(row["ose_err"]) and row["ose_err"] > 0
              and row["measured_us"] > 0, f"{fam}: score {row}")
        print(f"  {fam:16s} ose_err {row['ose_err']:.4f} lsqr_iters "
              f"{row['lsqr_iters']:3d} (converged {row['lsqr_converged']}, "
              f"relres {row['lsqr_relres']:.2e}) measured_us "
              f"{row['measured_us']:.1f}  [{time.perf_counter() - t:.1f} s]"
              f" {row['lowering'] or ''}")
    best = {r["family"]: r for r in rows}
    check(best["blockperm"]["lsqr_converged"], "blockperm LSQR did not "
          "converge at paper_main")
    print(f"  front (3 axes): {pareto.pareto_front(rows, pareto.AXES)}; "
          f"front (ose_err x measured_us): "
          f"{pareto.pareto_front(rows, pareto.GATE_AXES)}; non-kin "
          f"families dominating blockperm there: "
          f"{pareto.gate_dominators('blockperm', rows)}")

    A = data["A_data"]
    big = variants.BlockPermSketch(reg["d"], reg["k"], kappa=4,
                                   block_rows=2048)
    lw = big.lowering_for(reg["n"], device="cuda")
    print(f"  BlockPermSketch(d={reg['d']}, k={reg['k']}, kappa=4, "
          f"block_rows=2048): {lw.describe()}")
    check(lw.impl == "cuda" and lw.downgrade is None and lw.row_splits,
          "the Br=2048 apply did not lower to the row-split forward")
    Yb = big.apply(A)
    _err(Yb, ref.flashsketch_ref(big.plan, A), big.plan, "Br=2048 apply")
    # its transpose: one stage (κ row blocks of Y, 1 MiB) does not fit
    # shared memory, so the lowering takes the L2 route, not cuda_v1
    lwt = rt["lowering"].lower(big.plan, rt["lowering"].LaunchSpec(
        op="transpose", n=reg["n"], device="cuda"))
    print(f"  its transpose: {lwt.describe()}")
    check(lwt.impl == "cuda" and lwt.downgrade is None and lwt.route == "l2",
          "the Br=2048 transpose did not lower to the L2 route")
    _err(ops.sketch_apply_t(big.plan, Yb), ref.flashsketch_transpose_ref(
        big.plan, Yb), big.plan, "Br=2048 transpose")
    _err(ops.sketch_apply(big.plan, A, "cuda_v1"),
         ref.flashsketch_v1_ref(big.plan, A), big.plan,
         "Br=2048 apply under cuda_v1")
    A32 = A.clone().requires_grad_(True)
    Y = ops.sketch_apply(main_plan, A32, "cuda_v1")
    (Y ** 2).sum().backward()
    gerr = _err(A32.grad, ref.flashsketch_transpose_v1_ref(
        main_plan, 2 * Y.detach()), main_plan, "cuda_v1 backward")
    Yr = ops.blockrow_apply(main_plan, A, "cuda_v1")
    _err(Yr, ref.blockrow_v1_ref(main_plan, A), main_plan,
         "blockrow cuda_v1")
    cs = variants.make_sketch("countsketch", reg["d"], reg["k"], seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    src = torch.randn(2 * reg["d"], reg["n"], generator=gen, device="cuda")
    idx = torch.randperm(2 * reg["d"], generator=gen,
                         device="cuda")[:reg["d"]]
    check(torch.equal(cs.apply_gather(src, idx), cs.apply(src[idx])),
          "CountSketch fused gather != apply of the materialized gather")
    A32 = A.clone().requires_grad_(True)
    W = torch.randn(cs.k, reg["n"], generator=gen, device="cuda")
    (cs.apply(A32) * W).sum().backward()
    _err(A32.grad, ref.flashsketch_transpose_ref(cs.plan, W), cs.plan,
         "CountSketch backward")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  Br=2048 apply (row-split forward and cuda_v1) and transpose "
          f"(L2 route), cuda_v1 backward (max err {gerr:.3e}), "
          f"blockrow cuda_v1, CountSketch gather == apply (torch.equal) "
          f"and backward: checked")
    print(f"  launch counts over phase 6: {launches}")
    for name in V1_KERNELS + GLOBAL_KERNELS + L2_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 6")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: GraSS data attribution at the paper's width.
# ---------------------------------------------------------------------------

def profile_build_cache(pipe, x, y, warm_wall):
    """Device time by kernel over one more warm ``build_cache``, and the
    share of the unprofiled one's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.build_cache(x, y)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("  profile of build_cache: the profiler recorded no device "
              "time (busy share not measured)")
        return
    print(f"  profile of build_cache (blockperm, k={pipe.sketch.k}): device "
          f"busy {busy_ms:.3f} ms of the unprofiled call's "
          f"{warm_wall * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (warm_wall * 1e3):.3f}); kernels by device time:")
    for e in kernels[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def phase_grass(rt, n_train=5000, n_test=500):
    """GraSS end to end on the card: the 109 386-parameter MLP, sparse dim
    4 096, k ∈ GRASS.k_values, κ = 4, s = 2, chunks of 64, LDS over
    GRASS.n_subsets retrains at α = GRASS.subset_frac."""
    fsk, G, M, L = rt["fsk"], rt["grass"], rt["mlp"], rt["lds"]
    cfg = rt["grass_cfg"]
    mcfg = M.MLPConfig()
    print(f"phase 5: GraSS at {mcfg.d_in}->{'->'.join(map(str, mcfg.hidden))}"
          f"->{mcfg.n_classes}, n_train={n_train}, n_test={n_test}, "
          f"m={cfg.n_subsets}, alpha={cfg.subset_frac}")
    t = time.perf_counter()
    x, y = M.make_synthetic_mnist(n_train + n_test, mcfg.d_in,
                                  mcfg.n_classes, seed=0)
    x, y = x.cuda(), y.cuda()
    x_tr, y_tr, x_te, y_te = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    base = M.train_mlp(mcfg, x_tr, y_tr)
    n_params = sum(p.numel() for p in base.parameters())
    check(n_params == 109_386, f"MLP has {n_params} parameters")
    with torch.no_grad():
        acc = float((base(x_te).argmax(-1) == y_te).float().mean())
    masks = L.sample_subsets(n_train, cfg.n_subsets, cfg.subset_frac, 0)
    true_out = torch.empty(cfg.n_subsets, n_test)
    for j in range(cfg.n_subsets):
        pj = M.train_mlp(mcfg, x_tr, y_tr,
                         generator=torch.Generator().manual_seed(1000 + j),
                         mask=masks[j])
        with torch.no_grad():
            true_out[j] = M.margin_output(dict(pj.named_parameters()),
                                          x_te, y_te).cpu()
    true_out = true_out.double().numpy()
    torch.cuda.synchronize()
    print(f"  base model ({n_params} parameters, test accuracy {acc:.3f}) "
          f"and {cfg.n_subsets} retrains: {time.perf_counter() - t:.1f} s")

    chunks = sum(-(-min(256, n_train - i) // 64)
                 for i in range(0, n_train, 256))
    fsk.reset_launch_counts()
    caches = {}
    for k in cfg.k_values:
        for fam in (("blockperm", "blockrow") if k == GRASS_K
                    else ("blockperm",)):
            for fused in ((True, False) if k == GRASS_K else (True,)):
                pipe = G.GrassPipeline(G.GrassPipelineConfig(
                    sparse_dim=cfg.grad_dim_sketch_from, sketch_dim=k,
                    sketch_family=fam, sketch_kwargs=(("kappa", 4), ("s", 2)),
                    chunk=GRASS_CHUNK, fused=fused), base, device="cuda")
                check(pipe.d_total == n_params, "d_total")
                pipe.build_cache(x_tr, y_tr)        # warm-up
                before = dict(fsk.LAUNCHES)
                cache, secs = pipe.build_cache(x_tr, y_tr)
                delta = {n: fsk.LAUNCHES[n] - before[n] for n in before}
                tau = pipe.attribute(cache, x_te, y_te)
                lds = L.lds_score(true_out, tau, masks)
                caches[(k, fam, fused)] = cache
                print(f"  {fam:9s} k={k} fused={fused!s:5s} LDS {lds:.4f} "
                      f"per_sample_us {1e6 * secs / n_train:.3f} "
                      f"(build_cache {secs:.4f} s) launches per build_cache "
                      f"{ {n: v for n, v in delta.items() if v} } "
                      f"{pipe.sketch_lowering().describe()}")
                check(cache.shape == (n_train, pipe.sketch.k) and
                      bool(torch.isfinite(cache).all()), "cache shape/finite")
                check(lds > 0, f"{fam} k={k}: LDS {lds} <= 0")
                if fused:
                    gname = {"blockperm": "flashsketch_fwd_gather",
                             "blockrow": "blockrow_fwd_gather"}[fam]
                    check(delta[gname] == chunks,
                          f"{gname}: {delta[gname]} launches for {chunks} "
                          f"chunks")
                if fused and fam == "blockperm" and k == GRASS_K:
                    profile_build_cache(pipe, x_tr, y_tr, secs)
                if fused and k == GRASS_K:
                    # one NaN-poisoned example is quarantined
                    xb = x_tr[:GRASS_CHUNK].clone()
                    xb[5, 0] = float("nan")
                    feats = pipe.featurize(xb, y_tr[:GRASS_CHUNK])
                    clean = cache[:GRASS_CHUNK]
                    check(pipe.quarantined == 1, "quarantine count")
                    check(bool((feats[5] == 0).all()), "quarantined row")
                    others = torch.cat([feats[:5], feats[6:]])
                    check(torch.equal(others, torch.cat([clean[:5],
                                                         clean[6:]])),
                          "the other rows of the poisoned chunk moved")
                    print(f"  {fam:9s} NaN in example 5: quarantined "
                          f"{pipe.quarantined}, its row all zeros, the other "
                          f"{GRASS_CHUNK - 1} rows unchanged")
        if k == GRASS_K:
            for fam in ("blockperm", "blockrow"):
                check(torch.equal(caches[(k, fam, True)],
                                  caches[(k, fam, False)]),
                      f"{fam}: fused features != unfused")
            print("  fused features == unfused (torch.equal), blockperm "
                  "and blockrow")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  launch counts over phase 5: {launches}")
    for name in GRASS_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the GraSS path")
    state = {name: p.detach().cpu().numpy()
             for name, p in base.named_parameters()}
    return launches, state


# ---------------------------------------------------------------------------
# Phase 7: the distributed path.  P > 1 runs as P processes of a gloo group
# on the one card (NCCL refuses two ranks on one device); P = 1 in-process.
# ---------------------------------------------------------------------------

def _all_equal(t, group=None):
    """Whether ``t`` is the same bits on every rank of ``group``."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return all(torch.equal(p, t) for p in parts)


def main_inputs(plan, n):
    """The main plan's A (d, n) and a batch stack with its gather rows,
    from seeded generators on the card (the same in every process)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    d = plan.d
    A = torch.randn(d, n, generator=gen, device="cuda")
    G = torch.randn(8, d, n // 8, generator=gen, device="cuda")
    idx = torch.randperm(d, generator=gen, device="cuda")[:GRASS_D]
    return A, G, idx.sort().values


def phase7_rank(rank, world, cfg):
    """One of the four ranks of phase 7: the P = 2 checks on the subgroup
    of ranks {0, 1}, then the P = 4 checks on all four.  Returns, by P,
    what the parent compares, with the launch counts of the path (timing
    launches excluded) and the rank's start and end times."""
    import torch.distributed as dist
    from repro_torch.kernels import flashsketch as fsk
    torch.backends.cuda.matmul.allow_tf32 = False
    fsk.reset_launch_counts()
    start = time.time() - cfg["t_spawn"]
    pair = dist.new_group([0, 1])          # every rank takes part
    out = {}
    if rank < 2:
        out[2] = _phase7_checks(rank, 2, pair, cfg)
    dist.barrier()
    out[4] = _phase7_checks(rank, world, None, cfg)
    torch.cuda.synchronize()
    out.update(launches=dict(fsk.LAUNCHES), start=start, t_end=time.time())
    return out


def _phase7_checks(rank, world, group, cfg):
    """Every check of P = ``world`` on this rank's shard, in ``group``
    (``None``: the default group)."""
    import torch.distributed as dist
    from benchmarks import torch_dist_bench as bench
    from repro_torch import distributed as D
    from repro_torch.attribution import grass, mlp
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import flashsketch as fsk
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    secs = {}                      # host seconds by step, for the record
    t_step = time.perf_counter()
    main_plan = make_plan(*cfg["main_plan"], kappa=4, s=2, seed=0)
    n = cfg["n"]
    A, G, idx = main_inputs(main_plan, n)
    out = {"equal": {}, "err": {}, "secs": secs}
    for key, plan, rows in (
            ("fwd_float32", main_plan, False),
            ("fwd_bfloat16", main_plan.with_dtype("bfloat16"), False),
            ("blockrow_float32", main_plan, True)):
        Y = D.sketch_apply_sharded(plan, D.shard_rows(plan, A, rank, world),
                                   group, rows_pattern=rows)
        out["equal"][f"row {key} across ranks"] = _all_equal(Y, group)
        out[key] = Y.cpu().numpy()
    # this rank's masked partial under every row split R: the same bits
    # (comparison launches, not counted)
    slab = D.shard_rows(main_plan, A, rank, world)
    M_loc = main_plan.M // world
    tab = D.partial_tables(main_plan, rank * M_loc, M_loc, True, dev)
    before = dict(fsk.LAUNCHES)
    base = fsk.flashsketch_partial(main_plan, slab, tab, rows_pattern=True)
    out["equal"]["masked partial the same bits under every R"] = all(
        torch.equal(fsk.flashsketch_partial(main_plan, slab, tab,
                                            rows_pattern=True, row_splits=R),
                    base) for R in fsk.split_allowed(main_plan))
    fsk.LAUNCHES.update(before)
    del slab, base
    out["col"] = D.sketch_apply_colsharded(
        main_plan, D.shard_cols(A, rank, world)).cpu().numpy()
    out["batch"] = D.sketch_apply_batched_sharded(
        main_plan, D.shard_batch(G, rank, world)).cpu().numpy()
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    out["batch_gather"] = D.sketch_apply_batched_sharded(
        gplan, D.shard_batch(G, rank, world), row_index=idx).cpu().numpy()
    secs["main plan applies"] = time.perf_counter() - t_step

    if world == 2:      # GraSS featurize, batch-sharded, at the paper width
        model = mlp.params_from_reference(cfg["grass_state"], device=dev)
        x, y = mlp.make_synthetic_mnist(5500, 784, 10, seed=0)
        x, y = x[:5000].to(dev), y[:5000].to(dev)
        gcfg = grass.GrassPipelineConfig(
            sparse_dim=GRASS_D, sketch_dim=GRASS_K,
            sketch_kwargs=(("kappa", 4), ("s", 2)), chunk=GRASS_CHUNK)
        x[5, 0] = float("nan")             # one quarantined example
        pipe = grass.GrassPipeline(gcfg, model, group=group, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        feats = pipe.featurize(x, y)
        torch.cuda.synchronize()
        out["grass_s"] = time.perf_counter() - t
        out["equal"]["grass across ranks"] = _all_equal(feats, group)
        out["grass_quarantined"] = pipe.quarantined
        out["equal"]["grass quarantined row zero"] = bool(
            (feats[5] == 0).all())
        if rank == 0:
            single = grass.GrassPipeline(gcfg, model, device=dev)
            out["equal"]["grass == single device"] = torch.equal(
                single.featurize(x, y), feats)
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t_warm = time.perf_counter()
        pipe.featurize(x, y)
        torch.cuda.synchronize()
        out["grass_warm_s"] = time.perf_counter() - t_warm
        secs["grass"] = time.perf_counter() - t

    if world == 4:      # the paper's largest shape, timed; the solves
        t_step = time.perf_counter()
        big = make_plan(cfg["big"][0], cfg["big"][2], kappa=4, s=2, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(12)
        Ab = torch.randn(big.d, cfg["big"][1], generator=gen, device=dev)
        slab = D.shard_rows(big, Ab, rank, world)
        for pol in ("float32", "bfloat16"):
            p = big.with_dtype(pol)
            Y = D.sketch_apply_sharded(p, slab)
            out["equal"][f"big {pol} across ranks"] = _all_equal(Y)
            want = ops.sketch_apply(p, Ab)
            e = float((Y - want).abs().max())
            out["err"][f"big {pol} vs fused"] = e
            out["equal"][f"big {pol} within tol of fused"] = \
                e <= p.precision.exactness_atol * float(want.abs().max())
        before = dict(fsk.LAUNCHES)
        t = bench.timings(big, slab, rank, world, dev, bench.REPS)
        dist.barrier()
        if rank == 0:
            t["single_ms"] = bench.ms(lambda: ops.sketch_apply(big, Ab), dev,
                                      bench.REPS)
        dist.barrier()
        fsk.LAUNCHES.update(before)        # timing launches do not count
        out["big_timing"] = t
        del Ab, slab
        secs["largest shape"] = time.perf_counter() - t_step
        t_step = time.perf_counter()

        # this rank's rows of the least-squares problem, from the parent
        ls = torch.load(os.path.join(cfg["ls_dir"], f"rows{rank}.pt"))
        A_loc, b_loc = ls["A"].to(dev), ls["b"].to(dev)
        x_ref = torch.from_numpy(cfg["x_ref"]).to(dev)
        for label, plan in (("main plan", main_plan),
                            ("plan_for_mesh", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.dist_sketch_precondition_lstsq(A_loc, b_loc, plan=plan,
                                                   tol=cfg["tol"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = float(torch.linalg.vector_norm(res.x - x_ref)
                        / torch.linalg.vector_norm(x_ref))
            out["equal"][f"solve {label} x across ranks"] = _all_equal(res.x)
            out[f"solve {label}"] = dict(
                iterations=res.iterations, relres=res.relres,
                converged=res.converged, err=err, wall_s=wall,
                plan=res.lowering.plan.describe(),
                lowering=res.lowering.describe())
            if label == "main plan":
                x_main = res.x
        secs["solves"] = time.perf_counter() - t_step
        # the guarded solve (the replica guard, an all_gather of SA; the
        # finite and condition guards; a redraw-only ladder) beside the
        # unguarded one, both warm
        walls = {}
        for guard in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.dist_sketch_precondition_lstsq(
                A_loc, b_loc, plan=main_plan, tol=cfg["tol"], guard=guard)
            torch.cuda.synchronize()
            walls[guard] = time.perf_counter() - t0
        h = res.health
        out["equal"]["guarded solve x across ranks"] = _all_equal(res.x)
        out["equal"]["guarded solve x == unguarded"] = torch.equal(res.x,
                                                                   x_main)
        out["equal"]["guarded solve healthy, one attempt"] = \
            h.status == "healthy" and h.attempts == 1 and res.converged
        out["guarded"] = dict(status=h.status, attempts=h.attempts,
                              wall_s=walls[True], plain_s=walls[False],
                              findings=[f.describe() for f in h.findings])
        secs["guarded solve"] = time.perf_counter() - t0
    return out


def phase_distributed(rt, main_plan, n, cond, big, grass_state):
    """Phase 7: the distributed path at P = 1 (in-process), 2 and 4 (one
    spawned gloo group of four ranks, the P = 2 checks on its subgroup of
    ranks {0, 1}): the
    row-sharded apply (fp32, bf16, FLASHBLOCKROW) the same bits across
    ranks and P and within tolerance of the single-device kernels and of
    the plain version; column- and batch-sharded (with row_index) equal to
    one device; at P = 2 GraSS featurize batch-sharded; at P = 4 the
    paper's largest shape ``big`` = (d, n, k) timed (per-rank kernel,
    all-reduce, fold) and two distributed solves.  Returns the launch
    counts of the phase."""
    import numpy as np
    fsk, ops, D = rt["fsk"], rt["ops"], rt["dist"]
    run_ranks = rt["run_ranks"]
    print(f"phase 7: the distributed path, P = 1 in-process, P = 2 and 4 in "
          f"one gloo group of four processes on this card (P = 2 on ranks "
          f"0-1); main plan "
          f"{main_plan.describe()}, n={n}")
    A, G, idx = main_inputs(main_plan, n)
    # phase 3's problem; each of the 4 ranks gets its rows through a file
    # (rebuilding it in every rank would rest on the QR's determinism)
    ls_dir = tempfile.TemporaryDirectory()
    Als, bls = make_ls_problem(main_plan.d, n, cond)
    x_ref = torch.linalg.lstsq(Als, bls[:, None]).solution[:, 0]
    for r in range(4):
        torch.save({"A": D.shard_rows(main_plan, Als, r, 4).cpu(),
                    "b": D.shard_rows(main_plan, bls[:, None], r, 4)[:, 0]
                    .cpu()}, os.path.join(ls_dir.name, f"rows{r}.pt"))
    cfg = dict(main_plan=(main_plan.d, main_plan.k_req), n=n, big=big,
               tol=rt["presets"]["default"].tol, x_ref=x_ref.cpu().numpy(),
               ls_dir=ls_dir.name, grass_state=grass_state)
    del Als, bls
    fsk.reset_launch_counts()
    single = {}
    for key, plan, rows in (
            ("fwd_float32", main_plan, False),
            ("fwd_bfloat16", main_plan.with_dtype("bfloat16"), False),
            ("blockrow_float32", main_plan, True)):
        Y1 = D.sketch_apply_sharded(plan, D.shard_rows(plan, A, 0, 1),
                                    rows_pattern=rows)
        fn = ops.blockrow_apply if rows else ops.sketch_apply
        e_fused = _err(Y1, fn(plan, A), plan, f"P=1 {key} vs fused")
        e_plain = _err(Y1, fn(plan, A, "torch"), plan, f"P=1 {key} vs torch")
        print(f"  P=1 row-sharded {key:17s} vs the fused kernel "
              f"{e_fused:.3e}, vs impl='torch' {e_plain:.3e}")
        single[key] = Y1.cpu().numpy()
    launches = dict(fsk.LAUNCHES)
    want_col = ops.sketch_apply(main_plan, A).cpu().numpy()
    want_batch = ops.sketch_apply_batched(main_plan, G).cpu().numpy()
    gplan = rt["blockperm"].make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    want_gather = ops.sketch_apply_batched(gplan, G,
                                           row_index=idx).cpu().numpy()
    del A, G
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg["t_spawn"] = time.time()
    try:
        ranks = run_ranks(phase7_rank, 4, cfg, timeout=SPAWN_TIMEOUT_S)
    finally:
        ls_dir.cleanup()
    print(f"  4 ranks in {time.perf_counter() - t:.1f} s: each started its "
          f"work {min(o['start'] for o in ranks):.1f}-"
          f"{max(o['start'] for o in ranks):.1f} s after the call (process "
          f"start, imports, rendezvous); the call returned "
          f"{time.time() - max(o['t_end'] for o in ranks):.1f} s after the "
          f"last rank's work ended")
    for out in ranks:
        for name, v in out["launches"].items():
            launches[name] += v
    for P in (2, 4):
        outs = [o[P] for o in ranks if P in o]
        for r, out in enumerate(outs):
            for what, ok in out["equal"].items():
                check(ok, f"P={P} rank {r}: {what}")
        o = outs[0]
        for key, want in single.items():
            check(np.array_equal(o[key], want),
                  f"P={P} row-sharded {key} != P=1")
        check(np.array_equal(np.concatenate([x["col"] for x in outs], 1),
                             want_col), f"P={P} column-sharded != one device")
        check(np.array_equal(np.concatenate([x["batch"] for x in outs]),
                             want_batch), f"P={P} batch-sharded != one device")
        check(np.array_equal(np.concatenate([x["batch_gather"]
                                             for x in outs]), want_gather),
              f"P={P} batch-sharded gather != one device")
        print(f"  P={P}: row-sharded fp32, bf16 and FLASHBLOCKROW equal to "
              f"P=1 and across ranks (torch.equal); column-, batch- and "
              f"gather-batch-sharded equal to one device; checks "
              f"{sorted(o['equal'])}; rank 0 host seconds by step "
              f"{ {k: round(v, 2) for k, v in o['secs'].items()} }")
        if P == 2:
            check(all(x["grass_quarantined"] == 1 for x in outs),
                  "GraSS quarantine count")
            print(f"  P=2 GraSS featurize (5 000 examples, one NaN-poisoned, "
                  f"k={GRASS_K}, chunks of {GRASS_CHUNK}): equal to one "
                  f"device, quarantined 1 on every rank, its row zero; "
                  f"first (cold) call {o['grass_s']:.3f} s, second "
                  f"{o['grass_warm_s']:.3f} s")
        if P == 4:
            t = o["big_timing"]
            print(f"  P=4 d={big[0]} n={big[1]} k={big[2]}: per-rank kernel "
                  f"ms "
                  f"{[x['big_timing']['kernel_ms'] for x in outs]}, "
                  f"all-reduce {t['allreduce_ms']:.4f} ms, fold "
                  f"{t['fold_ms']:.4f} ms, total {t['total_ms']:.4f} ms; "
                  f"single-device fused forward {t['single_ms']:.4f} ms; "
                  f"err vs fused {o['err']}")
            for label in ("main plan", "plan_for_mesh"):
                sol = o[f"solve {label}"]
                print(f"  P=4 solve ({label}, {sol['plan']}): iterations "
                      f"{sol['iterations']} relres {sol['relres']:.3e} "
                      f"|x-x_lstsq|/|x_lstsq| {sol['err']:.3e} (bound "
                      f"{10 * cond * cfg['tol']:.0e}) wall "
                      f"{sol['wall_s']:.3f} s {sol['lowering']}")
                check(sol["converged"] and sol["err"] <= 10 * cond *
                      cfg["tol"], f"P=4 solve {label}: {sol}")
            g = o["guarded"]
            print(f"  P=4 guarded solve (main plan): {g['status']}, "
                  f"{g['attempts']} attempt(s), x the same bits on every "
                  f"rank and as the unguarded solve; wall "
                  f"{g['wall_s']:.3f} s against {g['plain_s']:.3f} s "
                  f"unguarded, both warm; {g['findings']}")
    print(f"  launch counts over phase 7 (all ranks): {launches}")
    for name in PARTIAL_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 7")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: the tuner, the cost model and the health guards.
# ---------------------------------------------------------------------------

def graph_ms(fn, reps=10):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed (median of 5 replays, CUDA events), so the host's
    dispatch does not count; the graph's outputs are freed after."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times) / reps


def tune_shape(rt, plan, n, variant, label):
    """Autotune one variant at one shape on the card; print every
    candidate's (tn, R), events time (the tuner's, one call at a time) and
    device time (``graph_ms``) and the winner against the rule (the first
    candidate); every candidate the rule's bits."""
    tune = rt["tune"]
    trials = []
    win = tune.autotune(plan, n, variant, warmup=2, iters=10, trials=trials)
    run = tune.launcher(plan, n, variant)
    dev = [graph_ms(lambda t=t: run(t["tn"], t["row_splits"]))
           for t in trials]
    rule = trials[0]
    wdev = next(d for t, d in zip(trials, dev)
                if (t["tn"], t["row_splits"]) == (win.tn, win.row_splits))
    print(f"  {label} {variant} ({plan.dtype}, n={n}): {len(trials)} "
          f"candidates; rule tn={rule['tn']} R={rule['row_splits']} "
          f"{rule['time_us']:.1f} us (device {dev[0] * 1e3:.1f}); winner "
          f"tn={win.tn} R={win.row_splits} {win.time_us:.1f} us (device "
          f"{wdev * 1e3:.1f}): {win.time_us / rule['time_us']:.3f} of the "
          f"rule's events time, {wdev / dev[0]:.3f} of its device time; "
          f"fastest device time "
          f"{min(dev) * 1e3:.1f} us at {trials[dev.index(min(dev))]['tn']}, "
          f"{trials[dev.index(min(dev))]['row_splits']}")
    print("    " + "; ".join(
        f"({t['tn']},{t['row_splits']}{',' + t['route'] if t['route'] else ''})"
        f" {t['time_us']:.1f}/{d * 1e3:.1f}"
        for t, d in zip(trials, dev)) + "  [events/device us]")
    bad = [t for t in trials if not t["equal"]]
    check(not bad, f"{label} {variant}: candidates not the rule's bits: {bad}")
    rule["device_us"], win_dev = dev[0] * 1e3, wdev * 1e3
    return win, rule, trials, win_dev


def phase_tuner(rt, main_plan, n):
    """The tuner on the card: every candidate of every variant the rule's
    bits at every policy on a small plan (ragged n); the four main-plan
    tunings, three at the GraSS chunk and two at the CountSketch plan of
    the main shape timed; the cache saved, cleared
    and loaded, and a loaded winner's (tn, R) run by the main path's
    entry point.  Returns the rows PERF.md keeps."""
    tune, lowering, ops, fsk = rt["tune"], rt["lowering"], rt["ops"], \
        rt["fsk"]
    make_plan = rt["blockperm"].make_plan
    before = dict(fsk.LAUNCHES)
    tune.clear_cache()
    small = make_plan(1000, 256, kappa=4, s=2, seed=3)
    count = 0
    for pol in POLICIES:
        p = small.with_dtype(pol)
        for variant in tune.VARIANTS:
            trials = []
            tune.autotune(p, 200, variant, warmup=0, iters=1, trials=trials)
            bad = [t for t in trials if not t["equal"]]
            check(not bad, f"small plan {pol} {variant}: {bad}")
            count += len(trials)
    print(f"phase 8 (tuner): {count} candidates at {small.describe()}, "
          f"n=200, all six policies, every variant: each the rule's bits "
          f"(torch.equal)")
    tune.clear_cache()
    out = {}
    for plan, variant in ((main_plan, "fwd"),
                          (main_plan.with_dtype("bfloat16"), "fwd"),
                          (main_plan, "transpose"), (main_plan, "blockrow")):
        out[(variant, plan.dtype)] = tune_shape(rt, plan, n, variant,
                                                "main plan")
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    for variant in ("blockrow", "fwd_gather", "blockrow_gather"):
        out[(variant, "chunk")] = tune_shape(rt, gplan, GRASS_CHUNK,
                                             variant, "GraSS chunk (D, c)")
    cs = make_plan(main_plan.d, main_plan.k_req, family="countsketch", s=1,
                   seed=0)
    for variant in ("fwd", "fwd_gather"):
        out[(variant, "countsketch")] = tune_shape(rt, cs, n, variant,
                                                   "CountSketch plan")
    # persistence: save, clear, load; the loaded winners reach the lowering
    # and the main path's entry point runs the loaded (tn, R)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "winners.json")
        saved = tune.save_cache(path)
        tune.clear_cache()
        kept = tune.load_cache(path)
    check(kept == saved == len(out), f"saved {saved}, loaded {kept} "
          f"entries")
    win = out[("fwd", "float32")][0]
    lw = lowering.lower(main_plan, lowering.LaunchSpec(n=n, device="cuda"))
    R_run = win.row_splits or fsk.vec_splits(main_plan, win.tn)
    check(lw.tn_source == "loaded" and lw.tn == win.tn
          and lw.row_splits == R_run, f"loaded lowering {lw.describe()}")
    seen = []
    orig = fsk.flashsketch_fwd

    def spy(plan, A, **kw):
        seen.append(kw)
        return orig(plan, A, **kw)

    gen = torch.Generator(device="cuda").manual_seed(8)
    A = torch.randn(main_plan.d, n, generator=gen, device="cuda")
    fsk.flashsketch_fwd = spy
    try:
        fsk.reset_launch_counts()
        Y = ops.sketch_apply(main_plan, A)
        launched = fsk.LAUNCHES["flashsketch_fwd"]
    finally:
        fsk.flashsketch_fwd = orig
    check(launched == 1 and seen == [dict(tn=win.tn, row_splits=R_run)],
          f"the loaded winner did not run: {seen}, {launched} launches")
    tune.clear_cache()
    check(torch.equal(Y, ops.sketch_apply(main_plan, A)),
          "the loaded winner's output != the rule's")
    tw = out[("transpose", "float32")][0]
    print(f"  saved and loaded {kept} winners; the main plan's forward "
          f"lowers to {lw.describe()} and ops.sketch_apply ran "
          f"flashsketch_fwd(tn={win.tn}, row_splits={R_run}) once, the "
          f"rule's bits; the transpose's winner tn={tw.tn} "
          f"R={tw.row_splits} ({'L2 route' if tw.row_splits else 'staged'})")
    for k in before:      # tuning launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return out


def phase_cost_model(rt, main_plan, n, rows):
    """``hw`` against the card's properties; the cost model's bound and
    modeled time of every kernel of the kernels line beside its measured
    time, and its bound within 1 % of the line's (the same work)."""
    hw, sm, lowering = rt["hw"], rt["sketch_model"], rt["lowering"]
    make_plan = rt["blockperm"].make_plan
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", None)
    smem = getattr(props, "shared_memory_per_block_optin", None)
    print(f"phase 8 (cost model): hw SMs {hw.SMS} / card "
          f"{props.multi_processor_count}; L2 {hw.L2_BYTES} / {l2} B; "
          f"shared memory a block {hw.MAX_SMEM_BYTES} / {smem} B")
    check(props.multi_processor_count == hw.SMS, "SM count")
    check(l2 in (None, hw.L2_BYTES), "L2 size")
    check(smem in (None, hw.MAX_SMEM_BYTES), "shared memory a block")
    total = props.total_memory
    print(f"  HBM_PER_CHIP {hw.HBM_PER_CHIP} / card total_memory {total} B "
          f"({total / hw.HBM_PER_CHIP:.4f}; within 2 %)")
    check(abs(total - hw.HBM_PER_CHIP) <= 0.02 * hw.HBM_PER_CHIP,
          "HBM_PER_CHIP")
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    cs = make_plan(main_plan.d, main_plan.k_req, family="countsketch", s=1,
                   seed=0)

    def lw(plan, n_, **kw):
        return lowering.lower(plan, lowering.LaunchSpec(n=n_, device="cuda",
                                                        **kw))
    costs = {
        "flashsketch_fwd": sm.cost_of(lw(main_plan, n)),
        "flashsketch_transpose": sm.cost_of(lw(main_plan, n, op="transpose")),
        "flashsketch_transpose_l2": sm.kernel_cost(
            main_plan, n, variant="transpose", route="l2"),
        "flashsketch_fwd_gather": sm.cost_of(lw(gplan, GRASS_CHUNK,
                                                gather=True)),
        "blockrow_fwd": sm.cost_of(lw(gplan, GRASS_CHUNK, op="blockrow")),
        "blockrow_fwd_gather": sm.cost_of(lw(gplan, GRASS_CHUNK,
                                             op="blockrow", gather=True)),
        "flashsketch_fwd_v1": sm.cost_of(lw(main_plan, n, impl="cuda_v1")),
        "flashsketch_transpose_v1": sm.cost_of(lw(
            main_plan, n, op="transpose", impl="cuda_v1")),
        "blockrow_fwd_v1": sm.cost_of(lw(main_plan, n, op="blockrow",
                                         impl="cuda_v1")),
        "flashsketch_fwd_partial": sm.cost_of(lw(main_plan, n, shard="row",
                                                 devices=4)),
        "blockrow_fwd_partial": sm.cost_of(lw(main_plan, n, op="blockrow",
                                              shard="row", devices=4)),
        "flashsketch_fwd_global": sm.cost_of(lw(cs, n)),
        "flashsketch_transpose_global": sm.cost_of(lw(cs, n,
                                                      op="transpose")),
        "flashsketch_fwd_gather_global": sm.cost_of(lw(cs, n, gather=True)),
    }
    for row in rows:
        kc = costs[row["name"]]
        print(f"  {row['name']:30s} measured {row['ms']:.4f} ms  bound "
              f"{row['bound_ms']:.5f} ms, cost_of {kc.bound_us / 1e3:.5f} "
              f"({kc.bound_by})  modeled kernel {kc.kernel_us / 1e3:.4f} ms "
              f"(hbm {kc.memory_s * 1e3:.4f}, l2 {kc.l2_s * 1e3:.4f})"
              f"{f', all-reduce {kc.collective_s * 1e3:.3f} ms' if kc.collective_bytes else ''}"
              f"  measured / modeled kernel "
              f"{row['ms'] / (kc.kernel_us / 1e3):.2f}")
        check(abs(kc.bound_us / 1e3 - row["bound_ms"])
              <= 0.01 * row["bound_ms"],
              f"{row['name']}: cost_of bound {kc.bound_us} us vs "
              f"{row['bound_ms']} ms")


def phase_health(rt, main_plan, d, n, cond):
    """The guarded solves on the card: the ``default`` preset with
    ``guard=True`` at the main size (healthy, one attempt, x the unguarded
    solve's bits, its extra wall time), once more with the OSE probe, the
    adversarial input at a small plan (recovered in ≥ 2 attempts), and the
    injector suite on the card."""
    solvers, inject, presets = rt["solvers"], rt["inject"], rt["presets"]
    make_plan = rt["blockperm"].make_plan
    A, b = make_ls_problem(d, n, cond)
    pre = presets["default"]
    kw = dict(k=rt["solver_sketch_rows"](n, pre.sampling_factor),
              kappa=pre.kappa, s=pre.s, dtype=pre.dtype,
              factorization=pre.factorization, method=pre.method,
              tol=pre.tol, max_iters=pre.max_iters, device="cuda")
    walls = {}
    res = {}
    for guard in (False, True, False, True):      # in turns, warm second
        torch.cuda.synchronize()
        t = time.perf_counter()
        res[guard] = solvers.sketch_precondition_lstsq(A, b, guard=guard,
                                                       **kw)
        torch.cuda.synchronize()
        walls.setdefault(guard, []).append(time.perf_counter() - t)
    g, u = res[True], res[False]
    h = g.health
    print(f"phase 8 (health): default preset at d={d}, n={n}, cond "
          f"{cond:g}, float64: guarded {h.status}, {h.attempts} attempt(s), "
          f"converged {g.converged} ({g.iterations} iterations, relres "
          f"{g.relres:.3e}); wall guarded {walls[True]} s, unguarded "
          f"{walls[False]} s: the guards add "
          f"{(walls[True][1] - walls[False][1]) * 1e3:.3f} ms warm")
    check(h.status == "healthy" and h.attempts == 1 and g.converged,
          f"guarded default solve: {h.describe()}")
    check(torch.equal(g.x, u.x), "guarded x != unguarded x")
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = solvers.sketch_precondition_lstsq(A, b, guard=True, probe=True, **kw)
    torch.cuda.synchronize()
    probe = [f for f in p.health.findings if f.guard == "ose_probe"]
    print(f"  with probe=True: {p.health.status}, {p.health.attempts} "
          f"attempt(s), {probe[0].describe()}; wall "
          f"{time.perf_counter() - t:.3f} s")
    check(p.health.status != "failed" and p.converged and
          len(probe) == 1, f"probed solve: {p.health.describe()}")
    plan = make_plan(512, 64, kappa=1, s=1, seed=0)
    Aa = inject.adversarial_input(plan, 8, seed=0, device="cuda")
    ba = Aa @ torch.ones(8, device="cuda")
    ra = solvers.sketch_precondition_lstsq(
        Aa, ba, k=plan.k_req, kappa=1, s=1, seed=0, guard=True, probe=True,
        tol=1e-5, device="cuda")
    print(f"  adversarial input at {plan.describe()}: {ra.health.status} "
          f"after {ra.health.attempts} attempts ({ra.health.actions}), "
          f"relres {ra.relres:.2e}")
    check(ra.health.attempts >= 2 and ra.health.status != "failed"
          and ra.converged, f"adversarial: {ra.health.describe()}")
    rc = inject.run_injector_suite(device="cuda", verbose=False)
    print(f"  injector suite on the card: exit {rc}; counters "
          f"{rt['report'].summarize_counters(max_items=100)}")
    check(rc == 0, "the injector suite failed on the card")


# ---------------------------------------------------------------------------
# Phase 9: the sketch server at the main plan.
# ---------------------------------------------------------------------------

# requests of n = 128 fp32 columns (32 MiB at d = 65 536), groups of 8: a
# full group folds to n = 1 024, the shape phase 4 times row 1 at
SERVE_N, SERVE_BATCH = 128, 8
# the solve request: phase 3's problem (n = 1 024)
SERVE_SOLVE_N = 1024


class LaunchTally:
    """The serving path's launches: ``run(fn)`` adds what ``fn`` launched;
    the launches that compare or time a kernel run outside it."""

    def __init__(self, fsk):
        self.fsk = fsk
        self.counts = {k: 0 for k in fsk.LAUNCHES}

    def run(self, fn, *args, **kwargs):
        before = dict(self.fsk.LAUNCHES)
        try:
            return fn(*args, **kwargs)
        finally:
            for k in before:
                self.counts[k] += self.fsk.LAUNCHES[k] - before[k]


def serve_group(sv, srv, tally, operands, params, tenant="t", **req_kw):
    """Submit one request per operand, run one step past the window, and
    return the responses (submission order)."""
    tickets = [srv.submit(sv.SketchRequest(tenant, "sketch", A,
                                           dict(params), **req_kw))
               for A in operands]
    srv.clock.advance(2 * srv.batcher.batch_wait_s)
    tally.run(srv.run_pending)
    return [t if not isinstance(t, int) else srv.poll(t) for t in tickets]


def _spy_fwd(fsk, seen):
    """Replace ``flashsketch_fwd`` by a spy recording each call's (plan,
    columns, kwargs); returns the original, to put back."""
    orig = fsk.flashsketch_fwd

    def spy(plan, A, **kw):
        seen.append((plan, A.shape[1], kw))
        return orig(plan, A, **kw)
    fsk.flashsketch_fwd = spy
    return orig


def _max_rel_err(got, want):
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def serve_coalescing(rt, srv_kw, params, pool, tally):
    """A group of 8 of one (tenant, plan) and one request of another seed:
    two launches; a loaded winner of the batched class (an R not the
    rule's) reaches the launch; each coalesced result ``torch.equal`` to
    its own launch."""
    sv, fsk, ops, tune, lowering = rt["serving"], rt["fsk"], rt["ops"], \
        rt["tune"], rt["lowering"]
    srv = sv.SketchServer(**srv_kw)
    plan = srv.plans.resolve("t", params)
    rule = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    R_win = next(R for R in (2 * rule.row_splits, rule.row_splits // 2)
                 if R in fsk.split_allowed(plan))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "winners.json")
        key = tune.cache_key(plan, SERVE_N, "fwd", "cuda",
                             batch=SERVE_BATCH)
        with open(path, "w") as f:
            json.dump({json.dumps(list(key)): dataclasses.asdict(
                tune.TuneResult(tn=rule.tn, row_splits=R_win, time_us=1.0,
                                source="tuned"))}, f)
        check(tune.load_cache(path) == 1, "the batched winner did not load")
    group_lw = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    seen = []
    orig = _spy_fwd(fsk, seen)
    before = dict(fsk.LAUNCHES)
    try:
        tickets = [srv.submit(sv.SketchRequest("t", "sketch", A,
                                               dict(params)))
                   for A in pool]
        tickets.append(srv.submit(sv.SketchRequest(
            "t", "sketch", pool[0], dict(params, seed=params["seed"] + 1))))
        srv.clock.advance(2 * srv.batcher.batch_wait_s)
        tally.run(srv.run_pending)
    finally:
        fsk.flashsketch_fwd = orig
    launched = fsk.LAUNCHES["flashsketch_fwd"] - before["flashsketch_fwd"]
    resps = [srv.poll(t) for t in tickets]
    tune.clear_cache()
    calls = [(p.seed, n_, kw) for p, n_, kw in seen]
    print(f"phase 9 (serving): coalescing at {plan.describe()}, requests of "
          f"n={SERVE_N} fp32 ({plan.d * SERVE_N * 4 >> 20} MiB), max_batch "
          f"{SERVE_BATCH}: the group lowers to {group_lw.describe()} (the "
          f"rule's: tn={rule.tn}, R={rule.row_splits}); flashsketch_fwd "
          f"calls {calls}, {launched} launches")
    check(launched == 2 and len(calls) == 2, f"{launched} launches, {calls}")
    check(calls[0] == (params["seed"], SERVE_N * SERVE_BATCH,
                       dict(tn=group_lw.tn, row_splits=R_win))
          and group_lw.tn_source == "loaded",
          f"the batched winner's (tn, R) did not reach the launch: {calls}")
    check(calls[1][:2] == (params["seed"] + 1, SERVE_N),
          f"the other seed's launch: {calls[1]}")
    check([r.batch_size for r in resps] == [SERVE_BATCH] * SERVE_BATCH + [1]
          and all(r.status == "ok" for r in resps),
          f"{[(r.status, r.batch_size) for r in resps]}")
    for r, A in zip(resps, pool):
        check(r.result.is_cuda and torch.equal(r.result,
                                               ops.sketch_apply(plan, A)),
              "a coalesced result != its own launch")
    print(f"  each of the 8 coalesced results torch.equal to "
          f"ops.sketch_apply(plan, A_j) (rule tn={rule.tn}, R="
          f"{rule.row_splits} at n={SERVE_N}) on the card; the other seed "
          f"launched on its own")


def serve_profile(rt, srv_kw, params, pool, tally):
    """One warm guarded group of 8: host wall split into the launch (stack,
    fold, kernel; synchronised), the guards and the rest; device time by
    kernel under ``torch.profiler``; the stack, fold and kernel each timed
    with CUDA events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    sv, fsk, ops, lowering = rt["serving"], rt["fsk"], rt["ops"], \
        rt["lowering"]
    srv = sv.SketchServer(**srv_kw)
    host = {"launch": 0.0, "guards": 0.0}
    timed_, guard_ = srv._timed, srv._guard_slice

    def timed_spy(*a, **kw):
        t = time.perf_counter()
        try:
            return timed_(*a, **kw)
        finally:
            host["launch"] += time.perf_counter() - t

    def guard_spy(*a, **kw):
        t = time.perf_counter()
        try:
            return guard_(*a, **kw)
        finally:
            host["guards"] += time.perf_counter() - t
    srv._timed, srv._guard_slice = timed_spy, guard_spy
    walls = []
    for _ in range(3):                     # the first is the warm-up
        host.update(launch=0.0, guards=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        resps = serve_group(sv, srv, tally, pool, params)
        walls.append(time.perf_counter() - t)
        check(all(r.status == "ok" for r in resps), "profiled group")
    split = dict(host)
    # a session that follows earlier ones in the process missed its first
    # kernels and received kernels of earlier sessions: a throwaway
    # session goes first, then one traced but discarded step (the
    # schedule's warm-up), and of the second group's step only the
    # launch's three kernels are read, by name
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            serve_group(sv, srv, tally, pool, params)
            torch.cuda.synchronize()
            prof.step()
    parts = {"stack": "CatArrayBatchedCopy", "fold": "direct_copy",
             "kernel": "split_vec_kernel"}
    dev = dict.fromkeys(parts, 0.0)
    for e in (traced[0] if traced else []):
        for part, key in parts.items():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and key in e.key):
                dev[part] += e.self_device_time_total / 1e3
    wall = walls[-1] * 1e3
    print(f"  guarded group of {SERVE_BATCH} (warm, host clock): wall "
          f"{wall:.3f} ms (runs {[round(w * 1e3, 3) for w in walls]}): "
          f"launch {split['launch'] * 1e3:.3f} ms (stack + fold + kernel, "
          f"synchronised), guards {split['guards'] * 1e3:.3f} ms "
          f"({SERVE_BATCH} requests x 3 host reads), the rest "
          f"{wall - (split['launch'] + split['guards']) * 1e3:.3f} ms "
          f"(submit, batching, slicing, responses)")
    if min(dev.values()) == 0:
        print(f"  the launch's device time by part: the profiler missed a "
              f"part ({dev}; not measured)")
        dev = None
    else:
        print("  the launch's device time by part (torch.profiler, one "
              "group): " + ", ".join(f"{k} {v:.4f} ms"
                                     for k, v in dev.items()))
    # the two copies of the whole batch, the kernel, and the guards' own
    # kernels back to back (their host reads left out), by CUDA events
    plan = srv.plans.resolve("t", params)
    lw = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    stacked = torch.stack(pool)
    flat = stacked.movedim(0, 1).reshape(plan.d, -1)
    before = dict(fsk.LAUNCHES)
    Y = ops.sketch_apply_batched(plan, stacked)

    def guard_kernels():
        for A, Yj in zip(pool, Y):
            torch.isfinite(Yj).sum()
            torch.linalg.norm(A)
            torch.linalg.norm(Yj)
    ms = dict(
        stack=cuda_ms(lambda: torch.stack(pool)),
        fold=cuda_ms(lambda: stacked.movedim(0, 1).reshape(plan.d, -1)),
        kernel=cuda_ms(lambda: fsk.flashsketch_fwd(
            plan, flat, tn=lw.tn, row_splits=lw.row_splits)),
        group=cuda_ms(lambda: ops.sketch_apply_batched(
            plan, torch.stack(pool))),
        guard_kernels=cuda_ms(guard_kernels))
    fsk.LAUNCHES.update(before)           # timing launches are not served
    print("  CUDA events (median of 15): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()) +
        f"; the stack and the fold each copy the whole batch "
        f"({SERVE_BATCH * plan.d * SERVE_N * 4 >> 20} MiB)")
    return dict(wall_ms=wall, launch_ms=split["launch"] * 1e3,
                guards_ms=split["guards"] * 1e3, device=dev, events=ms)


def serve_rungs(rt, srv_kw, params, pool, tally):
    """Backpressure driven to each level of the ladder; each level's
    first group runs the CUDA kernel at its rung (fp32, bf16, fp8 with
    stochastic rounding, fp8 on the κ-halved plan), within the policy's
    tolerance of the plain version of the same plan and dtype; its group
    time (CUDA events) beside fp32's."""
    sv, fsk, ops, report = rt["serving"], rt["fsk"], rt["ops"], rt["report"]
    depth = {1: 16, 2: 24, 3: 28, 4: 32}     # of max_queue = 32
    want = {1: ("float32", 4, "ok"), 2: ("bfloat16", 4, "degraded"),
            3: ("fp8_e4m3_sr", 4, "degraded"),
            4: ("fp8_e4m3_sr", 2, "degraded")}
    rungs = {1: ("batch_wait",), 2: ("batch_wait", "dtype"),
             3: ("batch_wait", "dtype"),
             4: ("batch_wait", "dtype", "lowering")}
    out = {}
    for level, q in depth.items():
        srv = sv.SketchServer(**srv_kw)
        report.reset_counters()
        tickets = [srv.submit(sv.SketchRequest("t", "sketch",
                                               pool[i % len(pool)],
                                               dict(params)))
                   for i in range(q)]
        seen = []
        orig = _spy_fwd(fsk, seen)
        try:
            tally.run(srv.run_pending)      # one group, at this level
        finally:
            fsk.flashsketch_fwd = orig
        check(srv.ladder.level == level, f"ladder at {srv.ladder.level}, "
              f"not {level}, at depth {q}")
        first = [srv.poll(t) for t in tickets[:SERVE_BATCH]]
        check(all(r is not None for r in first), "the first group")
        tally.run(srv.drain)
        dtype, kappa, status = want[level]
        eff = seen[0][0] if seen else None
        check(len(seen) == 1 and eff.dtype == dtype and eff.kappa == kappa,
              f"level {level}: the kernel ran {[(p.dtype, p.kappa) for p, _, _ in seen]}")
        errs = []
        for r, A in zip(first, pool):
            plain = ops.sketch_apply(eff, A, impl="torch")
            errs.append(_max_rel_err(r.result, plain))
            check(r.status == status, f"level {level}: {r.status}")
        atol = eff.precision.exactness_atol
        counters = {k: v for k, v in report.counters().items()
                    if k.startswith("serve.")}
        before = dict(fsk.LAUNCHES)
        ms = cuda_ms(lambda: ops.sketch_apply_batched(
            eff, torch.stack(pool)), warmup=1,
            reps=5 if eff.precision.is_fp8 else 15)
        fsk.LAUNCHES.update(before)       # timing launches are not served
        out[level] = dict(dtype=dtype, kappa=kappa, ms=ms,
                          max_rel_err=max(errs))
        print(f"  ladder level {level} (depth {q}/32): {dtype}, "
              f"kappa={kappa}, {first[0].status}; findings "
              f"{[(f.target, f.status) for f in first[0].health.findings if f.guard == 'degrade']}; "
              f"max err / max|plain| {max(errs):.3e} (atol {atol:g}); "
              f"group {ms:.4f} ms (events), {ms / out[1]['ms']:.2f}x "
              f"level 1's; counters {counters}")
        check(max(errs) <= atol, f"level {level}: error {max(errs)} > "
              f"{atol}")
        check(counters.get("serve.ladder.up", 0) >= 1
              and all(counters.get(f"serve.degrade.{t}", 0) >= 1
                      for t in rungs[level]),
              f"level {level}: counters {counters}")
    return out


def serve_faults(rt, srv_kw, params, pool, tally, adv):
    """A NaN-poisoned operand fails fast; the annihilated direction of the
    κ = 1, s = 1 plan recovers by redraw; the breaker trips and recovers in
    virtual time; the reference's adversarial operand at n = 128 is
    printed with its verdict."""
    sv, inject, report = rt["serving"], rt["inject"], rt["report"]
    srv = sv.SketchServer(**srv_kw)
    report.reset_counters()
    r = serve_group(sv, srv, tally, [inject.inject_nan(pool[0], count=2,
                                                   seed=1)], params)[0]
    print(f"  NaN operand: {r.status}, {r.attempts} attempt(s), "
          f"{r.health.actions}")
    check(r.status == "failed" and r.attempts == 1
          and "unrecoverable_operand" in r.health.actions, "NaN operand")
    adv_params, A_adv = adv
    r = serve_group(sv, srv, tally, [A_adv], adv_params)[0]
    print(f"  annihilated direction of "
          f"{srv.plans.resolve('t', adv_params).describe()} (n=1): "
          f"{r.status}, {r.attempts} attempts, {r.health.actions}")
    check(r.status == "degraded" and r.attempts >= 2
          and bool(torch.isfinite(r.result).all()), "adversarial input")
    plan = srv.plans.resolve("t", adv_params)
    A128 = inject.adversarial_input(plan, SERVE_N, seed=3, device="cuda")
    r = serve_group(sv, srv, tally, [A128], adv_params)[0]
    iso = [f for f in r.health.findings if f.guard == "isometry"]
    print(f"  the injector's adversarial operand at n={SERVE_N} (column 0 "
          f"annihilated, noise 1e-3): {r.status}, flagged {r.flagged}, "
          f"isometry ratio {iso[0].value:.4f} (a Frobenius check sees one "
          f"annihilated column of {SERVE_N} as a "
          f"{abs(1 - iso[0].value):.3f} deviation)")
    bsrv = sv.SketchServer(**dict(srv_kw, breaker=sv.CircuitBreaker(
        fail_threshold=2, cooldown_s=1.0)))
    report.reset_counters()
    for _ in range(2):
        serve_group(sv, bsrv, tally, [A_adv], adv_params)
    tripped = {s["state"] for s in bsrv.breaker.snapshot().values()}
    r = serve_group(sv, bsrv, tally, [A_adv], adv_params, deadline_s=100.0)[0]
    suppressed = r.attempts == 1 and any(f.guard == "breaker"
                                         for f in r.health.findings)
    bsrv.clock.advance(2.0)
    r2 = serve_group(sv, bsrv, tally, [pool[0][:, :1]], adv_params)[0]
    closed = {s["state"] for s in bsrv.breaker.snapshot().values()}
    c = report.counters()
    print(f"  breaker: {tripped} after two failed first draws, then "
          f"{r.status} in {r.attempts} attempt (retries suppressed: "
          f"{suppressed}); after the 1 s cool-down (virtual) {r2.status}, "
          f"{closed}; counters trip/half_open/close "
          f"{c.get('serve.breaker.trip')}/{c.get('serve.breaker.half_open')}"
          f"/{c.get('serve.breaker.close')}")
    check(tripped == {"open"} and suppressed and r2.status == "ok"
          and closed == {"closed"} and c.get("serve.breaker.trip") == 1
          and c.get("serve.breaker.half_open") == 1
          and c.get("serve.breaker.close") == 1, "breaker trip/recover")


def serve_solve(rt, srv_kw, d, cond, tally):
    """Phase 3's problem at n = 1 024 as a guarded solve request: x
    ``torch.equal`` to a direct call with the same plan and policy, and
    within ``10·cond·tol`` of ``torch.linalg.lstsq``."""
    sv, solvers, presets = rt["serving"], rt["solvers"], rt["presets"]
    n = SERVE_SOLVE_N
    pre = presets["default"]
    A, b = make_ls_problem(d, n, cond)
    x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    params = dict(d=d, k=rt["solver_sketch_rows"](n, pre.sampling_factor),
                  kappa=pre.kappa, s=pre.s, seed=0, dtype=pre.dtype)
    kw = dict(factorization=pre.factorization, method=pre.method,
              tol=pre.tol, max_iters=pre.max_iters)
    srv = sv.SketchServer(**srv_kw)
    t = srv.submit(sv.SketchRequest("t", "solve", A, params, rhs=b,
                                    solver_kwargs=kw))
    srv.clock.advance(2 * srv.batcher.batch_wait_s)
    tally.run(srv.run_pending)
    r = srv.poll(t)
    direct = solvers.sketch_precondition_lstsq(
        A, b, srv.plans.resolve("t", params), guard=True,
        policy=sv.SERVE_POLICY, device="cuda", **kw)
    res = r.result
    err = float(torch.linalg.vector_norm(res.x - x_ref)
                / torch.linalg.vector_norm(x_ref))
    print(f"  solve request (d={d}, n={n}, cond {cond:g}, float64, guarded): "
          f"{r.status}, {res.iterations} iterations, relres "
          f"{res.relres:.3e}, |x-x_lstsq|/|x_lstsq| {err:.3e} (bound "
          f"{10 * cond * pre.tol:.0e}); x == the direct call's: "
          f"{torch.equal(res.x, direct.x)}; latency {r.latency_s * 1e3:.3f} "
          f"ms")
    check(r.status == "ok" and res.converged, f"solve: {r.status}")
    check(torch.equal(res.x, direct.x), "served x != the direct call's x")
    check(err <= 10 * cond * pre.tol, f"solve error {err}")


def serve_threaded(rt, params, pool, tally, adv):
    """The threaded server under 2 s of Poisson arrivals (200 per s) at the
    main plan, launch/serve.py's faults woven in: every seventh request
    NaN-poisoned, every seventh the annihilated direction; no lost
    response, no silent failure."""
    sv, cli, inject = rt["serving"], rt["serve_cli"], rt["inject"]
    adv_params, A_adv = adv

    def draw(i):
        if i % 7 == 3:
            return (inject.inject_nan(pool[i % len(pool)], count=2, seed=i),
                    params, "nan")
        if i % 7 == 5:
            return A_adv, adv_params, "adversarial"
        return pool[i % len(pool)], params, None

    def run():
        with sv.ThreadedServer(max_batch=SERVE_BATCH, batch_wait_s=0.002,
                               max_queue=4 * SERVE_BATCH,
                               device="cuda") as srv:
            out = cli.poisson_load(srv, draw, rps=200.0, duration_s=2.0,
                                   seed=0, timeout_s=60.0)
            return out + (srv.stats(),)
    try:
        responses, faulty, stats = tally.run(run)
    except TimeoutError as exc:
        raise SmokeFailure(f"threaded server lost a response: {exc}")
    lat = sorted(r.latency_s for r in responses if r.served)
    statuses = {}
    for r in responses:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    silent = cli.silent_failures(responses, faulty)
    sizes = sorted({r.batch_size for r in responses})
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"  threaded server, Poisson 200/s for 2 s (wall clock): "
          f"{len(responses)} responses {statuses}, batch sizes {sizes}; "
          f"{len(faulty)} faults, silent failures {len(silent)}; latency "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms; breakers "
          f"{stats['breakers']}")
    check(all(r is not None for r in responses), "lost responses")
    check(not silent, f"silent failures: {silent}")
    return dict(p50_ms=p50, p99_ms=p99, statuses=statuses)


def serve_bench_twin(rt, d, k, tally):
    """``benchmarks/torch_serve_bench.py``'s virtual-time harness at the
    main plan: the guarded and unguarded runs of one Poisson schedule
    (200 per s, 400 requests, deadline 1 s).  Fails on lost responses or
    an ``ok`` result that is not finite; prints the 25 % gate's verdict
    (the bench's own gate, not this phase's)."""
    bench = rt["serve_bench"]
    tally.run(bench.warmup, d=d, n=SERVE_N, k=k, device="cuda")
    res = {}
    for guard in (False, True):
        try:
            r = tally.run(bench.run_load, d=d, n=SERVE_N, k=k, rps=200.0,
                          count=400, guard=guard, seed=0, deadline_s=1.0,
                          device="cuda")
        except RuntimeError as exc:
            raise SmokeFailure(f"bench twin: {exc}")
        res[guard] = r
        print(f"  bench twin guard={guard}: p50 {r['p50_ms']:.3f} ms p99 "
              f"{r['p99_ms']:.3f} ms, {r['throughput_rps']:.1f} served/s "
              f"(virtual), {r['statuses']}")
        check(not r["silent_ok_nonfinite"], f"bench twin: non-finite ok "
              f"results {r['silent_ok_nonfinite']}")
    over = (res[True]["p99_ms"] - res[False]["p99_ms"]) / res[False]["p99_ms"]
    print(f"  bench twin: guarded p99 overhead {over * 100:+.1f}% (the "
          f"bench's gate is <= 25%: {'held' if over <= 0.25 else 'missed'})")
    return dict(p99_overhead=over, guarded=res[True]["p99_ms"],
                unguarded=res[False]["p99_ms"])


def phase_serving(rt, main_plan, d, cond):
    """The sketch server at the main plan: coalescing (and a batched
    winner's R at the launch), a profiled guarded group, every rung of the
    ladder, the faults, a solve request, the threaded server under
    Poisson load, and the bench twin.  Returns the served launches."""
    fsk, inject = rt["fsk"], rt["inject"]
    sv = rt["serving"]
    fsk.reset_launch_counts()
    tally = LaunchTally(fsk)
    params = dict(d=d, k=main_plan.k_req, kappa=main_plan.kappa,
                  s=main_plan.s, seed=main_plan.seed)
    gen = torch.Generator(device="cuda").manual_seed(9)
    pool = [torch.randn(d, SERVE_N, generator=gen, device="cuda")
            for _ in range(SERVE_BATCH)]
    srv_kw = dict(clock=sv.ManualClock(), max_batch=SERVE_BATCH,
                  batch_wait_s=0.01, max_queue=4 * SERVE_BATCH,
                  device="cuda")

    def fresh():
        return dict(srv_kw, clock=sv.ManualClock())
    adv_params = dict(params, kappa=1, s=1)
    adv_plan = rt["blockperm"].make_plan(d, main_plan.k_req, kappa=1, s=1,
                                         seed=main_plan.seed)
    adv = (adv_params, inject.adversarial_input(adv_plan, 1, seed=0,
                                                device="cuda"))
    serve_coalescing(rt, fresh(), params, pool, tally)
    prof = serve_profile(rt, fresh(), params, pool, tally)
    rungs = serve_rungs(rt, fresh(), params, pool, tally)
    serve_faults(rt, fresh(), params, pool, tally, adv)
    serve_solve(rt, fresh(), d, cond, tally)
    threaded = serve_threaded(rt, params, pool, tally, adv)
    bench = serve_bench_twin(rt, d, main_plan.k_req, tally)
    launches = {k: v for k, v in tally.counts.items() if v}
    print(f"  launch counts over phase 9 (served, not the comparisons): "
          f"{launches}")
    check(launches.get("flashsketch_fwd", 0) > 0,
          "flashsketch_fwd never launched in phase 9")
    print("serving: " + json.dumps(dict(
        profile=prof, rungs=rungs, threaded=threaded, bench=bench)))
    return tally.counts


# ---------------------------------------------------------------------------
# Phase 10: the trainer at the full width of qwen3-0.6b.
# ---------------------------------------------------------------------------

# launch/train.py's defaults with --grad-compress 8; 12 steps, the
# checkpoint at step 12, one resumed step.  The synthetic stream draws its
# tokens from the first TRAIN_DATA_VOCAB ids of the 151 936 (the model and
# its head stay at full width): over all of them its bigrams show no trend
# in 20 steps, the loss staying within batch-to-batch noise of 12.08 at
# every learning rate tried, compressed or not (PERF.md §6;
# tools/torch_train_sweep.py).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_RATIO = "qwen3-0.6b", 4, 128, 8
TRAIN_STEPS, TRAIN_LR, TRAIN_DATA_VOCAB = 12, 3e-3, 4096


class StepClock:
    """Spies on one trainer's step, the compression and the optimizer:
    each synchronises the card before and after, so a step's host wall
    splits into forward+backward (the rest), compression and optimizer.
    Records the peak memory before and after the first step."""

    def __init__(self, trainer, ts):
        self.rows, self.mem, self.part = [], None, {}
        self._ts = ts
        self._orig = (ts.gc.compress_gradients, ts.adamw.apply_updates)
        step_fn = trainer.step_fn

        def timed_part(name, fn):
            def spy(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.part[name] = time.perf_counter() - t
                return out
            return spy

        def step(*args):
            before = torch.cuda.max_memory_allocated()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if self.mem is None:
                self.mem = (before, torch.cuda.max_memory_allocated())
            self.rows.append(dict(wall=wall, **self.part))
            return out
        trainer.step_fn = step
        ts.gc.compress_gradients = timed_part("compress", self._orig[0])
        ts.adamw.apply_updates = timed_part("optimizer", self._orig[1])

    def close(self):
        self._ts.gc.compress_gradients, self._ts.adamw.apply_updates = \
            self._orig


def spy_plain(rt, calls):
    """Count every call of a plain version (``ref.*_ref``, also through the
    lowering's table of them); returns a function that puts them back."""
    ref, oracles = rt["ref"], rt["lowering"]._ORACLES
    orig = {name: getattr(ref, name) for name in dir(ref)
            if name.endswith("_ref") and callable(getattr(ref, name))}
    orig_oracles = dict(oracles)

    def wrap(name, fn):
        def spy(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return spy
    for name, fn in orig.items():
        setattr(ref, name, wrap(name, fn))
    for op, fn in orig_oracles.items():
        oracles[op] = wrap(fn.__name__, fn)

    def restore():
        for name, fn in orig.items():
            setattr(ref, name, fn)
        oracles.update(orig_oracles)
    return restore


def csr_library(rt, plan, transpose=False):
    """S (Sᵀ) of ``plan`` as ``torch.sparse`` CSR tensors on the card, bands
    of consecutive rows of at most 2**30 nonzeros each with int32 indices
    (on the H100, cuSPARSE's SpMM failed with an internal error on the
    int64 CSR of 2.68 G nonzeros and on an int32 band of 2.15 G; one of
    1.34 G ran), from the kernels' own CSR (S's:
    ``_device_csr``; Sᵀ's: an uncached ``_device_csr_t``), columns sorted
    within each row, built in chunks of rows: the yardstick
    ``torch.sparse.mm`` multiplies with, band by band; the port never
    calls it."""
    fsk = rt["fsk"]
    dev = torch.device("cuda", torch.cuda.current_device())
    if transpose:
        ptr, ent = fsk._device_csr_t.__wrapped__(plan, dev)
        shape = (plan.d_pad, plan.k_pad)
    else:
        ptr, ent = fsk._device_csr(plan, dev, False)
        shape = (plan.k_pad, plan.d_pad)
    crow = ptr[::plan.kappa].contiguous()
    del ptr
    limit = 2**30
    bands, r0 = [], 0
    while r0 < shape[0]:
        r1 = int(torch.searchsorted(crow, crow[r0] + limit, right=True)) - 1
        r1 = min(shape[0], max(r1, r0 + 1))
        bands.append(_csr_band(plan, ent, crow, r0, r1, shape[1], dev))
        r0 = r1
    return bands


def _csr_band(plan, ent, crow, r0, r1, cols, dev):
    """Rows [r0, r1) of the CSR (``ent``, ``crow``) as a torch.sparse CSR
    tensor with int32 indices and ±scale values."""
    base, end = int(crow[r0]), int(crow[r1])
    bcrow = (crow[r0:r1 + 1] - base).to(torch.int32)
    col = torch.empty(end - base, dtype=torch.int32, device=dev)
    val = torch.empty(end - base, dtype=torch.float32, device=dev)
    rows_per = max(1, (1 << 26) // max(1, (end - base) // (r1 - r0)))
    for q0 in range(r0, r1, rows_per):
        q1 = min(r1, q0 + rows_per)
        a, b = int(crow[q0]), int(crow[q1])
        e = ent[a:b].to(torch.int64)
        row = torch.repeat_interleave(torch.arange(q1 - q0, device=dev),
                                      crow[q0 + 1:q1 + 1] - crow[q0:q1])
        order = torch.argsort(row * cols + (e >> 1))
        e = e[order]
        col[a - base:b - base] = (e >> 1).to(torch.int32)
        val[a - base:b - base] = torch.where((e & 1).bool(), -plan.scale,
                                             plan.scale)
        del e, row, order
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # beta-state notices
        return torch.sparse_csr_tensor(bcrow, col, val, (r1 - r0, cols))


def sparse_mm(bands, operand):
    """``torch.sparse.mm`` of each band of S by ``operand``, stacked."""
    if len(bands) == 1:
        return torch.sparse.mm(bands[0], operand)
    return torch.cat([torch.sparse.mm(b, operand) for b in bands])


def csr_bytes(rt, plans):
    """Bytes of the CSRs the training path holds for ``plans``: S's (int32
    words, int64 ptr) and the staged transpose's tile-local Sᵀ (int16
    words, no ptr)."""
    fsk = rt["fsk"]
    dev = torch.device("cuda", torch.cuda.current_device())
    return sum(t.numel() * t.element_size() for plan, _ in plans
               for t in fsk._device_csr(plan, dev, False)
               + fsk._device_csr_t(plan, dev, tile_local=True)
               if t is not None)


def train_plans(rt, params, comp):
    """The distinct plans of the compressed leaves of ``params``, with the
    leaves each serves, largest first."""
    leaves = {}
    for path, p in rt["tree"].leaves_with_path(params):
        plan = rt["gc"].plan_for_leaf(comp, p.numel())
        if plan is not None:
            leaves.setdefault(plan, []).append(".".join(path))
    return sorted(leaves.items(), key=lambda kv: -kv[0].d_pad)


def train_live(rt, cfg, opt, data_cfg, comp, ckpt_dir):
    """The live run: ``Trainer.fit`` for TRAIN_STEPS steps with a
    checkpoint at the last; its launches and plain-version calls counted,
    its steps timed.  Returns (trainer, fit's output, clock, launches)."""
    fsk = rt["fsk"]
    tcfg = rt["trainer"].TrainerConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=ckpt_dir,
        log_every=4)
    trainer = rt["trainer"].Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                                    device="cuda")
    clock = StepClock(trainer, rt["train_step"])
    calls = {}
    restore_plain = spy_plain(rt, calls)
    torch.cuda.reset_peak_memory_stats()
    fsk.reset_launch_counts()
    try:
        out = trainer.fit()
        torch.cuda.synchronize()
    finally:
        restore_plain()
        clock.close()
    launches = dict(fsk.LAUNCHES)
    shown = {k: v for k, v in launches.items() if v}
    print(f"  launch counts over the {TRAIN_STEPS} steps of Trainer.fit: "
          f"{shown}; plain-version calls: {calls or 0}")
    for name in NARROW_KERNELS:
        check(launches[name] == 10 * TRAIN_STEPS,
              f"{name}: {launches[name]} launches, not 10 a step")
    check(sum(launches.values()) == 20 * TRAIN_STEPS,
          f"launches other than the narrow forward and transpose (a wide "
          f"launch at n = 1): {shown}")
    check(not calls, f"a plain version ran on the main path: {calls}")
    losses = out["losses"]
    print(f"  losses: {[round(x, 4) for x in losses]}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                             for x in losses),
          "a loss is not finite")
    check(statistics.fmean(losses[-3:]) < losses[0],
          f"loss did not fall: first {losses[0]}, last three "
          f"{losses[-3:]}")
    return trainer, out, clock, launches


def train_resume(rt, cfg, opt, data_cfg, comp, ckpt_dir, live, out):
    """The checkpoint of step TRAIN_STEPS restored into a fresh Trainer:
    every tensor equal to the live state, and its first step's loss the
    live run's at that step, bit for bit."""
    tr = rt["tree"]
    tcfg = rt["trainer"].TrainerConfig(total_steps=TRAIN_STEPS + 1,
                                       ckpt_dir=ckpt_dir)
    logs = []
    fresh = rt["trainer"].Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                                  log_fn=logs.append, device="cuda")
    t = time.perf_counter()
    params, opt_state, err, start = fresh.maybe_restore(*fresh.init_state())
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check(start == TRAIN_STEPS, f"resumed at step {start}")
    saved = {"params": out["final_params"], "opt": out["final_opt"],
             "err": out["final_err"]}
    got = {"params": params, "opt": opt_state, "err": err}
    pairs = list(zip(tr.leaves_with_path(got), tr.leaves_with_path(saved)))
    for (pa, a), (pb, b) in pairs:
        check(pa == pb and a.dtype == b.dtype and a.device == b.device
              and torch.equal(a, b), f"restored {tr.keystr(pa)} differs")
    _, _, _, m = fresh.step_fn(params, opt_state, err,
                               fresh.batch(TRAIN_STEPS))
    resumed = float(m["loss"])
    _, _, _, m = live.step_fn(out["final_params"], out["final_opt"],
                              out["final_err"], live.batch(TRAIN_STEPS))
    live_loss = float(m["loss"])
    print(f"  checkpoint of step {TRAIN_STEPS}: {len(pairs)} tensors "
          f"restored torch.equal ({restore_s:.1f} s with the fresh "
          f"trainer's init); resumed loss {resumed!r}, live loss "
          f"{live_loss!r}; {logs}")
    check(resumed == live_loss, "the resumed loss is not the live one")


def train_profile(rt, trainer, out):
    """One more warm step of the live run under ``torch.profiler``: the
    device's busy time against the step's host wall, and the device time
    of the sketch kernels, the other kernels by name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fsk = rt["fsk"]
    before = dict(fsk.LAUNCHES)
    args = (out["final_params"], out["final_opt"], out["final_err"],
            trainer.batch(TRAIN_STEPS + 1))
    with profile(activities=[ProfilerActivity.CUDA]):    # a throwaway
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step_fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    for k in before:
        fsk.LAUNCHES[k] = before[k]
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    sketch = sum(ms for k, ms, _ in kernels
                 if "split_narrow_kernel" in k or "narrow_transpose" in k)
    print(f"  one profiled step: host wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / (wall * 1e3):.2f}); the "
          f"sketch kernels {sketch:.1f} ms; {len(kernels)} kernel names, "
          f"{sum(c for _, _, c in kernels)} launches; largest:")
    for key, ms, count in sorted(kernels, key=lambda r: -r[1])[:8]:
        print(f"    {ms:8.2f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, sketch_ms=sketch,
                kernel_launches=sum(c for _, _, c in kernels))


def clear_csr_caches(rt):
    """Drop every cached per-plan CSR and table (each lru_cache's
    cache_clear) and return the memory to the card."""
    fsk = rt["fsk"]
    for cached in (fsk._device_csr, fsk._device_csr_t, fsk._device_table,
                   fsk._csr_block_cap):
        cached.cache_clear()
    torch.cuda.empty_cache()


def library_ms(rt, plan, operand, transpose, free_csrs):
    """``torch.sparse.mm`` of S (Sᵀ) in CSR by ``operand``, band by band
    (``csr_library``): (CUDA-event ms, result), or (None, None) where the
    CSR does not fit the card beside what it holds (the yardstick only:
    the port never calls it).  With ``free_csrs`` the kernels' cached
    CSRs are dropped first.  Returns also the number of bands."""
    if free_csrs:
        clear_csr_caches(rt)
    try:
        S = csr_library(rt, plan, transpose=transpose)
        out = sparse_mm(S, operand)
        ms = cuda_ms(lambda: sparse_mm(S, operand))
        bands = len(S)
    except torch.cuda.OutOfMemoryError:
        S = out = ms = bands = None
    del S
    torch.cuda.empty_cache()
    return ms, out, bands


def csr_floor_ms(plan, op):
    """The least time of a kernel that reads S (Sᵀ) from the port's CSR at
    n = 1: cost_of's bytes (the operand read once, the output written once)
    plus the CSR read once, the forward's 4-byte words and 8-byte ptr
    entries, the transpose's 2-byte tile-local words, at HBM_BYTES_PER_S."""
    item, nnz = plan.stream_itemsize, plan.nnz_per_col * plan.d_pad
    if op == "fwd":
        nbytes = (plan.d_pad * item + plan.k_pad * 4 + 4 * nnz
                  + 8 * (plan.k_pad * plan.kappa + 1))
    else:
        nbytes = plan.k_pad * item + plan.d_pad * 4 + 2 * nnz
    return nbytes / HBM_BYTES_PER_S * 1e3


def n1_bound(plan, op):
    """(bound ms, bound_by) of one n = 1 launch from this run's shapes: the
    operand read once and the output written once over HBM_BYTES_PER_S, or
    one add a nonzero over FP32_OPS_PER_S, whichever is longer."""
    item = plan.stream_itemsize
    nbytes = (plan.d_pad * item + plan.k_pad * 4 if op == "fwd"
              else plan.k_pad * item + plan.d_pad * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = plan.nnz_per_col * plan.d_pad / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def train_kernels(rt, plans, free_csrs=False):
    """At each plan of the compressed leaves, at n = 1: the narrow forward
    and transpose (the training path's route) against their plain versions
    (fp32 exactness_atol × max|plain|) and torch.equal to the forced wide
    route (the row-split forward, the staged transpose) under every stage
    count that fits; the adjoint identity in fp64 at the largest plan; side
    by side, the CUDA-event times of the narrow kernels (at their ring and
    at every stage count that fits, at most six), the forced wide route,
    ``torch.sparse.mm`` of S (Sᵀ) in CSR (with ``free_csrs``, after the
    kernels' CSRs are dropped: the library's CSR of a plan past int32 does
    not fit beside them), cost_of's bound and the CSR floor."""
    fsk, ref = rt["fsk"], rt["ref"]
    sm, lowering = rt["sketch_model"], rt["lowering"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    before = dict(fsk.LAUNCHES)
    rows = {}
    def plain_ms(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3
    for plan, leaves in plans:
        A = torch.randn(plan.d_pad, 1, generator=gen, device="cuda")
        Y = torch.randn(plan.k_pad, 1, generator=gen, device="cuda")
        full = dataclasses.replace(plan, d=plan.d_pad)
        work = {"fwd": (fsk.flashsketch_fwd, A,
                        lambda: ref.flashsketch_ref(plan, A)),
                "transpose": (fsk.flashsketch_transpose, Y,
                              lambda: ref.flashsketch_transpose_ref(full,
                                                                    Y))}
        out, err, plain, ms, wide, stage_ms = {}, {}, {}, {}, {}, {}
        for op, (fn, x, ref_fn) in work.items():
            name = f"flashsketch_{op}_narrow"
            count = fsk.LAUNCHES[name]
            out[op] = fn(plan, x)
            check(fsk.LAUNCHES[name] == count + 1,
                  f"n = 1 {op} at {plan.describe()}: not the narrow route")
            want, plain[op] = plain_ms(ref_fn)
            err[op] = _err(out[op], want, plan,
                           f"n = 1 {op} {plan.describe()}")
            del want
            check(torch.equal(out[op], fn(plan, x, route="wide")),
                  f"n = 1 {op} at {plan.describe()}: narrow != wide")
            fit = (fsk.MAX_SMEM_BYTES - 128) // (
                fsk.narrow_stage_bytes(plan, op) + 8)
            stage_ms[op] = {}
            for st in range(1, min(fit, 6) + 1):
                check(torch.equal(out[op], fn(plan, x, route="narrow",
                                              stages=st)),
                      f"n = 1 {op} at {plan.describe()}: stages={st}")
                stage_ms[op][st] = cuda_ms(
                    lambda: fn(plan, x, route="narrow", stages=st))
            ms[op] = cuda_ms(lambda: fn(plan, x))
            wide[op] = cuda_ms(lambda: fn(plan, x, route="wide"))
        cost = {op: sm.cost_of(lowering.lower(plan, lowering.LaunchSpec(
            op=op, n=1, device="cuda"))) for op in work}
        for op in work:
            check(cost[op].bound_us > 0 and abs(
                cost[op].bound_us / 1e3 - n1_bound(plan, op)[0])
                <= 0.01 * n1_bound(plan, op)[0],
                f"{op}: cost_of's bound differs from this run's")
        lib, lib_err, bands = {}, 0.0, {}
        for op, (_, operand, _) in work.items():
            lib[op], got, bands[op] = library_ms(
                rt, plan, operand, op == "transpose", free_csrs)
            if got is not None:
                lib_err = max(lib_err, float((got - out[op]).abs().max()))
            del got
        print(f"  {plan.describe()} ({', '.join(leaves)}): max abs err fwd "
              f"{err['fwd']:.2e}, transpose {err['transpose']:.2e} against "
              f"the plain versions; narrow == wide (torch.equal) at every "
              f"stage count; |library - kernel| {lib_err:.2e}")
        for op in work:
            bound, by = n1_bound(plan, op)
            floor = csr_floor_ms(plan, op)
            threads, stages, _ = fsk.narrow_launch(plan, op)
            library = ("does not fit the card" if lib[op] is None else
                       f"{lib[op]:.4f} ms in {bands[op]} int32 band(s) "
                       f"(narrow / library {ms[op] / lib[op]:.2f})")
            sweep = ", ".join(f"{st}: {t:.4f}"
                              for st, t in stage_ms[op].items())
            print(f"    {op:9s} n = 1: narrow {ms[op]:.4f} ms ({threads} "
                  f"threads, {stages} stage(s); by stages {sweep}), wide "
                  f"(forced) {wide[op]:.4f} ms; bound {bound:.4f} ms ({by}; "
                  f"cost_of), {ms[op] / bound:.1f}x; CSR floor "
                  f"{floor:.4f} ms, {ms[op] / floor:.2f}x; torch.sparse.mm "
                  f"{library}; plain {plain[op]:.1f} ms (one call)")
        rows[plan.d_pad] = dict(
            describe=plan.describe(), ms=ms, wide_ms=wide,
            stage_ms=stage_ms, library_ms=lib, plain_ms=plain, err=err,
            bound_ms={op: n1_bound(plan, op)[0] for op in work},
            bound_by={op: n1_bound(plan, op)[1] for op in work},
            floor_ms={op: csr_floor_ms(plan, op) for op in work})
        del A, Y, out
    big = plans[0][0]
    g = torch.randn(big.d_pad, 1, generator=gen, device="cuda")
    y = fsk.flashsketch_fwd(big, g)
    x = fsk.flashsketch_transpose(big, y)
    lhs = float((y.double() ** 2).sum())
    rhs = float((g.double() * x.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    print(f"  adjoint at {big.describe()}: <S g, S g> {lhs!r}, "
          f"<g, S^T S g> {rhs!r}, relative {rel:.2e} (fp64 sums)")
    check(rel <= 1e-6, f"adjoint identity at the embedding's plan: {rel}")
    for k in before:      # checks and timing are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def narrow_rows(n1, launches):
    """The kernels line's rows of the two narrow kernels, at the largest
    plan of ``n1`` (``train_kernels``' rows: qwen3-0.6b's embedding plan),
    with ``launches`` from the training phases, phase 13's compression
    (both pods' and the supervised runs'), phases 15-16 (b) and phase 17's
    train_lm and sketches of n = 1."""
    row = n1[max(n1)]
    out = []
    for op in ("fwd", "transpose"):
        name = f"flashsketch_{op}_narrow"
        out.append(dict(
            name=name, route="cuda", **KERNEL_INFO[name],
            launches=launches[name], max_abs_err=row["err"][op],
            ms=row["ms"][op], plain_ms=row["plain_ms"][op],
            bound_ms=row["bound_ms"][op], bound_by=row["bound_by"][op],
            library_ms=row["library_ms"][op]))
    return out


def train_chunked_csr(rt, plans):
    """The CSRs of S and the tile-local Sᵀ at the wk plan built in chunks
    of ``_CSR_CHUNK_ENTRIES`` against one chunk's build: torch.equal."""
    fsk = rt["fsk"]
    # the chunked CSR builds against one chunk, at the wk plan (235 M
    # nonzeros, 30 chunks of S's build)
    wk = next(p for p, leaves in plans if "blocks.attn.wk" in leaves)
    dev = torch.device("cuda", torch.cuda.current_device())
    chunked = (fsk._device_csr(wk, dev, False)
               + fsk._device_csr_t(wk, dev, tile_local=True))
    chunk_entries = fsk._CSR_CHUNK_ENTRIES
    fsk._CSR_CHUNK_ENTRIES = 2**31
    try:
        whole = (fsk._device_csr.__wrapped__(wk, dev, False)
                 + fsk._device_csr_t.__wrapped__(wk, dev, True))
    finally:
        fsk._CSR_CHUNK_ENTRIES = chunk_entries
    check(all((a is None and b is None) or (a.dtype == b.dtype
                                            and torch.equal(a, b))
              for a, b in zip(chunked, whole)),
          f"chunked CSRs of {wk.describe()} differ from one chunk's")
    print(f"  the CSRs of S and S^T at {wk.describe()} built in chunks of "
          f"{chunk_entries} entries: torch.equal to one chunk's build")
    del chunked, whole
    torch.cuda.empty_cache()


def train_compress_cpu(rt):
    """``compress_gradients`` on the card held to the CPU (the plain
    versions) at the smoke config, three steps of the roll, each side's
    error state carried: ĝ and the error within fp32's exactness_atol ×
    max|CPU ĝ|."""
    gc, tr, fsk = rt["gc"], rt["tree"], rt["fsk"]
    cfg = rt["smoke_config"](rt["get_arch"](TRAIN_ARCH))
    comp = gc.CompressConfig(ratio=TRAIN_RATIO)
    atol = rt["precision"].POLICIES["float32"].exactness_atol
    before = dict(fsk.LAUNCHES)
    gen = torch.Generator().manual_seed(11)
    shapes = rt["lm"].DecoderLM(cfg).init(seed=0, device="cpu")
    g_cpu = tr.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                        shapes)
    g_gpu = tr.tree_map(lambda t: t.to("cuda"), g_cpu)
    e_cpu, e_gpu = gc.init_error_state(g_cpu), gc.init_error_state(g_gpu)
    worst = 0.0
    for step in range(3):
        h_cpu, e_cpu = gc.compress_gradients(comp, g_cpu, e_cpu, step=step)
        h_gpu, e_gpu = gc.compress_gradients(comp, g_gpu, e_gpu, step=step)
        for (path, a), b, ea, eb in zip(
                tr.leaves_with_path(h_gpu), tr.leaves(h_cpu),
                tr.leaves(e_gpu), tr.leaves(e_cpu)):
            scale = max(float(b.abs().max()), 1e-30)
            err = max(float((a.cpu() - b).abs().max()),
                      float((ea.cpu() - eb).abs().max()))
            worst = max(worst, err / scale)
            check(err <= atol * scale, f"compress step {step} "
                  f"{tr.keystr(path)}: card vs CPU {err} (max|g| {scale})")
    launched = sum(fsk.LAUNCHES[k] - before[k] for k in before)
    for k in before:
        fsk.LAUNCHES[k] = before[k]
    print(f"  compress_gradients at {cfg.name} smoke (ratio "
          f"{TRAIN_RATIO}), steps 0-2 of the roll: card (CUDA kernels, "
          f"{launched} launches) against the CPU (plain versions), within "
          f"{worst:.2e} x max|g_hat| (tolerance {atol})")
    check(launched > 0, "compress_gradients launched no kernel on the card")


def phase_training(rt):
    """qwen3-0.6b trained on the card at full width with sketched gradient
    compression (the module docstring, phase 10).  Returns the launch
    counts of the live run and ``train_kernels``' rows."""
    cfg = rt["get_arch"](TRAIN_ARCH)
    opt = rt["adamw"].AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(5, TRAIN_STEPS // 20),
        total_steps=TRAIN_STEPS, state_dtype=cfg.optstate_dtype)
    data_cfg = rt["pipeline"].DataConfig(
        vocab_size=TRAIN_DATA_VOCAB, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, seed=0)
    comp = rt["gc"].CompressConfig(ratio=TRAIN_RATIO)
    torch.cuda.empty_cache()
    print(f"phase 10: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_dtype} weights, "
          f"{cfg.optstate_dtype} optimizer state), batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, lr {TRAIN_LR}, --grad-compress {TRAIN_RATIO}, "
          f"{TRAIN_STEPS} steps; tokens drawn from the first "
          f"{TRAIN_DATA_VOCAB} ids")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        live, out, clock, launches = train_live(rt, cfg, opt, data_cfg, comp,
                                                ckpt_dir)
        plans = train_plans(rt, out["final_params"], comp)
        n_params = sum(p.numel() for p in rt["tree"].leaves(
            out["final_params"]))
        print(f"  {n_params:,} parameters; {len(plans)} plans of "
              f"{sum(len(v) for _, v in plans)} compressed leaves, each "
              f"sketched (forward) and decompressed (transpose) at n = 1:")
        for plan, leaves in plans:
            print(f"    {plan.describe()}: {', '.join(leaves)}")
        check(sum(len(v) for _, v in plans) == 10,
              "the tree does not compress 10 leaves")
        rest = clock.rows[1:]
        wall, comp_s, opt_s = (statistics.median(r[k] for r in rest)
                               for k in ("wall", "compress", "optimizer"))
        print(f"  step host wall (synchronised), median of steps 1-"
              f"{TRAIN_STEPS - 1}: {wall * 1e3:.1f} ms = forward+backward "
              f"{(wall - comp_s - opt_s) * 1e3:.1f} + compression "
              f"{comp_s * 1e3:.1f} + optimizer {opt_s * 1e3:.1f}; step 0 "
              f"(the CSRs built) {clock.rows[0]['wall'] * 1e3:.1f} ms, of "
              f"which compression {clock.rows[0]['compress'] * 1e3:.1f}; "
              f"fit {out['wall_s']:.1f} s with the checkpoint")
        dev = torch.device("cuda", torch.cuda.current_device())
        fsk = rt["fsk"]
        csr = csr_bytes(rt, plans)
        mem0, mem1 = clock.mem
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  CSR bytes held: {csr:,} ({csr / 2**30:.2f} GiB); "
              f"max_memory_allocated before the first step {mem0:,} "
              f"({mem0 / 2**30:.2f} GiB), after it {mem1:,} "
              f"({mem1 / 2**30:.2f} GiB), over the run "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of "
              f"{total / 2**30:.1f} GiB")
        train_resume(rt, cfg, opt, data_cfg, comp, ckpt_dir, live, out)
        profiled = train_profile(rt, live, out)
        del live, out
    torch.cuda.empty_cache()
    rows = train_kernels(rt, plans)
    train_chunked_csr(rt, plans)
    train_compress_cpu(rt)
    print("training: " + json.dumps(dict(
        step_ms=dict(wall=wall * 1e3, compress=comp_s * 1e3,
                     optimizer=opt_s * 1e3,
                     fwd_bwd=(wall - comp_s - opt_s) * 1e3),
        first_step_ms=clock.rows[0]["wall"] * 1e3, profiled=profiled,
        csr_bytes=csr,
        max_memory_allocated=[mem0, mem1], n1=rows)))
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 11: the moe, ssm, hybrid, encdec and vlm families at full width.
# ---------------------------------------------------------------------------

# (config, its depth cut, compressed, steps): every width of the config
# file kept, the depth cut to the least that shows the family's structure
# (one moe layer; one RWKV6 layer; one zamba2 super-block of six Mamba2
# layers and the shared block; one encoder and one decoder layer; one vlm
# group of four self layers and the cross layer).  The vlm trains
# uncompressed: its eight plans' CSRs (about 46 GB) and its state (34 GB)
# pass the card's 80 GB together.  Batch, seq, lr and ratio are phase 10's.
FAMILY_CUTS = (
    ("qwen3-moe-30b-a3b", dict(n_layers=1), True, 6),
    ("rwkv6-7b", dict(n_layers=1), True, 3),
    ("zamba2-7b", dict(n_layers=6), True, 3),
    ("seamless-m4t-large-v2", dict(n_layers=1, encoder_layers=1), True, 3),
    ("llama-3.2-vision-11b", dict(n_layers=5), False, 2),
)


def family_config(rt, name, cut):
    cfg = dataclasses.replace(rt["get_arch"](name), **cut)
    full = rt["get_arch"](name)
    print(f"  {name} ({cfg.family}): every width of its config file "
          f"(d_model {cfg.d_model}, {cfg.n_heads} heads, kv "
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}); "
          f"depth cut: " + ", ".join(f"{k} {getattr(full, k)} -> {v}"
                                     for k, v in cut.items()))
    return cfg


def family_opt(rt, cfg, steps):
    return rt["adamw"].AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(5, steps // 20), total_steps=steps,
        state_dtype=cfg.optstate_dtype)


def family_report(rt, name, clock, losses, launches, plans, comp):
    """Print one family's launches, losses, step split, peak memory and
    CSR bytes, and check them: every loss finite; where compressed, one
    forward and one transpose launch a compressed leaf and step, nothing
    else launched.  Returns its summary."""
    steps = len(losses)
    shown = {k: v for k, v in launches.items() if v}
    n_leaves = sum(len(v) for _, v in plans)
    print(f"    launches over {steps} steps: {shown}; losses "
          f"{[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses), f"{name}: a loss is not "
          f"finite: {losses}")
    if comp is not None:
        check(n_leaves > 0, f"{name}: no leaf compressed")
        for kname in NARROW_KERNELS:
            check(launches[kname] == n_leaves * steps,
                  f"{name}: {kname} {launches[kname]} launches, not "
                  f"{n_leaves} a step")
    check(sum(launches.values()) == 2 * n_leaves * steps,
          f"{name}: launches other than the narrow forward and transpose: "
          f"{shown}")
    rest = clock.rows[1:] or clock.rows
    wall, comp_s, opt_s = (statistics.median(r.get(k, 0.0) for r in rest)
                           for k in ("wall", "compress", "optimizer"))
    csr = csr_bytes(rt, plans)
    peak = torch.cuda.max_memory_allocated()
    print(f"    step host wall (synchronised), median of steps 1-"
          f"{steps - 1}: {wall * 1e3:.1f} ms = forward+backward "
          f"{(wall - comp_s - opt_s) * 1e3:.1f} + compression "
          f"{comp_s * 1e3:.1f} + optimizer {opt_s * 1e3:.1f}; step 0 "
          f"{clock.rows[0]['wall'] * 1e3:.1f} ms (compression "
          f"{clock.rows[0].get('compress', 0.0) * 1e3:.1f}"
          f"{', the CSRs built' if plans else ''}); {len(plans)} plans of "
          f"{n_leaves} compressed leaves, "
          f"CSRs {csr:,} bytes ({csr / 2**30:.2f} GiB); "
          f"max_memory_allocated {peak:,} ({peak / 2**30:.2f} GiB)")
    for plan, leaves in plans:
        print(f"      {plan.describe()}: {', '.join(leaves)}")
    return dict(steps=steps, losses=losses, launches=shown,
                step_ms=dict(wall=wall * 1e3, compress=comp_s * 1e3,
                             optimizer=opt_s * 1e3,
                             fwd_bwd=(wall - comp_s - opt_s) * 1e3),
                first_step_ms=clock.rows[0]["wall"] * 1e3,
                leaves=n_leaves, plans=len(plans), csr_bytes=csr,
                max_memory_allocated=peak)


def family_trainer(rt, name, cfg, comp, steps):
    """The main config of the phase through ``Trainer.fit``, as phase 10
    runs qwen3-0.6b: ``steps`` steps with the checkpoint at the last; the
    live run's loss at the next step; then, the live trainer freed, the
    checkpoint restored into a fresh Trainer whose first loss must be
    torch.equal to the live one.  Returns (summary, launches, plans)."""
    fsk, tmod = rt["fsk"], rt["trainer"]
    opt = family_opt(rt, cfg, steps)
    data_cfg = rt["pipeline"].DataConfig(
        vocab_size=TRAIN_DATA_VOCAB, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        tcfg = tmod.TrainerConfig(total_steps=steps, ckpt_every=steps,
                                  ckpt_dir=ckpt_dir, log_every=steps)
        live = tmod.Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                            log_fn=lambda line: None, device="cuda")
        clock = StepClock(live, rt["train_step"])
        calls = {}
        restore_plain = spy_plain(rt, calls)
        torch.cuda.reset_peak_memory_stats()
        fsk.reset_launch_counts()
        try:
            out = live.fit()
            torch.cuda.synchronize()
        finally:
            restore_plain()
            clock.close()
        launches = dict(fsk.LAUNCHES)
        check(not calls, f"{name}: a plain version ran: {calls}")
        plans = train_plans(rt, out["final_params"], comp)
        summary = family_report(rt, name, clock, out["losses"], launches,
                                plans, comp)
        _, _, _, m = live.step_fn(out["final_params"], out["final_opt"],
                                  out["final_err"], live.batch(steps))
        live_loss = m["loss"].detach().clone()
        t = time.perf_counter()
        del live, out, m, clock
        pygc.collect()
        torch.cuda.empty_cache()
        freed = torch.cuda.memory_allocated()
        fresh = tmod.Trainer(cfg, opt, dataclasses.replace(
            tcfg, total_steps=steps + 1), data_cfg, compress=comp,
            log_fn=lambda line: None, device="cuda")
        params, opt_state, err, start = fresh.maybe_restore(
            *fresh.init_state())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check(start == steps, f"{name}: resumed at step {start}")
        _, _, _, m = fresh.step_fn(params, opt_state, err,
                                   fresh.batch(steps))
        resumed = m["loss"].detach()
        print(f"    the live trainer freed ({freed:,} bytes still "
              f"allocated, the CSRs among them); the checkpoint of step "
              f"{steps} restored into a fresh Trainer in {restore_s:.1f} s; "
              f"resumed loss {float(resumed)!r}, live loss "
              f"{float(live_loss)!r}")
        check(torch.equal(resumed, live_loss),
              f"{name}: the resumed loss is not the live one")
        del fresh, params, opt_state, err, m
    for k in launches:    # the resumed and live extra steps are checks
        fsk.LAUNCHES[k] = launches[k]
    summary.update(restore_s=restore_s, resumed_loss=float(resumed))
    return summary, launches, plans


def family_steps(rt, name, cfg, comp, steps):
    """``steps`` steps of ``build_train_step`` on ``make_train_batch``
    batches (tokens, labels and the family's modality stub; the reference's
    Trainer feeds tokens and labels only).  Returns (summary, launches,
    plans)."""
    fsk, factory = rt["fsk"], rt["factory"]
    step_fn, model = rt["train_step"].build_train_step(
        cfg, family_opt(rt, cfg, steps), comp)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device="cuda")
    opt_state = rt["adamw"].init_state(params, family_opt(rt, cfg, steps))
    err = rt["gc"].init_error_state(params) if comp else {}
    holder = types.SimpleNamespace(step_fn=step_fn)
    clock = StepClock(holder, rt["train_step"])
    calls = {}
    restore_plain = spy_plain(rt, calls)
    fsk.reset_launch_counts()
    losses = []
    try:
        for step in range(steps):
            batch = factory.make_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                             seed=step, device="cuda")
            params, opt_state, err, m = holder.step_fn(params, opt_state,
                                                       err, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    finally:
        restore_plain()
        clock.close()
    launches = dict(fsk.LAUNCHES)
    check(not calls, f"{name}: a plain version ran: {calls}")
    plans = train_plans(rt, params, comp) if comp else []
    summary = family_report(rt, name, clock, losses, launches, plans, comp)
    return summary, launches, plans


def phase_families_train(rt):
    """The moe, ssm, hybrid, encdec and vlm families trained on the card
    at full width (the module docstring, phase 11).  Returns the launch
    counts of the phase's training runs."""
    comp = rt["gc"].CompressConfig(ratio=TRAIN_RATIO)
    total = {k: 0 for k in rt["fsk"].LAUNCHES}
    summaries, embed = {}, None
    pygc.collect()
    clear_csr_caches(rt)              # the earlier phases' plans
    print(f"phase 11: five families at full width, batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, lr {TRAIN_LR}, --grad-compress {TRAIN_RATIO} "
          f"(the vlm uncompressed); {torch.cuda.memory_allocated():,} "
          f"bytes allocated before it")
    for name, cut, compressed, steps in FAMILY_CUTS:
        t = time.perf_counter()
        cfg = family_config(rt, name, cut)
        run = family_trainer if name == FAMILY_CUTS[0][0] else family_steps
        summary, launches, plans = run(rt, name, cfg,
                                       comp if compressed else None, steps)
        for k, v in launches.items():
            total[k] += v
        if name == FAMILY_CUTS[0][0]:
            check(summary["leaves"] == 10 and summary["plans"] == 5,
                  f"{name}: {summary['leaves']} leaves in "
                  f"{summary['plans']} plans, not 10 in 5")
            embed = next((p, v) for p, v in plans if "embed" in v)
            check(embed[0].kappa * embed[0].s * embed[0].d_pad > 2**31 - 1,
                  f"the embedding's plan {embed[0].describe()} is not past "
                  f"int32")
        del plans
        pygc.collect()
        clear_csr_caches(rt)
        summary["wall_s"] = time.perf_counter() - t
        summaries[name] = summary
        print(f"    [{name}: {summary['wall_s']:.1f} s]")
    plan, leaves = embed
    print(f"  the n = 1 kernels at the embedding's plan of {FAMILY_CUTS[0][0]}"
          f" ({plan.kappa * plan.s * plan.d_pad:,} nonzeros, past int32; "
          f"the trainers freed):")
    rows = train_kernels(rt, [embed], free_csrs=True)
    clear_csr_caches(rt)
    print("families: " + json.dumps(dict(families=summaries, n1=rows)))
    return total


# ---------------------------------------------------------------------------
# Phase 12: decode and generation.
# ---------------------------------------------------------------------------

# launch/generate.py's defaults: batch 4, a prompt of 16, 32 new tokens,
# greedy; then decode == prefill (teacher-forced, fp32) at B = 2, S = 8,
# and the card against the CPU for DECODE_CPU_STEPS steps.
GEN_ARCH, GEN_BATCH, GEN_PROMPT, GEN_NEW = "qwen3-0.6b", 4, 16, 32
DECODE_B, DECODE_S, DECODE_CPU_STEPS, DECODE_TIMED_STEPS = 2, 8, 4, 24
# qwen3-0.6b at full depth, then each family at phase 11's depth cut
DECODE_CUTS = ((GEN_ARCH, {}),) + tuple(
    (name, cut) for name, cut, _, _ in FAMILY_CUTS)
# families whose decode == prefill misses the tolerance on the CPU too
# (``decode_prefill_check(rt, "cpu")``: zamba2's prefill rounds the SSD
# operands to bf16 by the reference's design, its decode does not): their
# (b) is recorded and they are gated by (c), the card against the CPU
DECODE_VIA_CPU = ("zamba2-7b",)


def decode_tolerance(cfg):
    """(atol, rtol) of decode against prefill: the reference test's
    (``tests/test_models_smoke.py``), atol 5e-2 for rwkv6."""
    return (5e-2 if cfg.ssm_kind == "rwkv6" else 2e-3), 1e-2


def _state_bytes(state):
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    if isinstance(state, tuple):
        return sum(_state_bytes(v) for v in state)
    return state.numel() * state.element_size()


def _fp32(rt, name, cut):
    return dataclasses.replace(rt["get_arch"](name), param_dtype="float32",
                               **cut)


def decode_inputs(rt, cfg, device, seed=1):
    """Tokens (B, S) int32 and the family's modality stub, from a
    ``torch.Generator(seed)`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_S),
                        generator=gen, device=device, dtype=torch.int32)
    return tok, rt["factory"].extra_inputs_concrete(cfg, DECODE_B, DECODE_S,
                                                    gen)


def decode_errors(model, tok, extra):
    """Teacher-forced decode of every token against ``apply`` over the
    same tokens: (decode logits (B, S, V), prefill logits), both over the
    vocabulary, f32."""
    V = model.cfg.vocab_size
    with torch.inference_mode():
        full, _ = model.apply(model.params, tok, extra)
        state = model.init_decode_state(model.params, tok.shape[0],
                                        tok.shape[1], extra)
        dec = [model.decode_step(model.params, state, tok[:, t:t + 1], t)[0]
               for t in range(tok.shape[1])]
    return torch.cat(dec, dim=1)[..., :V], full[..., :V]


def decode_prefill_check(rt, device="cuda"):
    """Decode == prefill in fp32 at full width (the module docstring,
    phase 12 (b)) on ``device``: each config's worst |decode − prefill|
    beside its tolerance.  Returns {name: summary}."""
    out = {}
    for name, cut in DECODE_CUTS:
        t = time.perf_counter()
        cfg = _fp32(rt, name, cut)
        model = rt["factory"].build_model(cfg)
        model.init(seed=0, device=device)
        tok, extra = decode_inputs(rt, cfg, device)
        dec, full = decode_errors(model, tok, extra)
        atol, rtol = decode_tolerance(cfg)
        err = (dec - full).abs()
        excess = float((err - (atol + rtol * full.abs())).max())
        finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
        del model, dec, full, extra
        pygc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        out[name] = dict(layers=cfg.n_layers, max_abs_err=float(err.max()),
                         atol=atol, rtol=rtol, excess=excess, finite=finite,
                         ok=finite and excess <= 0.0,
                         s=time.perf_counter() - t)
        depth = (f"{cfg.encoder_layers} + {cfg.n_layers}"
                 if cfg.encoder_layers else str(cfg.n_layers))
        print(f"    {name} ({cfg.family}, depth {depth}, fp32) on {device}: "
              f"max |decode - prefill| "
              f"{out[name]['max_abs_err']:.3e}, worst excess over atol "
              f"{atol:g} + rtol {rtol:g}·|prefill| {excess:.3e} "
              f"({'within' if out[name]['ok'] else 'OUTSIDE'}; "
              f"{out[name]['s']:.1f} s)")
    return out


def decode_profile(model, params, state, cur, pos):
    """One warm decode step under ``torch.profiler``: host wall, device
    busy, idle share, device operations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):     # a throwaway
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.decode_step(params, state, cur, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    host_ops = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU]
    print(f"  one profiled decode step (pos {pos}): host wall "
          f"{wall * 1e3:.2f} ms, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / (wall * 1e3):.3f}); {launches} device operations "
          f"of {len(kernels)} names; largest:")
    for key, ms, count in sorted(kernels, key=lambda r: -r[1])[:6]:
        print(f"    {ms:8.3f} ms  {count:5d}x  {key[:90]}")
    print(f"  its host side: {sum(c for _, _, c in host_ops)} profiled "
          f"operator calls; largest self time:")
    for key, ms, count in sorted(host_ops, key=lambda r: -r[1])[:6]:
        print(f"    {ms:8.3f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3), launches=launches,
                host_ops=sum(c for _, _, c in host_ops))


def decode_generate(rt):
    """(a): qwen3-0.6b at full width and depth, bf16, generating through
    ``launch/generate.py``'s ``generate`` twice (greedy); the tokens of the
    two runs equal, every logit finite; tok/s, the warm ms a step, KV
    bytes, peak memory, one profiled step."""
    cfg = rt["get_arch"](GEN_ARCH)
    gen_mod = rt["generate"]
    torch.cuda.reset_peak_memory_stats()
    model = rt["factory"].build_model(cfg)
    params = model.init(seed=0, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                            generator=g, device="cuda", dtype=torch.int32)
    print(f"  (a) {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, kv {cfg.n_kv_heads}, "
          f"head_dim {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}), batch {GEN_BATCH}, prompt {GEN_PROMPT} "
          f"teacher-forced + {GEN_NEW} greedy tokens, twice")
    toks1, tps1 = gen_mod.generate(model, params, prompts, GEN_NEW, {})
    finite = []
    step = model.decode_step

    def checked(*args):
        logits, state = step(*args)
        finite.append(torch.isfinite(logits).all())
        return logits, state
    model.decode_step = checked
    try:
        toks2, tps2 = gen_mod.generate(model, params, prompts, GEN_NEW, {})
    finally:
        del model.decode_step
    n_steps = GEN_PROMPT + GEN_NEW - 1
    check(toks1.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW),
          f"generate gave {tuple(toks1.shape)}")
    check(torch.equal(toks1, toks2), "two greedy runs gave other tokens")
    check(len(finite) == n_steps and bool(torch.stack(finite).all()),
          "a decode logit is not finite")
    check(torch.equal(toks1[:, :GEN_PROMPT], prompts),
          "the prompt is not the tokens' start")
    # warm steps, each between two synchronisations, on a fresh state
    state = model.init_decode_state(params, GEN_BATCH, GEN_PROMPT + GEN_NEW)
    kv_bytes = _state_bytes(state)
    times = []
    with torch.inference_mode():
        for pos in range(DECODE_TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.decode_step(params, state, toks1[:, pos:pos + 1], pos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = decode_profile(model, params, state,
                              toks1[:, DECODE_TIMED_STEPS:
                                    DECODE_TIMED_STEPS + 1],
                              DECODE_TIMED_STEPS)
    step_ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in rt["tree"].leaves(params))
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in rt["tree"].leaves(params))
    print(f"  (a) tokens equal across the two runs; {n_steps} steps a run, "
          f"every logit finite; {tps1:.1f} and {tps2:.1f} tok/s (B·gen over "
          f"the loop's wall, synchronised); warm step median "
          f"{step_ms:.2f} ms (min {min(times[1:]) * 1e3:.2f}, max "
          f"{max(times[1:]) * 1e3:.2f}; steps 1-{DECODE_TIMED_STEPS - 1}); "
          f"{n_params:,} parameters, {weight_bytes:,} weight bytes (bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms a step at 3.35 "
          f"TB/s); KV {kv_bytes:,} bytes; max_memory_allocated {peak:,} "
          f"({peak / 2**30:.2f} GiB)")
    print(f"  (a) sample: {toks1[0, :GEN_PROMPT + 8].tolist()}")
    summary = dict(tok_s=[tps1, tps2], step_ms=step_ms,
                   step_ms_range=[min(times[1:]) * 1e3,
                                  max(times[1:]) * 1e3],
                   kv_bytes=kv_bytes, peak_bytes=peak,
                   weight_bytes=weight_bytes,
                   bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
                   profiled=prof)
    del model, params, state
    return summary


def decode_card_vs_cpu(rt, name, cut):
    """(c): one config's fp32 decode on the card and the same code and
    weights on the CPU, DECODE_CPU_STEPS teacher-forced steps."""
    cfg = _fp32(rt, name, cut)
    tree, layers = rt["tree"], rt["lm"].layers
    card = rt["factory"].build_model(cfg)
    card.init(seed=0, device="cuda")
    cpu = rt["factory"].build_model(cfg)
    cpu.params = layers.parameter_dict(tree.tree_map(
        lambda p: p.detach().cpu(), card.params))
    tok, extra = decode_inputs(rt, cfg, "cuda")
    with torch.inference_mode():
        sc = card.init_decode_state(card.params, DECODE_B, DECODE_S, extra)
        sh = cpu.init_decode_state(cpu.params, DECODE_B, DECODE_S,
                                   {k: v.cpu() for k, v in extra.items()})
        got, want = [], []
        for t in range(DECODE_CPU_STEPS):
            got.append(card.decode_step(card.params, sc, tok[:, t:t + 1],
                                        t)[0].cpu())
            want.append(cpu.decode_step(cpu.params, sh,
                                        tok[:, t:t + 1].cpu(), t)[0])
    V = cfg.vocab_size
    got, want = (torch.cat(x, 1)[..., :V] for x in (got, want))
    atol, rtol = decode_tolerance(cfg)
    err = (got - want).abs()
    excess = float((err - (atol + rtol * want.abs())).max())
    print(f"  (c) {cfg.name} fp32, depth {cfg.n_layers}, "
          f"{DECODE_CPU_STEPS} teacher-forced steps: card against the CPU "
          f"(torch {torch.get_num_threads()} threads), max |diff| "
          f"{float(err.max()):.3e}, worst excess over atol {atol:g} + rtol "
          f"{rtol:g}·|cpu| {excess:.3e}")
    check(excess <= 0.0, f"{name}: the card's decode is outside tolerance "
          f"of the CPU's")
    del card, cpu, sc, sh
    return dict(max_abs_err=float(err.max()), excess=excess)


def phase_decode(rt):
    """Decode and generation on the card (the module docstring, phase
    12): no sketch launch and no plain-version call over the phase."""
    fsk = rt["fsk"]
    pygc.collect()
    clear_csr_caches(rt)              # the earlier phases' plans
    before = dict(fsk.LAUNCHES)
    calls = {}
    restore_plain = spy_plain(rt, calls)
    print(f"phase 12: decode and generation; "
          f"{torch.cuda.memory_allocated():,} bytes allocated before it")
    try:
        gen = decode_generate(rt)
        pygc.collect()
        torch.cuda.empty_cache()
        print("  (b) decode == prefill, fp32 (TF32 off), B = "
              f"{DECODE_B}, S = {DECODE_S}, teacher-forced, at full width:")
        parity = decode_prefill_check(rt, "cuda")
        card_cpu = {name: decode_card_vs_cpu(rt, name, cut)
                    for name, cut in DECODE_CUTS
                    if name == GEN_ARCH or name in DECODE_VIA_CPU}
    finally:
        restore_plain()
    for name, row in parity.items():
        if name in DECODE_VIA_CPU:
            print(f"  (b) {name}: recorded, not gated (it misses on the CPU "
                  f"too); gated by (c)")
            continue
        check(row["ok"], f"{name}: decode is outside tolerance of prefill "
              f"(excess {row['excess']:.3e})")
    launched = {k: v - before[k] for k, v in fsk.LAUNCHES.items()
                if v != before[k]}
    print(f"  sketch launches over phase 12: {launched or 'none'}; plain "
          f"versions called: {calls or 'none'}")
    check(not launched, f"phase 12 launched sketch kernels: {launched}")
    check(not calls, f"phase 12 called plain versions: {calls}")
    pygc.collect()
    torch.cuda.empty_cache()
    print("decode: " + json.dumps(dict(generate=gen, parity=parity,
                                       card_vs_cpu=card_cpu)))


# ---------------------------------------------------------------------------
# Phase 13: the sharding specs, the pod-axis mean of compressed gradients on
# ranks sharing the card, and the supervisor around the Trainer.
# ---------------------------------------------------------------------------

# (a): two pods on the card, each with half of phase 10's batch at step 1
# (the roll is on); (b): qwen3-0.6b at full width cut to 2 layers, 6 steps
# in segments of up to 4 with a checkpoint every 2 steps (the first
# segment's first save is in flight while it trains on), the second
# segment failing after its first step.
POD_RANKS, POD_STEP = 2, 1
SUPERVISED_LAYERS, SUPERVISED_STEPS = 2, 6
SUPERVISED_SEGMENT, SUPERVISED_CKPT_EVERY = 4, 2


def spec_device_bytes(rt, shapes, specs, mesh):
    """(leaves, bytes a device holds) of a tree of fake tensors under its
    specs on ``mesh``: each sharded dimension divided by the product of
    its axes' sizes, rounded up."""
    tree, pt = rt["tree"], rt["partition"]
    flat_shapes, flat_specs = [], []
    tree.map_structure(flat_shapes.append, shapes)
    tree.map_structure(flat_specs.append, specs,
                       is_leaf=lambda s: isinstance(s, pt.PartitionSpec))
    check(len(flat_shapes) == len(flat_specs), "specs and shapes differ")
    total = 0
    for t, spec in zip(flat_shapes, flat_specs):
        n = t.element_size()
        for d, size in enumerate(t.shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= -(-size // math.prod(mesh.shape[a] for a in axes))
        total += n
    return len(flat_shapes), total


def pod_specs(rt):
    """(c): ``train_state_specs`` (compressed) and ``decode_state_specs``
    (each decode cell of the arch) of every architecture on both
    production meshes, in fake mode, the card's memory unchanged."""
    ts, gc, base = rt["train_step"], rt["gc"], rt["config_base"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = {}
    for multi in (False, True):
        mesh = rt["mesh"].make_production_mesh(multi_pod=multi)
        for name, cfg in rt["archs"].items():
            model = rt["factory"].build_model(cfg)
            (_, params, pspecs, opt, ospecs, err,
             especs) = ts.train_state_specs(cfg, mesh, model,
                                            gc.CompressConfig())
            row = {"train": spec_device_bytes(
                rt, {"p": params, "o": opt, "e": err},
                {"p": pspecs, "o": ospecs, "e": especs}, mesh)}
            for shape in base.SHAPES:
                if shape.is_decode and base.shape_applicable(cfg, shape)[0]:
                    out = ts.decode_state_specs(cfg, mesh, model, shape)
                    row[shape.name] = spec_device_bytes(rt, out[3], out[4],
                                                        mesh)
            check(model.params is None, f"{name}: abstract init kept params")
            rows[f"{rt['mesh'].describe(mesh)} {name}"] = row
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    print(f"  (c) the train and decode state specs of {len(rt['archs'])} "
          f"archs on both production meshes, in fake mode, "
          f"{time.perf_counter() - t:.1f} s; card memory {before:,} -> "
          f"{after:,} bytes, peak {peak:,}; leaves and GiB a device holds "
          f"(train: parameters, AdamW state, error state; a decode cell: its "
          f"state):")
    for key, row in rows.items():
        print(f"    {key}: " + "; ".join(
            f"{k} {n} leaves {b / 2**30:.3f} GiB"
            for k, (n, b) in row.items()))
    check(after == before and peak == before,
          f"(c) allocated on the card: {before} -> {after}, peak {peak}")
    return rows


def phase13_rank(rank, world, cfg):
    """One pod of (a): qwen3-0.6b's gradient of this rank's half of phase
    10's batch, compressed with the mean over the pod axis of a (world,)
    mesh; then ĝ and the error state against the mean composed here from
    the same wrappers, every all-reduce's bytes and ms, the narrow kernels'
    ms at each leaf's plan.  Returns what the parent checks and prints."""
    import torch.distributed as dist
    from repro_torch import tree as tr
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import flashsketch as fsk
    from repro_torch.kernels import lowering, ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.factory import build_model
    from repro_torch.optim import grad_compress as gc
    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.time() - cfg["t_spawn"]
    torch.cuda.reset_peak_memory_stats()
    model = build_model(get_arch(TRAIN_ARCH))
    params = model.init(0, "cuda")
    data_cfg = dp.DataConfig(vocab_size=TRAIN_DATA_VOCAB,
                             global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in dp.make_batch(
        data_cfg, POD_STEP, host_id=rank, n_hosts=world).items()}
    loss, _ = model.loss(params, batch)
    loss.backward()
    grads = tr.tree_map(lambda p: p.grad, params)
    comp = gc.CompressConfig(ratio=TRAIN_RATIO)
    err = gc.init_error_state(params)
    sent = []
    all_reduce = dist.all_reduce

    def timed_all_reduce(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(t, *args, **kwargs)
        torch.cuda.synchronize()
        sent.append((t.numel() * t.element_size(),
                     (time.perf_counter() - t0) * 1e3))
        return out

    plain = {}
    restore_plain = spy_plain({"ref": ref, "lowering": lowering}, plain)
    dist.all_reduce = timed_all_reduce
    fsk.reset_launch_counts()
    t = time.perf_counter()
    try:
        with mesh_lib.make_mesh((world,), ("pod",)):
            g_hat, new_err = gc.compress_gradients(
                comp, grads, err, pod_axis="pod", step=POD_STEP)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
        restore_plain()
    out = dict(start=start, loss=float(loss.detach()),
               compress_s=time.perf_counter() - t,
               launches=dict(fsk.LAUNCHES), plain=plain,
               wire=gc.wire_bytes(comp, params)["sketched_bytes"],
               leaves=[], equal={}, g_hat_err=0.0, error_err=0.0,
               peak=torch.cuda.max_memory_allocated())

    def gathered_mean(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return sum(parts[1:], parts[0]) / world

    for (path, g), gh, ne, (nbytes, ms) in zip(
            tr.leaves_with_path(grads), tr.leaves(g_hat),
            tr.leaves(new_err), sent):
        key = ".".join(path)
        plan = gc.plan_for_leaf(comp, g.numel())
        out["equal"][f"g_hat {key} across ranks"] = _all_equal(gh)
        row = dict(leaf=key, bytes=nbytes, ms=ms)
        out["leaves"].append(row)
        if plan is None:            # dense: the f32 mean, the error kept
            want = gathered_mean(g.to(torch.float32)).to(g.dtype)
            out["equal"][f"dense {key} == the mean"] = torch.equal(gh, want)
            out["equal"][f"error {key} unchanged"] = torch.equal(
                ne, tr.get(err, path))
            continue
        g_eff = g.to(torch.float32).reshape(-1)     # the error state is 0
        shift = gc.roll_shift(POD_STEP, g.numel())
        g_in = torch.roll(g_eff, shift)
        y_mean = gathered_mean(ops.sketch_apply(plan, g_in[:, None],
                                                comp.impl))
        x = torch.roll(comp.gamma(plan) * ops.sketch_apply_t(
            plan, y_mean, comp.impl)[:, 0], -shift)
        out["g_hat_err"] = max(out["g_hat_err"], float(
            (gh.reshape(-1).float() - x.to(g.dtype).float()).abs().max())
            / max(float(x.abs().max()), 1e-30))
        e_want = g_eff - x
        out["error_err"] = max(out["error_err"], float(
            (ne.reshape(-1) - e_want).abs().max())
            / max(float(e_want.abs().max()), 1e-30))
        # the wrappers as ops calls them, on operands padded to the plan,
        # one rank at a time (the card is shared)
        a_pad = torch.nn.functional.pad(g_in, (0, plan.d_pad - g.numel()))
        y_pad = torch.nn.functional.pad(y_mean[:, 0],
                                        (0, plan.k_pad - plan.k))
        row.update(k=plan.k, d=g.numel())
        for r in range(world):
            if r == rank:
                row.update(fwd_ms=cuda_ms(
                    lambda: fsk.flashsketch_fwd(plan, a_pad[:, None])),
                    transpose_ms=cuda_ms(lambda: fsk.flashsketch_transpose(
                        plan, y_pad[:, None])))
            dist.barrier()
        del a_pad, y_pad
    torch.cuda.synchronize()
    out["t_end"] = time.time()
    return out


def pod_mean(rt):
    """(a): qwen3-0.6b at full width, two pods sharing the card; every
    check of the module docstring's phase 13 (a).  Returns the narrow
    kernels' launches of both ranks' compression."""
    atol = rt["precision"].POLICIES["float32"].exactness_atol
    cfg = {"t_spawn": time.time()}
    t = time.perf_counter()
    ranks = rt["run_ranks"](phase13_rank, POD_RANKS, cfg,
                            timeout=SPAWN_TIMEOUT_S)
    print(f"  (a) {POD_RANKS} ranks in {time.perf_counter() - t:.1f} s: "
          f"each started its work {min(o['start'] for o in ranks):.1f}-"
          f"{max(o['start'] for o in ranks):.1f} s after the call; losses "
          f"of the halves {[round(o['loss'], 4) for o in ranks]}; "
          f"compress_gradients (the CSRs built) "
          f"{[round(o['compress_s'], 2) for o in ranks]} s; peak memory "
          f"{[round(o['peak'] / 2**30, 2) for o in ranks]} GiB")
    n_comp = sum("k" in row for row in ranks[0]["leaves"])
    for r, o in enumerate(ranks):
        for what, ok in o["equal"].items():
            check(ok, f"(a) rank {r}: {what}")
        shown = {k: v for k, v in o["launches"].items() if v}
        check(all(o["launches"][k] == n_comp for k in NARROW_KERNELS)
              and sum(o["launches"].values()) == 2 * n_comp,
              f"(a) rank {r}: launches {shown}, not one narrow forward and "
              f"one narrow transpose a compressed leaf ({n_comp})")
        check(not o["plain"], f"(a) rank {r}: plain versions {o['plain']}")
        sent = sum(row["bytes"] for row in o["leaves"])
        check(sent == o["wire"], f"(a) rank {r}: all-reduced {sent} bytes, "
              f"wire_bytes says {o['wire']}")
        check(o["g_hat_err"] <= atol and o["error_err"] <= atol,
              f"(a) rank {r}: g_hat {o['g_hat_err']:.3e}, error state "
              f"{o['error_err']:.3e} from the composed mean")
    print(f"  (a) g_hat torch.equal across the ranks at all "
          f"{len(ranks[0]['leaves'])} leaves, the dense ones the f32 mean; "
          f"each rank's error state its own g' - g_hat; one narrow forward "
          f"and one narrow transpose a compressed leaf ({n_comp}) a rank, "
          f"no plain version; all-reduced {ranks[0]['wire']:,.0f} bytes a "
          f"rank = wire_bytes; against gamma S^T((S g'_0 + S g'_1)/2) "
          f"composed from the same wrappers: g_hat within "
          f"{max(o['g_hat_err'] for o in ranks):.2e}, error state "
          f"{max(o['error_err'] for o in ranks):.2e} x max| | (tolerance "
          f"{atol})")
    print("  (a) by leaf: the all-reduce's bytes and ms on ranks 0 / 1 "
          "(gloo, host-staged), the narrow forward and transpose ms (CUDA "
          "events, one rank at a time) at its plan:")
    for row0, row1 in zip(ranks[0]["leaves"], ranks[1]["leaves"]):
        kern = (f"; d {row0['d']:,} -> k {row0['k']:,}: forward "
                f"{row0['fwd_ms']:.4f} / {row1['fwd_ms']:.4f}, transpose "
                f"{row0['transpose_ms']:.4f} / {row1['transpose_ms']:.4f}"
                if "k" in row0 else " (dense)")
        print(f"    {row0['leaf']}: {row0['bytes']:,} B, {row0['ms']:.3f} / "
              f"{row1['ms']:.3f} ms{kern}")
    return ranks


def supervised_trainer(rt, total, ckpt_dir):
    """A Trainer of qwen3-0.6b at full width cut to SUPERVISED_LAYERS
    layers, phase 10's batch, lr and ratio, a checkpoint every
    SUPERVISED_CKPT_EVERY steps in ``ckpt_dir``, running to ``total``."""
    cfg = dataclasses.replace(rt["get_arch"](TRAIN_ARCH),
                              n_layers=SUPERVISED_LAYERS)
    opt = rt["adamw"].AdamWConfig(
        lr=TRAIN_LR, warmup_steps=5, total_steps=SUPERVISED_STEPS,
        state_dtype=cfg.optstate_dtype)
    data_cfg = rt["pipeline"].DataConfig(
        vocab_size=TRAIN_DATA_VOCAB, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, seed=0)
    tcfg = rt["trainer"].TrainerConfig(
        total_steps=total, ckpt_every=SUPERVISED_CKPT_EVERY,
        ckpt_dir=ckpt_dir, log_every=1000)
    return rt["trainer"].Trainer(
        cfg, opt, tcfg, data_cfg,
        compress=rt["gc"].CompressConfig(ratio=TRAIN_RATIO),
        log_fn=lambda s: None, device="cuda")


def pod_supervised(rt):
    """(b): TrainSupervisor around the Trainer on the card, a failure in
    the middle of its second segment, against one uninterrupted run.
    Returns the narrow kernels' launches of both runs."""
    ft, ckpt, fsk = rt["fault_tolerance"], rt["checkpoint"], rt["fsk"]
    live, losses, last = [], {}, {}
    times = {"restore": [], "wait": [], "fit": []}
    before = dict(fsk.LAUNCHES)
    plain = {}
    restore_plain = spy_plain(rt, plain)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as d:
        def restore_latest():
            t = time.perf_counter()
            for trainer in live:          # a save in flight finishes first
                trainer.async_ckpt.wait()
            times["wait"].append(time.perf_counter() - t)
            return ckpt.latest_step(d) or 0

        def run_segment(plan, start):
            end = min(start + SUPERVISED_SEGMENT, SUPERVISED_STEPS)
            trainer = supervised_trainer(rt, end, d)
            live.append(trainer)
            if len(live) == 2:            # node loss after one step
                step_fn, done = trainer.step_fn, []

                def failing(*args):
                    if done:
                        raise RuntimeError("simulated node loss")
                    done.append(1)
                    return step_fn(*args)
                trainer.step_fn = failing
            maybe_restore = trainer.maybe_restore

            def timed_restore(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = maybe_restore(*args)
                torch.cuda.synchronize()
                times["restore"].append(time.perf_counter() - t)
                return got
            trainer.maybe_restore = timed_restore
            t = time.perf_counter()
            out = trainer.fit()
            times["fit"].append(time.perf_counter() - t)
            losses.update(zip(range(start, end), out["losses"]))
            last.clear()
            last.update(out)
            return end

        sup = ft.TrainSupervisor(
            ft.ElasticPlanner(model_parallel=1, chips_per_host=1,
                              global_batch=TRAIN_BATCH),
            ft.HeartbeatMonitor(["host0"], timeout_s=1e9),
            restore_latest=restore_latest, run_segment=run_segment)
        t = time.perf_counter()
        try:
            rep = sup.run(total_steps=SUPERVISED_STEPS)
            supervised_s = time.perf_counter() - t
            latest = ckpt.latest_step(d)
            t = time.perf_counter()
            whole = supervised_trainer(rt, SUPERVISED_STEPS, None).fit()
            whole_s = time.perf_counter() - t
        finally:
            restore_plain()
    launches = {k: fsk.LAUNCHES[k] - before[k] for k in before}
    n_comp = sum(rt["gc"].plan_for_leaf(rt["gc"].CompressConfig(
        ratio=TRAIN_RATIO), p.numel()) is not None
        for p in rt["tree"].leaves(whole["final_params"]))
    steps = SUPERVISED_STEPS + 1 + SUPERVISED_STEPS   # one step rerun
    print(f"  (b) TrainSupervisor over the Trainer ({TRAIN_ARCH}, "
          f"{SUPERVISED_LAYERS} layers, {n_comp} compressed leaves, "
          f"segments of up to {SUPERVISED_SEGMENT} steps, a checkpoint every "
          f"{SUPERVISED_CKPT_EVERY}; the second segment raises after its "
          f"first step): "
          f"steps_done {rep.steps_done}, restarts {rep.restarts}, meshes "
          f"{[(p.data, p.model) for p in rep.mesh_history]}, latest "
          f"checkpoint {latest}; {supervised_s:.1f} s supervised, "
          f"{whole_s:.1f} s uninterrupted; fit by segment "
          f"{[round(s, 2) for s in times['fit']]} s, restores "
          f"{[round(s, 2) for s in times['restore']]} s, waits on the "
          f"checkpointer {[round(s, 3) for s in times['wait']]} s; "
          f"losses {[round(losses[s], 4) for s in range(SUPERVISED_STEPS)]}")
    check((rep.steps_done, rep.restarts) == (SUPERVISED_STEPS, 1),
          f"(b) report {rep}")
    check(latest == SUPERVISED_STEPS, f"(b) latest checkpoint {latest}")
    check([losses[s] for s in range(SUPERVISED_STEPS)] == whole["losses"],
          f"(b) losses {losses} against {whole['losses']}")
    for name in ("final_params", "final_opt", "final_err"):
        for (pa, a), (pb, b) in zip(rt["tree"].leaves_with_path(last[name]),
                                    rt["tree"].leaves_with_path(whole[name])):
            check(pa == pb and torch.equal(a, b),
                  f"(b) {name} {pa} differs from the uninterrupted run")
    check(all(launches[k] == n_comp * steps for k in NARROW_KERNELS)
          and sum(launches.values()) == 2 * n_comp * steps,
          f"(b) launches {({k: v for k, v in launches.items() if v})}, not "
          f"one narrow forward and transpose a compressed leaf and step")
    check(not plain, f"(b) plain versions ran: {plain}")
    print(f"  (b) final parameters, AdamW and error state torch.equal to "
          f"the uninterrupted run, every loss equal; {steps} steps of "
          f"{n_comp} narrow forward and transpose launches each, no plain "
          f"version")
    del live, last, whole
    return launches, dict(times, supervised_s=supervised_s, whole_s=whole_s)


def phase_pod(rt):
    """Phase 13 (the module docstring): (c) the specs, (a) the pod mean,
    (b) the supervisor.  Returns the narrow kernels' launches of (a) and
    (b)."""
    pygc.collect()
    clear_csr_caches(rt)              # each rank builds its own CSRs
    print(f"phase 13: sharding specs, the pod-axis mean of compressed "
          f"gradients on {POD_RANKS} gloo ranks sharing the card, the "
          f"supervisor around the Trainer; "
          f"{torch.cuda.memory_allocated():,} bytes allocated before it")
    specs = pod_specs(rt)
    ranks = pod_mean(rt)
    sup_launches, sup_times = pod_supervised(rt)
    pygc.collect()
    clear_csr_caches(rt)
    launches = {k: sum(o["launches"][k] for o in ranks) + sup_launches[k]
                for k in NARROW_KERNELS}
    print("pod: " + json.dumps(dict(
        specs=specs, ranks=[{k: o[k] for k in (
            "loss", "compress_s", "peak", "g_hat_err", "error_err",
            "leaves")} for o in ranks], supervised=sup_times,
        launches=launches)))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the dry-run and the roofline.
# ---------------------------------------------------------------------------

DRYRUN_ARCH, DRYRUN_SHAPE = "qwen3-0.6b", "train_4k"
# (b)'s mesh and batch × sequence: one device, phase 10's batch
DRYRUN_FLOOR = f"1x1:{TRAIN_BATCH}x{TRAIN_SEQ}"


def dryrun_child():
    """Start ``python -m repro_torch.launch.dryrun`` for (a) and (b) in a
    child process (CPU only) writing to a temporary ``DRYRUN_OUT``;
    returns (process, its output directory, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, DRYRUN_OUT=out,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--multi-pod", "single",
           "--no-skip-existing", "--also", DRYRUN_FLOOR]
    print("  child: " + " ".join(cmd[1:]))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root)
    return proc, out, time.perf_counter()


def dryrun_measured_step(rt):
    """(b)'s step on the card: qwen3-0.6b (bf16, 28 layers) through
    ``build_train_step`` with no compression at phase 10's batch, two warm
    steps, then one under ``torch.profiler`` and one under
    ``FlopCounterMode``.  Everything is freed before it returns."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    cfg = rt["get_arch"](DRYRUN_ARCH)
    opt = rt["adamw"].AdamWConfig(state_dtype=cfg.optstate_dtype)
    step, model = rt["train_step"].build_train_step(cfg, opt)
    params = model.init(0, "cuda")
    state = rt["adamw"].init_state(params, opt)
    batch = rt["factory"].make_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                           seed=0, device="cuda")
    try:
        for _ in range(2):
            params, state, _, metrics = step(params, state, {}, batch)
        check(bool(torch.isfinite(metrics["loss"])), "(b) loss not finite")
        with profile(activities=[ProfilerActivity.CUDA]):   # a throwaway
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            params, state, _, _ = step(params, state, {}, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        counter = FlopCounterMode(display=False)
        with counter:
            params, state, _, _ = step(params, state, {}, batch)
        torch.cuda.synchronize()
        return dict(wall_ms=wall * 1e3, busy_ms=busy,
                    flop_counter=float(counter.get_total_flops()),
                    peak=torch.cuda.max_memory_allocated())
    finally:
        del params, state, batch, model, step
        pygc.collect()
        torch.cuda.empty_cache()


def phase_dryrun(rt):
    """Phase 14 (the module docstring): the dry-run's child process, (a)
    its pod256 record, (b) its floor under the measured step."""
    import shutil
    dr, analysis, hp = rt["dryrun"], rt["analysis"], rt["hlo_parse"]
    print(f"phase 14: the dry-run of {DRYRUN_ARCH} x {DRYRUN_SHAPE} on the "
          f"(16, 16) mesh and at {DRYRUN_FLOOR} in a child process (CPU "
          f"only), the step measured on the card meanwhile; torch "
          f"{torch.__version__}")
    proc, out, t0 = dryrun_child()
    try:
        measured = dryrun_measured_step(rt)
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure("phase 14: the dry-run's child timed out")
        child_s = time.perf_counter() - t0
        for line in stdout.splitlines():
            if line.startswith("[dryrun]") or line.lstrip().startswith("|"):
                print("  " + line.strip())
        check(proc.returncode == 0,
              f"phase 14: the dry-run exited {proc.returncode}: "
              f"{stderr[-1500:]}")
        check("cuda initialised: False" in stdout,
              "phase 14: the dry-run's process initialised CUDA")
        recs = {}
        for name in os.listdir(out):
            if name.endswith(".json"):
                with open(os.path.join(out, name)) as f:
                    rec = json.load(f)
                recs[rec["mesh"]] = rec
        floor_mesh = "mesh" + DRYRUN_FLOOR.split(":")[0]
        check(set(recs) == {"pod256", floor_mesh}, f"phase 14: records "
              f"{sorted(recs)}")
        for rec in recs.values():
            check(rec["status"] == "ok", f"phase 14: {rec['mesh']} "
                  f"{rec['status']}: {rec.get('error', '')[:300]}")
        pod = recs["pod256"]
        print(f"  (a) {DRYRUN_ARCH} x {DRYRUN_SHAPE} x pod256: ok, traced "
              f"in {pod['compile_s']:.1f} s; the child took {child_s:.1f} s; "
              f"CUDA not initialised in it")
        print("  " + analysis.format_row(dr.report_of(pod)))
        floor = recs[floor_mesh]
        with gzip.open(os.path.join(out, f"{floor['arch']}_{floor['shape']}"
                                         f"_{floor_mesh}.graphs.json.gz"),
                       "rt") as f:
            walker_mm = hp.matmul_flops(json.load(f)["graphs"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(out, ignore_errors=True)
    floor_ms = floor["step_time_s"] * 1e3
    busy, wall = measured["busy_ms"], measured["wall_ms"]
    print("  " + analysis.format_row(dr.report_of(floor)))
    print(f"  (b) {DRYRUN_ARCH} at {DRYRUN_FLOOR} (uncompressed; bf16, "
          f"{rt['get_arch'](DRYRUN_ARCH).n_layers} layers): roofline floor "
          f"{floor_ms:.3f} ms ({floor['bottleneck']}; compute "
          f"{floor['compute_s'] * 1e3:.3f}, memory "
          f"{floor['memory_s'] * 1e3:.3f}, collective "
          f"{floor['collective_s'] * 1e3:.3f}) modeled from the published "
          f"figures of the NVIDIA H100 80GB HBM3 (SXM); measured device "
          f"busy {busy:.3f} ms, host wall {wall:.3f} ms; floor / busy "
          f"{floor_ms / busy:.3f}, floor / wall {floor_ms / wall:.3f}, "
          f"busy / wall {busy / wall:.3f}; flops: walker "
          f"{floor['device_flops']:.4e} (matrix products {walker_mm:.4e}), "
          f"FlopCounterMode {measured['flop_counter']:.4e} (products "
          f"{walker_mm / measured['flop_counter']:.3f}x); peak "
          f"{measured['peak'] / 2**30:.2f} GiB")
    check(busy > 0, "phase 14: the profiler saw no device time")
    check(floor_ms <= busy, f"phase 14: the roofline floor {floor_ms:.3f} ms "
          f"is above the measured device busy {busy:.3f} ms: the walker "
          f"over-counts")
    print("dryrun: " + json.dumps(dict(
        pod256=dict(status=pod["status"], trace_s=pod["compile_s"],
                    step_time_ms=pod["step_time_s"] * 1e3,
                    bottleneck=pod["bottleneck"],
                    mem_gib=(pod["arg_bytes_per_device"]
                             + pod["temp_bytes_per_device"]) / 2**30),
        child_s=child_s, floor_ms=floor_ms, busy_ms=busy, wall_ms=wall,
        walker_flops=floor["device_flops"], walker_matmul_flops=walker_mm,
        flop_counter=measured["flop_counter"],
        torch_version=torch.__version__)))


# ---------------------------------------------------------------------------
# Phase 15: the train and decode steps over a (data, model) mesh.
# ---------------------------------------------------------------------------

SHARD_DIMS, SHARD_COMP_DIMS, SHARD_STEPS = (2, 2), (1, 2), 3
SHARD_PROMPT, SHARD_NEW = 8, 8
SHARD_FLOOR = f"2x2:{TRAIN_BATCH}x{TRAIN_SEQ}"
SHARD_BUDGET_S = 150.0
# bf16: one rounding of a value is at most 2^-8 of it
BF16_EPS = 2.0 ** -8


class CollectiveLog:
    """Count, bytes and host ms (the device synchronised around each) of
    every collective that ``spmd.gloo_collectives`` builds, by kind: on
    CUDA tensors over gloo, all of DTensor's.  A collective built from
    another (a reduce-scatter's all-reduce) counts once, as the outer."""

    KINDS = {"gloo_all_reduce": "all_reduce",
             "gloo_all_gather": "all_gather",
             "gloo_reduce_scatter": "reduce_scatter",
             "gloo_alltoall": "all_to_all"}

    def __init__(self, spmd):
        self.spmd, self.depth, self.rows = spmd, 0, {}

    def _wrap(self, kind, fn):
        def logged(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            x = args[0] if args else kwargs.get("self", kwargs.get("input"))
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            torch.cuda.synchronize()
            row = self.rows.setdefault(kind, [0, 0, 0.0])
            row[0] += 1
            row[1] += x.numel() * x.element_size()
            row[2] += (time.perf_counter() - t) * 1e3
            return out
        return logged

    def __enter__(self):
        self.orig = {name: getattr(self.spmd, name) for name in self.KINDS}
        for name, kind in self.KINDS.items():
            setattr(self.spmd, name, self._wrap(kind, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.spmd, name, fn)


def _shard_modules():
    from repro_torch import tree as tr
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import flashsketch as fsk
    from repro_torch.kernels import lowering, ref
    from repro_torch.launch import generate as gen_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compress as gc
    from repro_torch.sharding import partition as pt
    from repro_torch.sharding import spmd
    from repro_torch.train import train_step as ts
    return types.SimpleNamespace(
        tr=tr, smoke_config=smoke_config, get_arch=get_arch, dp=dp, fsk=fsk,
        lowering=lowering, ref=ref, gen_lib=gen_lib, mesh_lib=mesh_lib,
        adamw=adamw, gc=gc, pt=pt, spmd=spmd, ts=ts)


def _shard_setup(m, cfg, compress=None):
    """The arch's config (smoke at ``cfg["smoke"]``), the step, the model,
    AdamW's config and phase 10's first ``SHARD_STEPS`` batches."""
    arch = m.get_arch(TRAIN_ARCH)
    if cfg["smoke"]:
        arch = m.smoke_config(arch)
    opt = m.adamw.AdamWConfig(lr=TRAIN_LR, state_dtype=arch.optstate_dtype)
    step_fn, model = m.ts.build_train_step(arch, opt, compress)
    data = m.dp.DataConfig(vocab_size=min(TRAIN_DATA_VOCAB, arch.vocab_size),
                           global_batch=cfg["batch"], seq_len=cfg["seq"],
                           seed=0)
    batches = [{k: torch.from_numpy(v).to(cfg["device"]) for k, v in
                m.dp.make_batch(data, s).items()} for s in range(SHARD_STEPS)]
    return arch, opt, step_fn, model, batches


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _profiled(fn, device):
    """(result, wall ms, device busy ms, the five largest device times)
    of ``fn()`` under ``torch.profiler``, the device's activity only (the
    host's events of a step over DTensors take seconds to collect; busy:
    the sum of the device's kernel and copy times)."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if device == "cuda"
            else [ProfilerActivity.CPU])
    _sync(device)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        _sync(device)
        wall = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(((e.key[:60], round(e.self_device_time_total / 1e3, 3),
                   e.count) for e in dev), key=lambda r: -r[1])[:5]
    return out, wall, busy, top


def _own_chunk(x, like):
    """The chunk of the whole tensor ``x`` that this rank holds of a
    DTensor placed as ``like``, by DTensor's own rule."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, like.device_mesh, like.placements)
    return x[tuple(slice(o, o + n) for n, o in zip(shape, off))]


def _rel_errors(m, got, truth):
    """Per leaf (by its dotted path): max|got − truth| / max|truth|, in
    f32; where ``got`` is a DTensor, over this rank's chunk of it."""
    out = {}
    for (path, t), g in zip(m.tr.leaves_with_path(truth), m.tr.leaves(got)):
        t = t.float()
        part = t
        if m.pt.is_dtensor(g):
            g, part = g.to_local(), _own_chunk(t, g)
        err = (float((g.float() - part).abs().max()) if g.numel() else 0.0)
        out[".".join(path)] = err / max(float(t.abs().max()), 1e-30)
    return out


class _GradTap:
    """``fn`` of the gradients of a step, the second argument of
    ``owner.name`` (``adamw.apply_updates``), at its first call in the
    context."""

    def __init__(self, owner, name, fn):
        self.owner, self.name, self.fn, self.value = owner, name, fn, None

    def __enter__(self):
        self.orig, self.done = getattr(self.owner, self.name), False

        def tapped(*args, **kwargs):
            if not self.done:
                self.done = True
                self.value = self.fn(args[1])
            return self.orig(*args, **kwargs)
        setattr(self.owner, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _one_device_grads(m, arch, model, batch, dev):
    """(loss, gradients) of one device's forward and backward of the
    uncompressed step, from the seed's weights (``model``'s, cast to
    ``arch``'s parameter dtype); no optimizer state is made."""
    from repro_torch.models.factory import build_model
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    params = m.tr.tree_map(lambda p: torch.nn.Parameter(
        p.detach().to(dt[arch.param_dtype])), model.init(0, dev))
    loss, _ = build_model(arch).loss(params, batch)
    loss.backward()
    grads = m.tr.tree_map(lambda p: p.grad, params)
    return float(loss), grads


def shard_train_rank(rank, world, cfg):
    """(a) and (c) on one rank of the (2, 2) mesh: on every rank one
    device's first step in f32 (the truth), on rank 0 also in bf16 and on
    rank 1 in bf16 on its data shard alone (half the batch: what a rank
    holds before the data axis's reduction); 3 steps over the mesh (the
    first's gradients held, each rank's chunk, to the truth; the second
    under ``CommDebugMode``, ``FlopCounterMode`` and the collective log,
    the third profiled); then greedy generation on one device and over
    the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    m = _shard_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = cfg["device"]
    out = {"start": time.time() - cfg["t_spawn"]}
    marks = out["marks"] = []

    def mark(label):
        _sync(dev)
        marks.append((label, round(time.time() - cfg["t_spawn"], 1)))
    arch, opt, step_fn, model, batches = _shard_setup(m, cfg)
    mesh = m.mesh_lib.make_mesh(SHARD_DIMS, ("data", "model"))
    ctx = m.ts.sharding_ctx_for(mesh, arch)
    arch32 = dataclasses.replace(arch, param_dtype="float32")
    _, truth = _one_device_grads(m, arch32, model, batches[0], dev)
    if rank == 0:
        out["single_loss"], g = _one_device_grads(m, arch, model,
                                                  batches[0], dev)
        out["err_single"] = _rel_errors(m, g, truth)
        del g
    if rank == 1:
        half = {k: v[:v.shape[0] // SHARD_DIMS[0]]
                for k, v in batches[0].items()}
        _, g = _one_device_grads(m, arch, model, half, dev)
        out["err_shard0"] = _rel_errors(m, g, truth)
        del g
    if dev == "cuda":
        # four processes share the card: what each cached goes back
        torch.cuda.empty_cache()
    mark("one-device steps")
    dist.barrier()
    params = model.init(0, dev)
    sp, so, _ = m.ts.shard_train_state(arch, mesh, params,
                                       m.adamw.init_state(params, opt),
                                       device_type=dev)
    del params
    sb = [m.ts.shard_batch(arch, mesh, b, dev) for b in batches]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    comm, flops, log = CommDebugMode(), FlopCounterMode(display=False), \
        CollectiveLog(m.spmd)
    tap = _GradTap(m.adamw, "apply_updates",
                   lambda g: _rel_errors(m, g, truth))
    losses, walls = [], []
    with mesh, m.pt.activate(ctx):
        for i in range(SHARD_STEPS):
            run = lambda: step_fn(sp, so, {}, sb[i])
            if i == SHARD_STEPS - 1:
                (_, so, _, met), wall, busy, top = _profiled(run, dev)
                out.update(busy_ms=busy, profiled_wall_ms=wall, top=top)
            else:
                modes = tap if i == 0 else log
                with modes, (comm if i == 1 else contextlib.nullcontext()), \
                        (flops if i == 1 else contextlib.nullcontext()):
                    _sync(dev)
                    t = time.perf_counter()
                    _, so, _, met = run()
                    _sync(dev)
                    wall = (time.perf_counter() - t) * 1e3
            losses.append(float(met["loss"]))
            walls.append(wall)
            mark(f"step {i + 1}")
            if i == 0:
                out["err_sharded"] = tap.value
                del truth
    out.update(losses=losses, walls_ms=walls,
               comm={str(k): int(v) for k, v in
                     comm.get_comm_counts().items()},
               collectives=log.rows,
               flops=float(flops.get_total_flops()),
               peak=(torch.cuda.max_memory_allocated() if dev == "cuda"
                     else 0))
    del sp, so, sb, comm, flops
    pygc.collect()
    out.update(shard_generate(m, cfg, model, arch, mesh, ctx, rank, mark))
    out["t_end"] = time.time()
    return out


class _LogitTap:
    """Every decode step's (B, vocab) logits, gathered, appended to a list
    (``generate`` calls ``train_step.decode_step``, wrapped here for the
    context's duration)."""

    def __init__(self, m, into):
        self.ts, self.spmd, self.into = m.ts, m.spmd, into

    def __enter__(self):
        self.step = step = self.ts.decode_step

        def recording(model, *args):
            logits, state = step(model, *args)
            self.into.append(self.spmd.full_tensor(logits)[
                :, 0, :model.cfg.vocab_size])
            return logits, state
        self.ts.decode_step = recording
        return self

    def __exit__(self, *exc):
        self.ts.decode_step = self.step


def shard_generate(m, cfg, model, arch, mesh, ctx, rank, mark):
    """(c): fresh weights from the seed; greedy generation of
    ``SHARD_NEW`` tokens after ``SHARD_PROMPT`` over the mesh, every
    step's logits recorded (``_LogitTap``); on rank 0 also on one device,
    and the truth there: the same decode in f32, teacher-forced over the
    one-device tokens.  Each row is compared up to its first token that
    differs (the contexts agree until then): the largest logit difference
    of the mesh's decode from the truth and from one device's bf16 decode,
    bf16's own error (one device's from the truth), and at a differing
    token one device's top-2 margin of that row."""
    import torch.distributed as dist
    from repro_torch.models.factory import build_model
    dev, B = cfg["device"], cfg["batch"]
    params = model.init(0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompts = torch.randint(0, arch.vocab_size, (B, SHARD_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    max_seq = SHARD_PROMPT + SHARD_NEW
    out = {}
    if rank == 0:
        want, ref32 = [], []
        with _LogitTap(m, want):
            one, out["gen_tps_single"] = m.gen_lib.generate(
                model, params, prompts, SHARD_NEW, {})
        arch32 = dataclasses.replace(arch, param_dtype="float32")
        with _LogitTap(m, ref32):
            m.gen_lib.generate(build_model(arch32), m.tr.tree_map(
                lambda p: p.detach().float(), params), one, 0, {})
        mark("one-device decodes")
    sp = m.ts.shard_params(arch, mesh, params, dev)
    state = m.ts.shard_decode_state(arch, mesh, model.init_decode_state(
        params, B, max_seq, {}), dev)
    del params
    dist.barrier()
    got = []
    with mesh, m.pt.activate(ctx), _LogitTap(m, got):
        toks, out["gen_tps"] = m.gen_lib.generate(
            model, sp, prompts, SHARD_NEW, {}, state=state)
    mark("sharded generation")
    out["tokens"] = toks.cpu().tolist()
    if rank != 0:
        return out
    diff = diff32 = err32 = 0.0
    flips = []
    for row in range(B):
        for pos, (w, g, f) in enumerate(zip(want, got, ref32)):
            w, g, f = w[row].float(), g[row].float(), f[row].float()
            diff = max(diff, float((w - g).abs().max()))
            diff32 = max(diff32, float((g - f).abs().max()))
            err32 = max(err32, float((w - f).abs().max()))
            if toks[row, pos + 1] != one[row, pos + 1]:
                top = torch.topk(w, 2).values
                flips.append((pos, row, float(top[0] - top[1]),
                              float((w - g).abs().max())))
                break
    out.update(gen_equal=torch.equal(one, toks), logit_diff=diff,
               logit_diff32=diff32, bf16_err=err32, flips=flips,
               logit_scale=max(float(w.abs().max()) for w in want))
    return out


def shard_compress_rank(rank, world, cfg):
    """(b) on one rank of the (1, 2) mesh: 3 compressed steps (ratio 8),
    the launches of the narrow kernels and of any plain version counted.
    In the last step, each leaf's ĝ as every rank computed it before
    placing it (a digest, to be equal across the ranks), the gathered
    gradient and error state holding this rank's chunks, and each rank's
    chunk of the placed ĝ and new error state against the same chunk, by
    DTensor's rule, of one device's compression of the gathered gradient
    and error state, leaf by leaf on the card; the check's launches not
    counted."""
    import hashlib
    m = _shard_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = cfg["device"]
    out = {"start": time.time() - cfg["t_spawn"]}
    comp = m.gc.CompressConfig(ratio=TRAIN_RATIO)
    arch, opt, step_fn, model, batches = _shard_setup(m, cfg, comp)
    mesh = m.mesh_lib.make_mesh(SHARD_COMP_DIMS, ("data", "model"))
    params = model.init(0, dev)
    sp, so, se = m.ts.shard_train_state(arch, mesh, params,
                                        m.adamw.init_state(params, opt),
                                        m.gc.init_error_state(params), dev)
    del params
    sb = [m.ts.shard_batch(arch, mesh, b, dev) for b in batches]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    leaf_compress, compress = m.gc._leaf_compress, m.gc.compress_gradients
    # the last step's gathered leaves and error states, in the order that
    # compress_gradients walks them
    checked = {"digests": {}, "equal": {}, "gathered": [], "last": False}

    def spy_leaf(c, plan, g, e, *args):
        gh, ne = leaf_compress(c, plan, g, e, *args)
        if checked["last"]:
            checked["gathered"].append((g, e))
            checked["digests"][len(checked["digests"])] = hashlib.sha256(
                gh.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
        return gh, ne

    def spy_compress(c, grads, err, *args, **kwargs):
        gh, ne = compress(c, grads, err, *args, **kwargs)
        if not checked["last"]:
            return gh, ne
        checked["last"] = False        # the check's own compressions
        saved = dict(m.fsk.LAUNCHES)
        for (path, g), (g_full, e_full) in zip(
                m.tr.leaves_with_path(grads), checked["gathered"]):
            want_h, want_e = compress(c, {"leaf": g_full}, {"leaf": e_full},
                                      *args, **kwargs)
            h, e = m.tr.get(gh, path), m.tr.get(ne, path)
            err_in = m.tr.get(err, path)
            checked["equal"][".".join(path)] = (
                # the gathered leaf and error state hold this rank's own
                # chunks where DTensor's rule puts them
                torch.equal(g.to_local(), _own_chunk(g_full, g))
                and torch.equal(err_in.to_local(), _own_chunk(e_full, err_in))
                and torch.equal(h.to_local(), _own_chunk(want_h["leaf"], h))
                and torch.equal(e.to_local(), _own_chunk(want_e["leaf"], e)))
            del want_h, want_e
        checked["gathered"].clear()
        m.fsk.LAUNCHES.update(saved)
        return gh, ne
    plain = {}
    restore = spy_plain({"ref": m.ref, "lowering": m.lowering}, plain)
    m.gc._leaf_compress, m.gc.compress_gradients = spy_leaf, spy_compress
    m.fsk.reset_launch_counts()
    losses, walls = [], []
    try:
        with mesh, m.pt.activate(m.ts.sharding_ctx_for(mesh, arch)):
            for i in range(SHARD_STEPS):
                checked["last"] = i == SHARD_STEPS - 1
                _sync(dev)
                t = time.perf_counter()
                _, so, se, met = step_fn(sp, so, se, sb[i])
                _sync(dev)
                walls.append((time.perf_counter() - t) * 1e3)
                losses.append(float(met["loss"]))
                out.setdefault("marks", []).append(
                    round(time.time() - cfg["t_spawn"], 1))
    finally:
        m.gc._leaf_compress, m.gc.compress_gradients = leaf_compress, \
            compress
        restore()
    out.update(losses=losses, walls_ms=walls, plain=plain,
               launches=dict(m.fsk.LAUNCHES),
               n_comp=sum(m.gc.plan_for_leaf(comp, g.numel()) is not None
                          for g in m.tr.leaves(sp)),
               peak=(torch.cuda.max_memory_allocated() if dev == "cuda"
                     else 0),
               digests=checked["digests"], equal_single=checked["equal"])
    out["t_end"] = time.time()
    return out


def dryrun_floor_child():
    """``python -m repro_torch.launch.dryrun`` tracing qwen3-0.6b's train
    step on the (2, 2) mesh at phase 10's batch alone (CPU only), into a
    temporary ``DRYRUN_OUT``; returns (process, directory, start)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    env = dict(os.environ, DRYRUN_OUT=out,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           TRAIN_ARCH, "--shape", DRYRUN_SHAPE, "--multi-pod", "none",
           "--no-skip-existing", "--also", SHARD_FLOOR]
    print("  (d) child: " + " ".join(cmd[1:]))
    # at a lower priority, one thread: the ranks' host work comes first
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root,
                            preexec_fn=lambda: os.nice(10))
    return proc, out, time.perf_counter()


def _dryrun_floor(rt, proc, out):
    """The (2, 2) record of the child and its walker's product flops."""
    import shutil
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure("phase 15: the dry-run's child timed out")
    try:
        check(proc.returncode == 0, f"phase 15 (d): the dry-run exited "
              f"{proc.returncode}: {stderr[-1500:]}")
        name = [f for f in os.listdir(out) if f.endswith(".json")]
        check(len(name) == 1, f"phase 15 (d): records {name}")
        with open(os.path.join(out, name[0])) as f:
            rec = json.load(f)
        check(rec["status"] == "ok", f"phase 15 (d): {rec['status']}: "
              f"{rec.get('error', '')[:300]}")
        with gzip.open(os.path.join(out, name[0][:-5] + ".graphs.json.gz"),
                       "rt") as f:
            mm = rt["hlo_parse"].matmul_flops(json.load(f)["graphs"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return rec, mm


def _print_train_ranks(ranks):
    for r, o in enumerate(ranks):
        rows = ", ".join(f"{k} {n} x {b / 2**20:.1f} MiB {ms:.1f} ms"
                         for k, (n, b, ms) in sorted(o["collectives"].items()))
        print(f"    rank {r}: step walls {[round(w, 1) for w in o['walls_ms']]}"
              f" ms (1: first, 2: under the modes and the collective log, "
              f"3: profiled); device busy {o['busy_ms']:.3f} ms of "
              f"{o['profiled_wall_ms']:.1f} (idle share "
              f"{1 - o['busy_ms'] / o['profiled_wall_ms']:.3f}; the largest "
              f"(name, ms, calls): {o['top']}); losses "
              f"{[round(x, 4) for x in o['losses']]}; peak "
              f"{o['peak'] / 2**30:.2f} GiB; CommDebugMode {o['comm']}; "
              f"collectives of step 2 by kind (gloo, host-staged): {rows}; "
              f"gloo {sum(v[2] for v in o['collectives'].values()):.1f} ms")


def _grad_ratios(got, own):
    """Per leaf: ``got``'s error over its tolerance, twice one device's
    own bf16 error ``own`` (both relative to the leaf's largest truth)
    plus one bf16 rounding of that largest element (2⁻⁸)."""
    return {k: got[k] / (2 * own[k] + BF16_EPS) for k in own}


def shard_check_train(ranks, base):
    """The checks and the lines of (a) and (c); returns rank 0's results."""
    # (a)
    r0 = ranks[0]
    own = r0["err_single"]
    # each rank's chunks against the truth: the worst over the ranks
    mesh_err = {k: max(o["err_sharded"][k] for o in ranks) for k in own}
    ratios = _grad_ratios(mesh_err, own)
    leaf = max(ratios, key=ratios.get)
    # what the check makes of a state that step 1 left unchanged (each
    # leaf's gradient zero: error 1) and of data shard 0 alone
    unchanged = min(_grad_ratios(dict.fromkeys(own, 1.0), own).values())
    shard0 = _grad_ratios(ranks[1]["err_shard0"], own)
    d_loss = abs(r0["losses"][0] - r0["single_loss"])
    print(f"  (a) {SHARD_DIMS} mesh, batch {TRAIN_BATCH} x {base['seq']}: "
          f"step 1 loss {r0['losses'][0]:.6f} against one device's "
          f"{r0['single_loss']:.6f} (|d| {d_loss:.3e}, tolerance "
          f"{BF16_EPS * abs(r0['single_loss']):.3e} = 2^-8 |loss|); step 1's "
          f"gradients, each rank's chunk, against one device's f32 step (the "
          f"truth, on every rank), "
          f"each leaf's max error relative to its largest gradient, within "
          f"2 x one device's bf16 error + 2^-8: worst leaf {leaf} at "
          f"{ratios[leaf]:.3f} of it ({mesh_err[leaf]:.3e} "
          f"against one device's {own[leaf]:.3e}); one device's bf16 error "
          f"{min(own.values()):.3e}-{max(own.values()):.3e}, the mesh's "
          f"{min(mesh_err.values()):.3e}-{max(mesh_err.values()):.3e} over "
          f"{len(own)} leaves; the same check gives an unchanged state "
          f"(zero gradients) {unchanged:.1f} or more of the tolerance at "
          f"every leaf, and data shard 0 alone (half the batch, no "
          f"data-axis reduction) {min(shard0.values()):.2f}-"
          f"{max(shard0.values()):.2f}")
    _print_train_ranks(ranks)
    for r, o in enumerate(ranks):
        check(all(math.isfinite(x) for x in o["losses"]),
              f"phase 15 (a): rank {r} losses {o['losses']}")
        check(o["losses"] == r0["losses"],
              f"phase 15 (a): rank {r} losses differ from rank 0's")
    check(d_loss <= BF16_EPS * abs(r0["single_loss"]),
          f"phase 15 (a): step 1 loss {d_loss:.3e} from one device's")
    check(ratios[leaf] <= 1.0, f"phase 15 (a): the gradient of {leaf} at "
          f"{ratios[leaf]:.3f} of its tolerance")
    check(unchanged > 1.0 and max(shard0.values()) > 1.0,
          f"phase 15 (a): the gradients' check would pass an unchanged "
          f"state ({unchanged:.3f}) or one data shard's gradient "
          f"({max(shard0.values()):.3f})")
    # (c)
    print(f"  (c) greedy {SHARD_PROMPT} + {SHARD_NEW} tokens, batch "
          f"{TRAIN_BATCH}: tokens equal to one device's: "
          f"{r0['gen_equal']}; tok/s {r0['gen_tps']:.2f} over the mesh, "
          f"{r0['gen_tps_single']:.1f} on one device; each row up to its "
          f"first differing token: max |d logit| from the f32 decode (the "
          f"truth) {r0['logit_diff32']:.3e} over the mesh against one "
          f"device's bf16 {r0['bf16_err']:.3e} (tolerance twice it); from "
          f"one device's bf16 decode {r0['logit_diff']:.3e}; max |logit| "
          f"{r0['logit_scale']:.2f}; differing tokens (position, row, one "
          f"device's top-2 margin, the row's max |d|): {r0['flips']}")
    for r, o in enumerate(ranks):
        check(o["tokens"] == r0["tokens"], f"phase 15 (c): rank {r}'s "
              f"tokens differ from rank 0's")
    # (+ f32's sum order, for a model in f32 as at the smoke config)
    check(r0["logit_diff32"] <= 2 * r0["bf16_err"]
          + 1e-5 * r0["logit_scale"],
          f"phase 15 (c): logits {r0['logit_diff32']:.3e} from the f32 "
          f"decode, over twice one device's bf16 error {r0['bf16_err']:.3e}")
    for pos, row, margin, d in r0["flips"]:
        check(margin <= 2 * d, f"phase 15 (c): the token at position "
              f"{pos + 1}, row {row} differs with one device's top-2 margin "
              f"{margin:.3e} over twice its max |d| {d:.3e}")
    return r0


def shard_check_compress(comp, device, single_loss):
    """The checks and the line of (b); ``single_loss``: (a)'s one-device
    first step from the same weights and batch."""
    # (b)
    c0 = comp[0]
    n_comp = c0["n_comp"]
    d_loss = abs(c0["losses"][0] - single_loss)
    for r, o in enumerate(comp):
        shown = {k: v for k, v in o["launches"].items() if v}
        # (on the CPU, a check of this phase's code at smoke size, the
        # wrappers run their plain versions)
        check(device != "cuda" or (
            all(o["launches"][k] == SHARD_STEPS * n_comp
                for k in NARROW_KERNELS)
            and sum(o["launches"].values()) == 2 * SHARD_STEPS * n_comp),
              f"phase 15 (b): rank {r} launches {shown}, not one narrow "
              f"forward and one narrow transpose a compressed leaf "
              f"({n_comp}) a step ({SHARD_STEPS})")
        check(device != "cuda" or not o["plain"], f"phase 15 (b): rank {r} "
              f"plain versions {o['plain']}")
        check(len(o["digests"]) == len(o["equal_single"])
              and o["digests"] == c0["digests"],
              f"phase 15 (b): rank {r}'s g_hat differs from rank 0's")
        bad = [k for k, ok in o["equal_single"].items() if not ok]
        check(o["equal_single"] and not bad, f"phase 15 (b): rank {r}: the "
              f"gathered gradient or error state, or its chunk of the placed "
              f"g_hat or error state, of {bad} is not where DTensor puts it "
              f"or differs from one device's compression of the gathered "
              f"gradient")
        check(all(math.isfinite(x) for x in o["losses"]),
              f"phase 15 (b): rank {r} losses {o['losses']}")
        check(o["losses"] == c0["losses"],
              f"phase 15 (b): rank {r} losses differ from rank 0's")
    check(d_loss <= BF16_EPS * abs(single_loss),
          f"phase 15 (b): step 1 loss {d_loss:.3e} from one device's")
    print(f"  (b) {SHARD_COMP_DIMS} mesh, ratio {TRAIN_RATIO}: "
          f"{SHARD_STEPS} steps, one narrow forward and one narrow "
          f"transpose a compressed leaf ({n_comp}) a step a rank, no plain "
          f"version; step 1's loss {d_loss:.3e} from (a)'s one device's; "
          f"the last step's g_hat the same bits on both ranks at all "
          f"{len(c0['digests'])} leaves, the gathered gradient and error "
          f"state holding each rank's own chunks, and each rank's chunk of the "
          f"placed g_hat and error state torch.equal to the same chunk "
          f"(DTensor's rule) of one device's compression of the gathered "
          f"gradient and error state (step 3's wall includes that check); "
          f"losses {[round(x, 4) for x in c0['losses']]}; step walls "
          + "; ".join(f"rank {r} {[round(w, 1) for w in o['walls_ms']]} ms"
                      for r, o in enumerate(comp))
          + f"; peak {[round(o['peak'] / 2**30, 2) for o in comp]} GiB")


def phase_sharded(rt, device="cuda", smoke=False):
    """Phase 15 (the module docstring): (a) and (c) on 4 gloo ranks sharing
    the card, (b) on 2, (d) the dry-run's child meanwhile.  Returns the
    narrow kernels' launches of (b)."""
    t0 = time.perf_counter()
    pygc.collect()
    clear_csr_caches(rt)
    print(f"phase 15: qwen3-0.6b's train and decode steps over a (data, "
          f"model) mesh of gloo ranks sharing the card (DTensor state, the "
          f"collectives that gloo lacks on CUDA built by spmd."
          f"gloo_collectives); torch {torch.__version__}")
    proc, out, _ = dryrun_floor_child()
    base = dict(device=device, smoke=smoke, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ if not smoke else 16)
    try:
        t = time.perf_counter()
        ranks = rt["run_ranks"](shard_train_rank, 4, dict(
            base, t_spawn=time.time()), timeout=SPAWN_TIMEOUT_S)
        print(f"  (a)+(c) 4 ranks in {time.perf_counter() - t:.1f} s (work "
              f"started {min(o['start'] for o in ranks):.1f}-"
              f"{max(o['start'] for o in ranks):.1f} s after the call)")
        print("  rank 0's timeline (s after the call): "
              + ", ".join(f"{k} {v}" for k, v in ranks[0]["marks"]))
        r0 = shard_check_train(ranks, base)
        t = time.perf_counter()
        comp = rt["run_ranks"](shard_compress_rank, 2, dict(
            base, t_spawn=time.time()), timeout=SPAWN_TIMEOUT_S)
        print(f"  (b) 2 ranks in {time.perf_counter() - t:.1f} s (work "
              f"started {comp[0]['start']:.1f} s after the call, steps done "
              f"at {comp[0]['marks']} s)")
        shard_check_compress(comp, device, r0["single_loss"])
        rec, walker_mm = _dryrun_floor(rt, proc, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    # (d)
    floor_ms = rec["step_time_s"] * 1e3
    busy = max(min(o["busy_ms"] for o in ranks), 1e-9)
    flops0 = r0["flops"]
    print("  " + rt["analysis"].format_row(rt["dryrun"].report_of(rec)))
    print(f"  (d) the (2, 2) floor {floor_ms:.3f} ms ({rec['bottleneck']}; "
          f"compute {rec['compute_s'] * 1e3:.3f}, memory "
          f"{rec['memory_s'] * 1e3:.3f}, collective "
          f"{rec['collective_s'] * 1e3:.3f}) modeled from the H100 SXM's "
          f"published figures, against the least per-rank device busy "
          f"{busy:.3f} ms: floor / busy {floor_ms / busy:.3f}; the walker's "
          f"product flops a device {walker_mm:.4e}, FlopCounterMode over "
          f"rank 0's step {flops0:.4e} ({walker_mm / flops0:.4f}x)")
    check(busy > 0 or device != "cuda", "phase 15: no device time profiled")
    if device == "cuda":
        check(floor_ms <= busy, f"phase 15 (d): the floor {floor_ms:.3f} ms "
              f"is above a rank's device busy {busy:.3f} ms")
    check(smoke or abs(walker_mm / flops0 - 1) <= 0.05, f"phase 15 (d): "
          f"walker {walker_mm:.4e} against FlopCounterMode {flops0:.4e}")
    took = time.perf_counter() - t0
    print(f"  phase 15 took {took:.1f} s (budget {SHARD_BUDGET_S:.0f})")
    print("sharded: " + json.dumps(dict(
        train=[{k: o[k] for k in ("losses", "walls_ms", "busy_ms",
                                  "profiled_wall_ms", "peak", "comm",
                                  "collectives", "flops")} for o in ranks],
        step1=dict(loss=r0["losses"][0], single=r0["single_loss"],
                   grad_err=[o["err_sharded"] for o in ranks],
                   grad_err_single=r0["err_single"],
                   grad_err_shard0=ranks[1]["err_shard0"]),
        compressed=[{k: o[k] for k in ("losses", "walls_ms", "peak",
                                       "launches")} for o in comp],
        generate=dict(equal=r0["gen_equal"], tps=r0["gen_tps"],
                      tps_single=r0["gen_tps_single"],
                      logit_diff=r0["logit_diff"],
                      logit_diff32=r0["logit_diff32"], bf16_err=r0["bf16_err"],
                      flips=r0["flips"]),
        floor_ms=floor_ms, busy_ms=busy, walker_matmul_flops=walker_mm,
        flop_counter=flops0, seconds=took)))
    if device == "cuda":
        check(took <= SHARD_BUDGET_S, f"phase 15 took {took:.1f} s, over "
              f"its {SHARD_BUDGET_S:.0f} s")
    clear_csr_caches(rt)
    return {k: sum(o["launches"][k] for o in comp) for k in NARROW_KERNELS}


# ---------------------------------------------------------------------------
# Phase 16: checkpoints of sharded state and the elastic re-mesh.
# ---------------------------------------------------------------------------

# 4 steps, a checkpoint every 2 (at most two kept); the first segment ends
# after step 3 (index 2), the last host's heartbeat stops, and the step
# after the checkpoint is run again on the smaller mesh
ELASTIC_STEPS, ELASTIC_FIRST_END = 4, 3
ELASTIC_CKPT_EVERY, ELASTIC_KEEP = 2, 2
# (a) uncompressed, 4 hosts of one chip, the model axis pinned at 2: (2, 2)
# then (1, 2); (b) ratio 8, 2 hosts: (2, 1) then (1, 1)
ELASTIC_HOSTS, ELASTIC_MODEL = 4, 2
ELASTIC_COMP_HOSTS, ELASTIC_COMP_MODEL = 2, 1
ELASTIC_BUDGET_S = 180.0


def _elastic_modules():
    m = _shard_modules()
    from repro_torch.train import checkpoint, trainer
    m.ckpt, m.trainer = checkpoint, trainer
    return m


def elastic_trainer(m, cfg, end, ckpt_dir, mesh=None):
    """A Trainer of qwen3-0.6b at full width cut to SUPERVISED_LAYERS
    layers (the smoke config at ``cfg["smoke"]``), phase 10's batch and
    lr, ratio 8 where ``cfg["compress"]``, a checkpoint every
    ELASTIC_CKPT_EVERY steps in ``ckpt_dir`` (ELASTIC_KEEP kept), on
    ``mesh``, running to ``end``."""
    arch = m.get_arch(TRAIN_ARCH)
    arch = (m.smoke_config(arch) if cfg["smoke"] else
            dataclasses.replace(arch, n_layers=SUPERVISED_LAYERS))
    opt = m.adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5,
                              total_steps=ELASTIC_STEPS,
                              state_dtype=arch.optstate_dtype)
    data = m.dp.DataConfig(vocab_size=min(TRAIN_DATA_VOCAB, arch.vocab_size),
                           global_batch=cfg["batch"], seq_len=cfg["seq"],
                           seed=0)
    tcfg = m.trainer.TrainerConfig(
        total_steps=end, ckpt_every=ELASTIC_CKPT_EVERY, ckpt_dir=ckpt_dir,
        ckpt_keep=ELASTIC_KEEP, log_every=1000)
    comp = (m.gc.CompressConfig(ratio=TRAIN_RATIO) if cfg["compress"]
            else None)
    return m.trainer.Trainer(arch, opt, tcfg, data, compress=comp,
                             log_fn=lambda s: None, device=cfg["device"],
                             mesh=mesh)


def _digest(arr) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    import hashlib
    import numpy as np
    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode())
    h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return h.hexdigest()


def elastic_rank(rank, world, cfg):
    """One rank of a segment: ``Trainer(mesh=)`` on the mesh of
    ``cfg["plan"]`` (``launch.mesh.mesh_for_plan``), ``fit()`` to
    ``cfg["end"]`` from the latest checkpoint of ``cfg["ckpt_dir"]``.  Each
    leaf's digest as its owner wrote it (what the mesh gathered when it
    saved) and, after a restore, as it gathers it on this mesh
    (``checkpoint.gather_to_owners``); the save, restore and step times,
    the launches of the narrow kernels and of any plain version, the
    peak."""
    m = _elastic_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = cfg["device"]
    out = {"start": time.time() - cfg["t_spawn"], "saved": {},
           "walls_ms": [], "restored": {}, "restored_step": None}
    trainer = elastic_trainer(m, cfg, cfg["end"], cfg["ckpt_dir"],
                              m.mesh_lib.mesh_for_plan(cfg["plan"]))
    write, maybe_restore, step_fn = (m.ckpt._write, trainer.maybe_restore,
                                     trainer.step_fn)

    def digesting(pending):
        # on the writer thread, after this rank's files are written
        write(pending)
        out["saved"].setdefault(pending.meta["step"], {}).update(
            {int(k[len("leaf_"):]): _digest(a)
             for arrays in pending.files.values() for k, a in arrays.items()})

    def timed_restore(*args):
        _sync(dev)
        t = time.perf_counter()
        got = maybe_restore(*args)
        _sync(dev)
        out["restore_s"] = time.perf_counter() - t
        params, opt, err, out["restored_step"] = got
        tree = {"params": params, "opt": opt, "err": err}
        out["names"] = [m.tr.keystr(p) for p, _ in
                        m.tr.leaves_with_path(tree)]
        if out["restored_step"]:
            t = time.perf_counter()
            mine = m.ckpt.gather_to_owners(m.tr.leaves(tree))
            out["restored"] = {i: _digest(m.tr.to_numpy(x)[0])
                               for i, x in mine.items()}
            out["restored_gather_s"] = time.perf_counter() - t
        return got

    def timed_step(*args):
        _sync(dev)
        t = time.perf_counter()
        got = step_fn(*args)
        _sync(dev)
        out["walls_ms"].append((time.perf_counter() - t) * 1e3)
        return got

    plain = {}
    restore_plain = spy_plain({"ref": m.ref, "lowering": m.lowering}, plain)
    m.ckpt._write = digesting
    trainer.maybe_restore, trainer.step_fn = timed_restore, timed_step
    m.fsk.reset_launch_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        res = trainer.fit()
    finally:
        m.ckpt._write = write
        restore_plain()
    out.update(
        losses=res["losses"], plain=plain, launches=dict(m.fsk.LAUNCHES),
        saves=[vars(s) for s in trainer.async_ckpt.history],
        n_comp=(sum(m.gc.plan_for_leaf(trainer.compress, p.numel())
                    is not None for p in m.tr.leaves(res["final_params"]))
                if trainer.compress else 0),
        peak=torch.cuda.max_memory_allocated() if dev == "cuda" else 0,
        t_end=time.time() - cfg["t_spawn"])
    return out


def elastic_supervised(rt, base, hosts, model, compress, ckpt_dir):
    """TrainSupervisor over segments of ``elastic_rank`` ranks, each
    segment a fresh ``run_ranks`` group of its plan's size (a DeviceMesh
    needs a group of its size, and DTensor keeps sharding decisions in a
    process): the first ends after ELASTIC_FIRST_END steps, the last
    host's heartbeat stops and the segment raises; the planner shrinks
    the data axis.  Returns the report and the segments."""
    ft, ckpt = rt["fault_tolerance"], rt["checkpoint"]
    clock = [0.0]
    names = [f"host{i}" for i in range(hosts)]
    monitor = ft.HeartbeatMonitor(names, timeout_s=60.0,
                                  clock=lambda: clock[0])
    segments = []

    def run_segment(plan, start):
        end = ELASTIC_FIRST_END if not segments else ELASTIC_STEPS
        dims = (plan.data, plan.model)
        t = time.perf_counter()
        ranks = rt["run_ranks"](elastic_rank, plan.chips, dict(
            base, plan=plan, end=end, ckpt_dir=ckpt_dir, compress=compress,
            t_spawn=time.time()), timeout=SPAWN_TIMEOUT_S)
        segments.append(dict(dims=dims, start=start, end=end, ranks=ranks,
                             wall_s=time.perf_counter() - t))
        if len(segments) == 1:
            clock[0] += 2 * monitor.timeout_s   # the last host stops beating
            for h in names[:-1]:
                monitor.beat(h)
            raise RuntimeError(f"{names[-1]} lost after step {end}")
        return end

    sup = ft.TrainSupervisor(
        ft.ElasticPlanner(model_parallel=model, chips_per_host=1,
                          global_batch=base["batch"]), monitor,
        restore_latest=lambda: ckpt.latest_step(ckpt_dir) or 0,
        run_segment=run_segment)
    return sup.run(total_steps=ELASTIC_STEPS), segments


def _elastic_lines(label, segments):
    """Print each segment's ranks: saves (gather, write, publish, bytes),
    restores, step walls, peaks."""
    for seg in segments:
        print(f"  {label} segment {seg['dims']}, steps {seg['start']}-"
              f"{seg['end'] - 1}: {len(seg['ranks'])} ranks in "
              f"{seg['wall_s']:.1f} s")
        for r, o in enumerate(seg["ranks"]):
            saves = "; ".join(
                f"step {s['step']}: gather {s['snapshot_s']:.3f} s, write "
                f"{s['write_s']:.3f} s, {s['bytes_written'] / 2**20:.1f} MiB"
                f", publish wait {s['publish_s']:.3f} s" for s in o["saves"])
            restore = (f"restore of step {o['restored_step']} "
                       f"{o['restore_s']:.3f} s (gather to check "
                       f"{o['restored_gather_s']:.3f} s); "
                       if o["restored_step"] else "")
            print(f"    rank {r}: {restore}saves: {saves or 'none'}; step "
                  f"walls {[round(w, 1) for w in o['walls_ms']]} ms; losses "
                  f"{[round(x, 5) for x in o['losses']]}; peak "
                  f"{o['peak'] / 2**30:.2f} GiB")


def _elastic_check(label, rep, segments, want_dims):
    """The report, the restored state's digests against the saved ones,
    the losses equal across each segment's ranks.  Returns the leaves'
    names (rank 0 of the last segment)."""
    first, last = segments
    check((rep.steps_done, rep.restarts) == (ELASTIC_STEPS, 1)
          and [(p.data, p.model) for p in rep.mesh_history] == want_dims,
          f"{label}: report {rep}")
    at = ELASTIC_CKPT_EVERY
    saved, restored = {}, {}
    for o in first["ranks"]:
        saved.update(o["saved"].get(at, {}))
    for o in last["ranks"]:
        check(o["restored_step"] == at, f"{label}: rank restored step "
              f"{o['restored_step']}, not {at}")
        restored.update(o["restored"])
    names = last["ranks"][0]["names"]
    check(len(saved) == len(names) and restored == saved,
          f"{label}: the state restored on {last['dims']} differs from the "
          f"state {first['dims']} saved at step {at} at leaves "
          f"{sorted(names[i] for i in saved if restored.get(i) != saved[i])}"
          f" ({len(saved)} saved, {len(restored)} restored, {len(names)} "
          f"leaves)")
    for seg in segments:
        for r, o in enumerate(seg["ranks"]):
            check(all(math.isfinite(x) for x in o["losses"])
                  and o["losses"] == seg["ranks"][0]["losses"],
                  f"{label}: rank {r} of {seg['dims']} losses {o['losses']}")
    return names


def phase_elastic(rt, device="cuda", smoke=False):
    """Phase 16 (the module docstring): (a) the elastic restart from
    (2, 2) onto (1, 2), uncompressed, against one device's run; (b)
    compressed, (2, 1) onto (1, 1).  Returns the narrow kernels' launches
    of (b), all ranks."""
    t0 = time.perf_counter()
    pygc.collect()
    clear_csr_caches(rt)
    print(f"phase 16: checkpoints of sharded state and the elastic re-mesh: "
          f"TrainSupervisor restarting {TRAIN_ARCH} (full width, "
          f"{SUPERVISED_LAYERS} layers) from (2, 2) onto (1, 2) and, "
          f"compressed, from (2, 1) onto (1, 1), on gloo ranks sharing the "
          f"card")
    base = dict(device=device, smoke=smoke, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ if not smoke else 16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as d:
        rep, segs = elastic_supervised(rt, base, ELASTIC_HOSTS,
                                       ELASTIC_MODEL, False,
                                       os.path.join(d, "a"))
        m = _elastic_modules()
        t = time.perf_counter()
        one = elastic_trainer(m, dict(base, compress=False), ELASTIC_STEPS,
                              None).fit()["losses"]
        one_s = time.perf_counter() - t
        crep, csegs = elastic_supervised(rt, base, ELASTIC_COMP_HOSTS,
                                         ELASTIC_COMP_MODEL, True,
                                         os.path.join(d, "b"))
        kept = {k: sorted(os.listdir(os.path.join(d, k))) for k in "ab"}
    # (a)
    _elastic_lines("(a)", segs)
    names = _elastic_check("phase 16 (a)", rep, segs, [(2, 2), (1, 2)])
    first, last = segs
    mesh_losses = (first["ranks"][0]["losses"][:ELASTIC_CKPT_EVERY]
                   + last["ranks"][0]["losses"])
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, one)]
    print(f"  (a) steps_done {rep.steps_done}, restarts {rep.restarts}, "
          f"meshes {[(p.data, p.model) for p in rep.mesh_history]}; the "
          f"state restored on (1, 2), gathered, bit-equal (sha256) to the "
          f"state (2, 2) gathered when it saved step {ELASTIC_CKPT_EVERY}, "
          f"all {len(names)} leaves (parameters, m, v, step); losses "
          f"{[round(x, 5) for x in mesh_losses]} against one device's "
          f"uninterrupted {[round(x, 5) for x in one]} ({one_s:.1f} s): "
          f"relative |d| {[f'{x:.2e}' for x in rel]} (tolerance 2^-8); "
          f"checkpoints kept {kept['a']}")
    check(len(rel) == ELASTIC_STEPS and max(rel) <= BF16_EPS,
          f"phase 16 (a): losses {mesh_losses} against one device's {one}")
    if device == "cuda":
        launched = {k: v for seg in segs for o in seg["ranks"]
                    for k, v in o["launches"].items() if v}
        check(not launched, f"phase 16 (a): uncompressed, yet {launched}")
    # (b)
    _elastic_lines("(b)", csegs)
    cnames = _elastic_check("phase 16 (b)", crep, csegs, [(2, 1), (1, 1)])
    n_comp = csegs[0]["ranks"][0]["n_comp"]
    n_err = sum(n.startswith("['err']") for n in cnames)
    check(n_err > 0, "phase 16 (b): no error-feedback state in the "
          "checkpoint")
    launches = dict.fromkeys(NARROW_KERNELS, 0)
    for seg in csegs:
        steps = seg["end"] - seg["start"]
        for r, o in enumerate(seg["ranks"]):
            for k in NARROW_KERNELS:
                launches[k] += o["launches"][k]
            check(device != "cuda" or (
                all(o["launches"][k] == n_comp * steps
                    for k in NARROW_KERNELS)
                and sum(o["launches"].values()) == 2 * n_comp * steps),
                  f"phase 16 (b): rank {r} of {seg['dims']} launches "
                  f"{({k: v for k, v in o['launches'].items() if v})}, not "
                  f"one narrow forward and transpose a compressed leaf "
                  f"({n_comp}) a step ({steps})")
            check(device != "cuda" or not o["plain"],
                  f"phase 16 (b): rank {r} plain versions {o['plain']}")
    print(f"  (b) steps_done {crep.steps_done}, restarts {crep.restarts}, "
          f"meshes {[(p.data, p.model) for p in crep.mesh_history]}; the "
          f"restored state bit-equal to the saved one at all {len(cnames)} "
          f"leaves, {n_err} of them the error-feedback state; one narrow "
          f"forward and one narrow transpose a compressed leaf ({n_comp}) a "
          f"step a rank, no plain version: {launches}; losses "
          f"{[round(x, 5) for x in csegs[0]['ranks'][0]['losses']]} then "
          f"{[round(x, 5) for x in csegs[1]['ranks'][0]['losses']]}; "
          f"checkpoints kept {kept['b']}")
    took = time.perf_counter() - t0
    print(f"  phase 16 took {took:.1f} s (budget {ELASTIC_BUDGET_S:.0f})")

    def seg_json(seg):
        return dict(dims=seg["dims"], start=seg["start"], end=seg["end"],
                    wall_s=seg["wall_s"], ranks=[dict(
                        {k: o[k] for k in ("losses", "walls_ms", "saves",
                                           "peak")},
                        restore_s=o["restore_s"] if o["restored_step"]
                        else None,
                        launches={k: v for k, v in o["launches"].items()
                                  if v}) for o in seg["ranks"]])
    print("elastic: " + json.dumps(dict(
        a=[seg_json(s) for s in segs], one_device=one, loss_rel=rel,
        b=[seg_json(s) for s in csegs], launches=launches, seconds=took)))
    if device == "cuda":
        check(took <= ELASTIC_BUDGET_S, f"phase 16 took {took:.1f} s, over "
              f"its {ELASTIC_BUDGET_S:.0f} s")
    clear_csr_caches(rt)
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the example twins (examples/torch_*.py) on the card.
# ---------------------------------------------------------------------------

# each twin's flags: its own full size; train_lm's 100m preset for
# EXAMPLE_LM_STEPS steps (the reference docstring's; see the module
# docstring), compressed at ratio 8
EXAMPLE_LM_STEPS = 300
EXAMPLES = (
    ("torch_quickstart", []),
    ("torch_least_squares", []),
    ("torch_randnla_tasks", []),
    ("torch_grass_attribution", ["--full"]),
    ("torch_train_lm", ["--preset", "100m", "--grad-compress", "8",
                        "--steps", str(EXAMPLE_LM_STEPS)]),
)
# the kernels each twin must launch (rows 1, 2, 4; 1; 1; 3, 5; 1n, 2n)
EXAMPLE_KERNELS = {
    "torch_quickstart": ("flashsketch_fwd", "flashsketch_transpose",
                         "blockrow_fwd"),
    "torch_least_squares": ("flashsketch_fwd",),
    "torch_randnla_tasks": ("flashsketch_fwd",),
    "torch_grass_attribution": ("flashsketch_fwd_gather",
                                "blockrow_fwd_gather"),
    "torch_train_lm": NARROW_KERNELS,
}
# the blockperm numbers each twin returns (``example_values``' labels),
# held on the card to the same twin's --device cpu run (relative):
# quickstart's plan and blockperm family's Gram errors, randnla_tasks'
# blockperm residual of each dataset
EXAMPLE_BLOCKPERM = {"torch_quickstart": ("plan", "blockperm"),
                     "torch_randnla_tasks": ("gaussian blockperm",
                                             "lowrank_noise blockperm",
                                             "llm_weights blockperm")}
EXAMPLE_REL_TOL = 1e-4
# at least twice the phase's slowest run: 77.7 s with 300 LM steps on an
# H100 80GB HBM3 at 700 W (71.0-92.6 ms a step)
EXAMPLES_BUDGET_S = 200.0
# the wrappers whose launches phase 17 holds to their plain versions
HELD_WRAPPERS = ("flashsketch_fwd", "flashsketch_transpose",
                 "flashsketch_fwd_gather", "blockrow_fwd",
                 "blockrow_fwd_gather")


def load_example(name):
    """``examples/<name>.py`` beside this script, as a fresh module."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(root, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_main(mod, argv):
    """``mod.main(argv)`` with its lines captured: (its return, lines)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
    finally:
        lines = buf.getvalue().splitlines()
    return out, lines


def example_values(name, out):
    """The numbers a twin's ``main`` returns, flat by label: quickstart's
    Gram errors, randnla_tasks' residuals as "<dataset> <direct|family>"."""
    if name == "torch_randnla_tasks":
        return {f"{ds} {key}": v for ds, row in out.items()
                for key, v in row.items()}
    return dict(out)


def held_plain(rt, name, plan, A, row_map=None):
    """The plain version of wrapper ``name`` on the inputs of one of its
    launches: the wrapper's CPU branch, run on the card's tensors."""
    fsk, ref = rt["fsk"], rt["ref"]
    x = fsk._stream(plan, A)
    if name == "flashsketch_fwd":
        return ref.flashsketch_ref(plan, x.to(torch.float32))
    if name == "flashsketch_transpose":
        full = dataclasses.replace(plan, d=plan.d_pad)
        return ref.flashsketch_transpose_ref(full, x.to(torch.float32))
    if name == "flashsketch_fwd_gather":
        return ref.flashsketch_ref(plan, ref.gather_rows(plan, x, row_map))
    if name == "blockrow_fwd_gather":
        x = ref.gather_rows(plan, x, row_map)
    return ref.blockrow_ref(plan, x.to(torch.float32))


class PlainHold:
    """While a twin runs, each ``HELD_WRAPPERS`` wrapper keeps its first
    launch of each (kernel, plan, n): its inputs and its output, cloned
    where they lie.  ``check`` then holds every kept output to its plain
    version on the same inputs (``_err``, phases 2 and 4's tolerance: the
    plan's exactness_atol x max|plain|).  ``close`` puts the wrappers back,
    the lowering's table of gathers too."""

    def __init__(self, rt):
        self.rt, self.kept = rt, {}
        fsk, table = rt["fsk"], rt["lowering"]._GATHER_KERNELS
        self._orig = {name: getattr(fsk, name) for name in HELD_WRAPPERS}
        self._table = dict(table)
        for name, fn in self._orig.items():
            setattr(fsk, name, self._wrap(name, fn))
        table.update(fwd=fsk.flashsketch_fwd_gather,
                     blockrow=fsk.blockrow_fwd_gather)

    def _wrap(self, name, fn):
        launches = self.rt["fsk"].LAUNCHES

        def held(plan, A, *args, **kwargs):
            before = dict(launches)
            out = fn(plan, A, *args, **kwargs)
            kernels = tuple(k for k, v in launches.items()
                            if v != before.get(k, 0))
            key = (name, kernels, plan, A.shape[1])
            if key not in self.kept:
                self.kept[key] = (A.clone(), [a.clone() for a in args],
                                  out.clone())
            return out
        return held

    def close(self):
        fsk = self.rt["fsk"]
        for name, fn in self._orig.items():
            setattr(fsk, name, fn)
        self.rt["lowering"]._GATHER_KERNELS.update(self._table)

    def check(self, twin):
        """Every kept launch against its plain version; fails the phase
        on a miss.  Returns {kernel: [cases, max_abs_err, worst
        err / max|plain|]} (the wrapper's name where the CPU launched
        none)."""
        out = {}
        for (name, kernels, plan, n), (A, args, got) in self.kept.items():
            want = held_plain(self.rt, name, plan, A, *args)
            err = _err(got, want, plan, f"phase 17 {twin}: {name} "
                       f"({'/'.join(kernels) or 'plain'}) at "
                       f"{plan.describe()}, n = {n}")
            scale = max(float(want.abs().max()), 1e-30)
            row = out.setdefault("/".join(kernels) or name, [0, 0.0, 0.0])
            row[0] += 1
            row[1], row[2] = max(row[1], err), max(row[2], err / scale)
        self.kept.clear()
        return out


def example_checks(name, out, cpu_out, lm_steps):
    """Each twin's own checks (least_squares' asserts ran in its main)."""
    if name in EXAMPLE_BLOCKPERM:
        values, cpu = example_values(name, out), example_values(name, cpu_out)
        check(values.keys() == cpu.keys() and all(
            math.isfinite(v) for v in values.values()),
              f"phase 17 {name}: values {values}, CPU {cpu}")
        rel = {k: abs(values[k] - cpu[k]) / abs(cpu[k])
               for k in EXAMPLE_BLOCKPERM[name]}
        print(f"  card against --device cpu, relative (the blockperm "
              f"lines, within {EXAMPLE_REL_TOL:g}): "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} }")
        for k, r in rel.items():
            check(r <= EXAMPLE_REL_TOL,
                  f"phase 17 {name}: {k}: {values[k]} on the card, "
                  f"{cpu[k]} on the CPU")
    elif name == "torch_grass_attribution":
        lds = {fam: r["lds"] for fam, r in out.items()}
        us = {fam: round(r["per_sample_us"], 3) for fam, r in out.items()}
        print(f"  LDS {lds}; per_sample_us on the card {us}")
        check(len(lds) == 4 and all(math.isfinite(v) for v in lds.values())
              and lds["blockperm"] > 0, f"phase 17 {name}: LDS {lds}")
    elif name == "torch_train_lm":
        losses = out["losses"]
        check(len(losses) == lm_steps
              and all(math.isfinite(x) for x in losses),
              f"phase 17 {name}: losses {losses}")
        l0, l1 = statistics.fmean(losses[:10]), statistics.fmean(losses[-10:])
        print(f"  losses: first ten {l0:.4f}, last ten {l1:.4f} (drop "
              f"{l0 - l1:.4f}); the reference's 'structure learned' (a drop "
              f"> 0.5) at {lm_steps} steps: {l1 < l0 - 0.5}; fit "
              f"{out['wall_s']:.1f} s, {1e3 * out['wall_s'] / len(losses):.1f}"
              f" ms a step")
        check(l1 < l0, f"phase 17 {name}: the last ten steps' mean loss "
              f"{l1} not below the first ten's {l0}")


def phase_examples(rt, device="cuda", smoke=False):
    """Phase 17 (the module docstring): each example twin's ``main`` at its
    own full size on the card.  Returns the launches of all five.  With
    ``smoke`` (the code on the CPU: ``device="cpu"``) grass_attribution
    runs at its default size and train_lm's tiny preset for 12 steps, and
    the launch checks are skipped."""
    t0 = time.perf_counter()
    pygc.collect()
    clear_csr_caches(rt)
    fsk = rt["fsk"]
    print("phase 17: the example twins (examples/torch_*.py) on the card, "
          "each main() at its own full size")
    mods = {name: load_example(name) for name, _ in EXAMPLES}
    cpu = {}
    for name in EXAMPLE_BLOCKPERM:
        t = time.perf_counter()
        cpu[name], _ = example_main(mods[name], ["--device", "cpu"])
        print(f"  {name} --device cpu (the checks' reference): "
              f"{time.perf_counter() - t:.1f} s")
    total, seconds, held = {}, {}, {}
    for name, argv in EXAMPLES:
        if smoke:
            argv = {"torch_grass_attribution": [],
                    "torch_train_lm": ["--steps", "12"]}.get(name, argv)
        argv = argv + ["--device", device]
        calls = {}
        restore_plain = spy_plain(rt, calls)
        hold = PlainHold(rt)
        fsk.reset_launch_counts()
        t = time.perf_counter()
        try:
            out, lines = example_main(mods[name], argv)
            _sync(device)
        except AssertionError as exc:
            raise SmokeFailure(f"phase 17 {name}: the example's own assert "
                               f"failed: {exc}") from exc
        finally:
            hold.close()
            restore_plain()
        seconds[name] = time.perf_counter() - t
        launches = {k: v for k, v in fsk.LAUNCHES.items() if v}
        print(f"  {name} {' '.join(argv)}: {seconds[name]:.1f} s")
        for ln in lines:
            print(f"    {ln}")
        print(f"  launch counts: {launches}; plain-version calls: "
              f"{calls or 0}")
        if device == "cuda":
            for k in EXAMPLE_KERNELS[name]:
                check(launches.get(k, 0) >= 1,
                      f"phase 17 {name}: {k} never launched ({launches})")
            check(not calls, f"phase 17 {name}: a plain version ran: "
                  f"{calls}")
        kept = {k for key in hold.kept for k in key[1]}
        held[name] = hold.check(name)
        print(f"  held to the plain versions on the same inputs, the first "
              f"launch of each (kernel, plan, n): {held[name]} (kernel: "
              f"[cases, max_abs_err, worst err / max|plain|])")
        for k in launches:
            check(k in kept, f"phase 17 {name}: no launch of {k} held to "
                  f"its plain version (held: {sorted(kept)})")
        example_checks(name, out, cpu.get(name),
                       12 if smoke else EXAMPLE_LM_STEPS)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del out
        pygc.collect()
        clear_csr_caches(rt)
    took = time.perf_counter() - t0
    print(f"  phase 17 took {took:.1f} s (budget {EXAMPLES_BUDGET_S:.0f})")
    print("examples: " + json.dumps(dict(
        seconds={k: round(v, 3) for k, v in seconds.items()},
        launches=total, held=held, lm_steps=EXAMPLE_LM_STEPS,
        total_s=round(took, 3))))
    if device == "cuda":
        check(took <= EXAMPLES_BUDGET_S, f"phase 17 took {took:.1f} s, over "
              f"its {EXAMPLES_BUDGET_S:.0f} s")
    return total


class PortMissing(Exception):
    pass


def load_runtime():
    """The port's modules this script drives, by name (``rt``); raises
    PortMissing where the port is not beside this script."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    try:
        from benchmarks import torch_pareto_bench as pareto
        from repro_torch import solvers
        from repro_torch.attribution import grass, lds, mlp
        from repro_torch.configs.flashsketch_paper import (CONFIG, GRASS,
                                                           SOLVER_PRESETS,
                                                           solver_sketch_rows)
        from repro_torch import distributed
        from repro_torch.core import blockperm, hashing, variants, wiring
        from repro_torch.distributed.sharded_apply import _fold_scale_truncate
        from repro_torch.distributed.spawn import run_ranks
        from repro_torch.kernels import build, lowering, ops, ref, tune
        from repro_torch.kernels import flashsketch as fsk
        from repro_torch.health import inject
        from repro_torch.health import report as health_report
        from repro_torch.roofline import hw, sketch_model
        from repro_torch import serving
        from repro_torch.launch import serve as serve_cli
        from benchmarks import torch_serve_bench as serve_bench
        from repro_torch import tree as tree_mod
        from repro_torch.configs.base import smoke_config
        from repro_torch.configs.registry import get_arch
        from repro_torch.core import precision
        from repro_torch.data import pipeline
        from repro_torch.models import factory, lm
        from repro_torch.optim import adamw
        from repro_torch.optim import grad_compress as gc
        from repro_torch.train import train_step, trainer
        from repro_torch.launch import generate
        from repro_torch.configs import base as config_base
        from repro_torch.configs.registry import ARCHS
        from repro_torch.launch import mesh
        from repro_torch.sharding import partition
        from repro_torch.train import checkpoint, fault_tolerance
        from repro_torch.launch import dryrun
        from repro_torch.roofline import analysis, hlo_parse
        from repro_torch.sharding import spmd
    except ImportError as exc:
        raise PortMissing(str(exc)) from exc
    return dict(solvers=solvers, presets=SOLVER_PRESETS, blockperm=blockperm,
                wiring=wiring, hashing=hashing, ops=ops, ref=ref, fsk=fsk,
                lowering=lowering, grass=grass, mlp=mlp, lds=lds,
                grass_cfg=GRASS, variants=variants, pareto=pareto,
                dist=distributed, fold=_fold_scale_truncate,
                run_ranks=run_ranks, tune=tune, hw=hw,
                sketch_model=sketch_model, inject=inject, report=health_report,
                solver_sketch_rows=solver_sketch_rows, serving=serving,
                serve_cli=serve_cli, serve_bench=serve_bench,
                tree=tree_mod, smoke_config=smoke_config, get_arch=get_arch,
                precision=precision, pipeline=pipeline, lm=lm, adamw=adamw,
                gc=gc, train_step=train_step, trainer=trainer,
                factory=factory, build=build, paper_config=CONFIG,
                generate=generate, config_base=config_base, archs=ARCHS,
                mesh=mesh, partition=partition, checkpoint=checkpoint,
                fault_tolerance=fault_tolerance, dryrun=dryrun,
                analysis=analysis, hlo_parse=hlo_parse, spmd=spmd)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        rt = load_runtime()
    except PortMissing as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    build, blockperm = rt["build"], rt["blockperm"]
    CONFIG, SOLVER_PRESETS = rt["paper_config"], rt["presets"]
    solver_sketch_rows = rt["solver_sketch_rows"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    t = time.perf_counter()
    build.build()
    print(f"phase 1: built {', '.join(build.SOURCES)} into "
          f"{build.BUILD_DIR} in {time.perf_counter() - t:.1f} s")

    d = CONFIG.d_values[1]
    n = CONFIG.n_for(d)
    k = solver_sketch_rows(n, SOLVER_PRESETS["default"].sampling_factor)
    main_plan = blockperm.make_plan(d, k, kappa=4, s=2, seed=0)
    print(f"main plan: {main_plan.describe()}")
    d_big = CONFIG.d_values[-1]
    big = (d_big, CONFIG.n_for(d_big),
           solver_sketch_rows(CONFIG.n_for(d_big),
                              SOLVER_PRESETS["default"].sampling_factor))
    try:
        errs = timed("phase 2", phase_kernels, rt, main_plan, n)
        errs.update(timed("phase 2, fused transpose routes",
                          phase_transpose_routes, rt, main_plan, n))
        timed("phase 2, row-split forwards", phase_fwd_splits, rt,
              main_plan, n)
        errs.update(timed("phase 2, GraSS kernels", phase_grass_kernels, rt))
        errs.update(timed("phase 2, v1 and global kernels",
                          phase_family_kernels, rt, main_plan, n))
        errs.update(timed("phase 2, partial kernels", phase_partial_kernels,
                          rt, main_plan, n))
        timed("phase 2, narrow kernels", phase_narrow_kernels, rt, main_plan)
        launches, _ = timed("phase 3", phase_main_path, rt, main_plan, d, n,
                            1e4)
        rows = timed("phase 4", phase_timing, rt, main_plan, n, launches,
                     errs)
        rows += timed("phase 4, GraSS kernels", phase_grass_timing, rt, errs)
        rows += timed("phase 4, v1 and global kernels", phase_family_timing,
                      rt, main_plan, n, errs)
        rows += timed("phase 4, partial kernels", phase_partial_timing, rt,
                      main_plan, n, errs)
        grass_launches, grass_state = timed("phase 5", phase_grass, rt)
        family_launches = timed("phase 6", phase_families, rt, main_plan)
        dist_launches = timed("phase 7", phase_distributed, rt, main_plan, n,
                              1e4, big, grass_state)
        for row in rows:
            if row["name"] in GRASS_KERNELS:
                row["launches"] = grass_launches[row["name"]]
            if row["name"] in V1_KERNELS + GLOBAL_KERNELS + L2_KERNELS:
                row["launches"] = family_launches[row["name"]]
            if row["name"] in PARTIAL_KERNELS:
                row["launches"] = dist_launches[row["name"]]
        tuned = timed("phase 8, tuner", phase_tuner, rt, main_plan, n)
        timed("phase 8, cost model", phase_cost_model, rt, main_plan, n,
              rows)
        timed("phase 8, health", phase_health, rt, main_plan, d, n, 1e4)
        served = timed("phase 9", phase_serving, rt, main_plan, d, 1e4)
        for row in rows:
            if row["name"] == "flashsketch_fwd":
                row["launches"] += served["flashsketch_fwd"]
        trained, n1 = timed("phase 10", phase_training, rt)
        families = timed("phase 11", phase_families_train, rt)
        timed("phase 12", phase_decode, rt)
        pod = timed("phase 13", phase_pod, rt)
        timed("phase 14", phase_dryrun, rt)
        sharded = timed("phase 15", phase_sharded, rt)
        elastic = timed("phase 16", phase_elastic, rt)
        examples = timed("phase 17", phase_examples, rt)
        for row in rows:
            row["launches"] += examples.get(row["name"], 0)
        rows += narrow_rows(n1, {k: trained[k] + families[k] + pod[k]
                                 + sharded[k] + elastic[k]
                                 + examples.get(k, 0)
                                 for k in NARROW_KERNELS})
        print("tuned: " + json.dumps({
            f"{v}/{dt}": dict(rule=[r["tn"], r["row_splits"],
                                    round(r["time_us"], 2),
                                    round(r["device_us"], 2)],
                              winner=[w.tn, w.row_splits,
                                      round(w.time_us, 2), round(wd, 2)])
            for (v, dt), (w, r, _, wd) in tuned.items()}))
        torch.cuda.synchronize()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print("kernels: " + "; ".join(
        f"{r['name']} launches={r['launches']} "
        f"max_abs_err={r['max_abs_err']:.3e}" for r in rows))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def stop_rank_servers() -> None:
    """The fork server and the resource tracker of ``run_ranks`` stopped,
    so that no process outlives the script."""
    spawn = sys.modules.get("repro_torch.distributed.spawn")
    if spawn is not None:
        spawn.stop_servers()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_rank_servers()
    sys.exit(code)
