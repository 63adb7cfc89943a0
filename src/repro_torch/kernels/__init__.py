"""Hand-written CUDA kernels for the sketch apply, and their surroundings
(port of ``repro.kernels``).

  flashsketch.py — the kernel wrappers (forward, transpose, gather-fused
                   forward, FLASHBLOCKROW and its gather, the global
                   families behind the first three, the three v1
                   kernels), their launch counters and geometry, wiring
                   tables and the streaming cast
  csrc/          — the CUDA C++ sources for sm_90a
  build.py       — nvcc build at first use into kernels/_build/, ctypes load
  lowering.py    — lower(plan, spec) / execute / explain: every launch
                   decision in one record
  ops.py         — sketch_apply / sketch_apply_t (autograd Functions,
                   row_index= gather and scatter), blockrow_apply,
                   sketch_apply_batched, sketch_vectors, sketch_qr,
                   triangular_factor
  ref.py         — the plain PyTorch versions (CPU path, kernel reference)
"""
