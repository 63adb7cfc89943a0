"""Rank functions for ``tests/test_torch_sharded_train.py`` and
``tests/test_torch_sharded_decode.py``, run by
``repro_torch.distributed.spawn.run_ranks`` in processes of their own.

They import only the port (not JAX), so a spawned rank starts quickly.
Every rank builds the same smoke-config model from one seed, on one torch
thread, runs the single-device step or decode itself, then the same over
DTensors on a ``("data", "model")`` mesh of the gloo group, and sends back
numbers (numpy arrays and floats): each rank's own, so the test can hold
the ranks against each other.
"""
import contextlib
import dataclasses
import hashlib

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core.blockperm import make_plan
from repro_torch.kernels import flashsketch as fsk
from repro_torch.launch import generate as gen_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.factory import extra_inputs_concrete, make_train_batch
from repro_torch.models.lm import params_from_reference
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd
from repro_torch.train import train_step as ts

B, S = 4, 16                     # the batch of the sharded train steps
DECODE_B, DECODE_S = 4, 8        # decode: 8 positions
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
COMPRESS = dict(ratio=4, min_bucket=256)
# the archs whose decode test also generates over the mesh
GENERATE_ARCHS = ("qwen3-0.6b", "zamba2-7b")
AXES = ("data", "model")


def rank_of(rank, world):
    return rank


def _mesh(dims):
    return mesh_lib.make_mesh(dims, AXES)


@contextlib.contextmanager
def recorded_logits(into):
    """Every decode step's (B, vocab) logits, gathered, appended to
    ``into`` (``generate`` calls ``train_step.decode_step``, wrapped here
    for the context's duration)."""
    step = ts.decode_step

    def recording(model, *args):
        logits, state = step(model, *args)
        into.append(spmd.full_tensor(logits)[:, 0, :model.cfg.vocab_size])
        return logits, state
    ts.decode_step = recording
    try:
        yield
    finally:
        ts.decode_step = step


class _Spy:
    """Records the gradients that reach ``adamw.apply_updates`` and the
    inputs and outputs of ``grad_compress.compress_gradients`` (the step
    reads both as module attributes), as ordinary tensors."""

    def __init__(self):
        self.grads = self.compressed_in = self.compressed_out = None

    def __enter__(self):
        self._apply, self._compress = adamw.apply_updates, \
            gc.compress_gradients

        def apply(params, grads, state, cfg, lr=None):
            self.grads = _full_tree(grads)
            return self._apply(params, grads, state, cfg, lr)

        def compress(cfg, grads, err, *args, **kwargs):
            out = self._compress(cfg, grads, err, *args, **kwargs)
            self.compressed_in = grads
            self.compressed_out = out
            return out
        adamw.apply_updates, gc.compress_gradients = apply, compress
        return self

    def __exit__(self, *exc):
        adamw.apply_updates, gc.compress_gradients = self._apply, \
            self._compress


def _full(tree):
    """A tree of DTensors (or tensors) as ordinary tensors, gathered."""
    return tr.tree_map(lambda x: spmd.full_tensor(x).detach().clone(), tree)


def _full_tree(tree):
    """The same, flat: leaf path (``keystr``) → tensor."""
    return {tr.keystr(path): x for path, x in
            tr.leaves_with_path(_full(tree))}


def _one_step(step_fn, params, opt, err, batch):
    with _Spy() as spy:
        _, _, _, metrics = step_fn(params, opt, err, batch)
    return float(metrics["loss"]), spy, _full_tree(params)


def _single_and_sharded(cfg, make_params, batch, meshes):
    """One step on one device, then one on each mesh, from the same
    initial parameters.  Returns the losses and, per leaf, max|Δg|,
    max|g| and max|Δp| against the single-device step."""
    step_fn, _ = ts.build_train_step(cfg, OPT)
    params = make_params()
    loss1, spy1, p1 = _one_step(step_fn, params, adamw.init_state(params, OPT),
                                {}, batch)
    out = {"loss": loss1, "meshes": {}}
    for dims in meshes:
        mesh = _mesh(dims)
        params = make_params()
        sp, so, _ = ts.shard_train_state(cfg, mesh, params,
                                         adamw.init_state(params, OPT))
        sb = ts.shard_batch(cfg, mesh, batch)
        with mesh, pt.activate(ts.sharding_ctx_for(mesh, cfg)):
            loss2, spy2, p2 = _one_step(step_fn, sp, so, {}, sb)
        leaves = {k: (float((spy1.grads[k] - spy2.grads[k]).abs().max()),
                      float(spy1.grads[k].abs().max()),
                      float((p1[k].float() - p2[k].float()).abs().max()))
                  for k in p1}
        out["meshes"][dims] = {"loss": loss2, "leaves": leaves}
    return out


def family_rank(rank, world, arch, meshes):
    """The train step of ``arch``'s smoke config on one device and on each
    mesh of ``meshes``."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS[arch])
    model = ts.build_train_step(cfg, OPT)[1]
    batch = make_train_batch(cfg, B, S, seed=0, device="cpu")
    return _single_and_sharded(cfg, lambda: model.init(0, "cpu"), batch,
                               meshes)


def reference_rank(rank, world, params_np, batch_np, dims):
    """internlm2-1.8b's step on ``dims`` from the reference's weights and
    batch: the loss and the parameters after the step (numpy)."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    step_fn, _ = ts.build_train_step(cfg, OPT)
    params = params_from_reference(cfg, params_np, "cpu").params
    mesh = _mesh(dims)
    sp, so, _ = ts.shard_train_state(cfg, mesh, params,
                                     adamw.init_state(params, OPT))
    sb = ts.shard_batch(cfg, mesh, {k: torch.from_numpy(v)
                                    for k, v in batch_np.items()})
    with mesh, pt.activate(ts.sharding_ctx_for(mesh, cfg)):
        _, _, _, metrics = step_fn(sp, so, {}, sb)
    return {"loss": float(metrics["loss"]),
            "params": {k: v.float().numpy() for k, v in _full_tree(sp).items()}}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def compressed_rank(rank, world, arch, dims):
    """A compressed train step over ``dims``: ĝ of every leaf (digests, to
    be equal across ranks), ĝ and the error state against the
    single-device compression of the gathered gradient; then the error
    cases: every kernel wrapper refuses a DTensor, AdamW's global norm
    over the DTensor gradients against the gathered ones'."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS[arch])
    comp = gc.CompressConfig(**COMPRESS)
    step_fn, model = ts.build_train_step(cfg, OPT, comp)
    params = model.init(0, "cpu")
    mesh = _mesh(dims)
    sp, so, se = ts.shard_train_state(cfg, mesh, params,
                                      adamw.init_state(params, OPT),
                                      gc.init_error_state(params))
    sb = ts.shard_batch(cfg, mesh, make_train_batch(cfg, B, S, seed=0,
                                                    device="cpu"))
    ctx = ts.sharding_ctx_for(mesh, cfg)
    with _Spy() as spy, mesh, pt.activate(ctx):
        step_fn(sp, so, se, sb)
    grads = _full(spy.compressed_in)
    g_in = _full_tree(grads)
    g_hat, err = (_full_tree(t) for t in spy.compressed_out)
    want_hat, want_err = (_full_tree(t) for t in gc.compress_gradients(
        comp, grads, tr.tree_map(torch.zeros_like, grads), step=0))
    compressed = [k for k, v in g_in.items()
                  if gc.plan_for_leaf(comp, v.numel()) is not None]
    sharded = {tr.keystr(path): any(p.is_shard() for p in g.placements)
               for path, g in tr.leaves_with_path(spy.compressed_out[0])}
    out = {"digests": {k: _digest(v) for k, v in g_hat.items()},
           "equal_single": {k: torch.equal(g_hat[k], want_hat[k])
                            and torch.equal(err[k], want_err[k])
                            for k in g_hat},
           "compressed": compressed, "sharded": sharded}
    # the error cases
    plan = make_plan(512, 64, kappa=2, s=2, seed=0)
    from torch.distributed.tensor import Replicate
    dm = mesh.device_mesh_on("cpu")
    a = pt.place(torch.ones(plan.d_pad, 1), dm, (Replicate(), Replicate()))
    y = pt.place(torch.ones(plan.k_pad, 1), dm, (Replicate(), Replicate()))
    rows = torch.arange(plan.d, dtype=torch.int64)
    calls = {
        "flashsketch_fwd": lambda: fsk.flashsketch_fwd(plan, a),
        "flashsketch_transpose": lambda: fsk.flashsketch_transpose(plan, y),
        "flashsketch_fwd_gather": lambda: fsk.flashsketch_fwd_gather(
            plan, a, rows),
        "blockrow_fwd": lambda: fsk.blockrow_fwd(plan, a),
        "blockrow_fwd_gather": lambda: fsk.blockrow_fwd_gather(plan, a,
                                                               rows),
        "flashsketch_partial": lambda: fsk.flashsketch_partial(
            plan, a, torch.zeros(1, plan.kappa, dtype=torch.int32)),
        "flashsketch_fwd_v1": lambda: fsk.flashsketch_fwd_v1(plan, a),
        "flashsketch_transpose_v1": lambda: fsk.flashsketch_transpose_v1(
            plan, y),
        "blockrow_fwd_v1": lambda: fsk.blockrow_fwd_v1(plan, a),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = "ran"
        except TypeError as e:
            refused[name] = str(e)
    out["refused"] = refused
    with spmd.propagation(ctx):
        out["norm_sharded"] = float(spmd.full_tensor(
            adamw.global_norm(spy.compressed_in)))
    out["norm_single"] = float(adamw.global_norm(grads))
    return out


def decode_rank(rank, world, arch, meshes):
    """``DECODE_S`` decode positions of ``arch``'s smoke config on one
    device, then over each mesh (the serve step over DTensors): the
    largest logit difference at each position; then, for
    ``GENERATE_ARCHS``, greedy generation over the first mesh against one
    device's (``launch.generate``)."""
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS[arch])
    serve, model = ts.build_serve_step(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_S),
                         generator=gen, dtype=torch.int32)
    extra = extra_inputs_concrete(cfg, DECODE_B, DECODE_S, gen,
                                  device="cpu")
    state = model.init_decode_state(params, DECODE_B, DECODE_S, extra)
    want = []
    for pos in range(DECODE_S):
        logits, state = serve(params, state, toks[:, pos:pos + 1], pos)
        want.append(logits.clone())
    out = {"scale": max(float(w.abs().max()) for w in want), "meshes": {}}
    for dims in meshes:
        mesh = _mesh(dims)
        ctx = ts.sharding_ctx_for(mesh, cfg)
        sp = ts.shard_params(cfg, mesh, params)
        st = ts.shard_decode_state(cfg, mesh, model.init_decode_state(
            params, DECODE_B, DECODE_S, extra))
        errs = []
        with mesh, pt.activate(ctx):
            for pos in range(DECODE_S):
                logits, st = serve(sp, st, toks[:, pos:pos + 1], pos)
                errs.append(float((spmd.full_tensor(logits)
                                   - want[pos]).abs().max()))
        out["meshes"][dims] = errs
    if arch not in GENERATE_ARCHS:
        return out
    mesh = _mesh(meshes[0])
    prompt, n_gen = toks[:, :4], DECODE_S - 4
    want, got = [], []
    with recorded_logits(want):
        one, _ = gen_lib.generate(model, params, prompt, n_gen, extra)
    sp = ts.shard_params(cfg, mesh, params)
    st = ts.shard_decode_state(cfg, mesh, model.init_decode_state(
        params, DECODE_B, DECODE_S, extra))
    with mesh, pt.activate(ts.sharding_ctx_for(mesh, cfg)), \
            recorded_logits(got):
        sharded, _ = gen_lib.generate(model, sp, prompt, n_gen, extra,
                                      state=st)
    out["generate_equal"] = torch.equal(one, sharded)
    out["generate_logits"] = (len(want), len(got), max(
        float((w - g).abs().max()) for w, g in zip(want, got)))
    return out


def bf16_decode_rank(rank, world, arch, meshes):
    """``DECODE_S`` decode positions of ``arch``'s smoke config with bf16
    parameters: on one device, on one device in f32 from the same weights
    (the truth), and over each mesh; the largest logit difference of one
    device's bf16 decode from the truth, and of each mesh's from the truth
    and from one device's bf16 decode."""
    torch.set_num_threads(1)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]),
                              param_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    serve, model = ts.build_serve_step(cfg)
    serve32, model32 = ts.build_serve_step(cfg32)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_S),
                         generator=gen, dtype=torch.int32)

    def run(step, mdl, prm, mesh=None):
        st = mdl.init_decode_state(prm, DECODE_B, DECODE_S, {})
        ctx = contextlib.ExitStack()
        if mesh is not None:
            prm = ts.shard_params(cfg, mesh, prm)
            st = ts.shard_decode_state(cfg, mesh, st)
            ctx.enter_context(mesh)
            ctx.enter_context(pt.activate(ts.sharding_ctx_for(mesh, cfg)))
        out = []
        with ctx:
            for pos in range(DECODE_S):
                logits, st = step(prm, st, toks[:, pos:pos + 1], pos)
                out.append(spmd.full_tensor(logits).float())
        return torch.stack(out)
    one = run(serve, model, params)
    truth = run(serve32, model32,
                tr.tree_map(lambda p: p.detach().float(), params))
    out = {"one": float((one - truth).abs().max()), "meshes": {}}
    for dims in meshes:
        got = run(serve, model, params, _mesh(dims))
        out["meshes"][dims] = (float((got - truth).abs().max()),
                               float((got - one).abs().max()))
    return out


def faithful_rank(rank, world, arch, batch, seq, dims):
    """The real train step of ``arch``'s smoke config over ``dims`` at
    ``batch`` × ``seq`` (the dry-run test's cell): the matrix-product
    flops that ``FlopCounterMode`` counts on this rank and the collectives
    that ``CommDebugMode`` counts, by op name."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    torch.set_num_threads(1)
    cfg = smoke_config(ARCHS[arch])
    opt = adamw.AdamWConfig(state_dtype=cfg.optstate_dtype)
    step_fn, model = ts.build_train_step(cfg, opt)
    params = model.init(0, "cpu")
    mesh = _mesh(dims)
    sp, so, _ = ts.shard_train_state(cfg, mesh, params,
                                     adamw.init_state(params, opt))
    sb = ts.shard_batch(cfg, mesh, make_train_batch(cfg, batch, seq, seed=0,
                                                    device="cpu"))
    flops, comm = FlopCounterMode(display=False), CommDebugMode()
    # the step's metrics read on the host (partial sums: one all-reduce
    # a mesh axis that holds them partial), which the dry-run leaves out
    read, reads = spmd.full_tensor, []

    def counted(x):
        reads.append(sum(p.is_partial() for p in x.placements)
                     if pt.is_dtensor(x) else 0)
        return read(x)
    spmd.full_tensor = counted
    try:
        with mesh, pt.activate(ts.sharding_ctx_for(mesh, cfg)), flops, comm:
            step_fn(sp, so, {}, sb)
    finally:
        spmd.full_tensor = read
    return {"flops": float(flops.get_total_flops()), "metric_reduces":
            sum(reads),
            "by_op": {str(k): float(v) for k, v in
                      flops.get_flop_counts().get("Global", {}).items()},
            "comm": {str(k): int(v) for k, v in
                     comm.get_comm_counts().items()}}


def collectives_rank(rank, world):
    """``spmd``'s built collectives against the functional ones they
    replace, on this rank's tensors (drawn from its rank), along each axis
    of a (2, 2) CPU mesh: whether each case is the same bits; and whether
    ``gloo_collectives`` replaced the functional all-reduce inside and
    restored it after."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils as cu
    torch.set_num_threads(1)
    dm = _mesh((2, 2)).device_mesh_on("cpu")
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(4, 6, generator=gen)
    cases = {}
    for d in range(dm.ndim):
        group = (dm, d)
        for op in ("sum", "avg", "max"):
            cases[f"all_reduce {op} axis {d}"] = torch.equal(
                spmd.gloo_all_reduce(x, op, group),
                funcol.all_reduce(x, op, group))
        for dim in (0, 1):
            cases[f"all_gather dim {dim} axis {d}"] = torch.equal(
                spmd.gloo_all_gather(x, dim, group),
                funcol.all_gather_tensor(x, dim, group))
        for op in ("sum", "avg"):
            cases[f"reduce_scatter {op} axis {d}"] = torch.equal(
                spmd.gloo_reduce_scatter(x, op, 0, group),
                funcol.reduce_scatter_tensor(x, op, 0, group))
        y = torch.randn(3, 5, generator=gen)          # 5 splits unevenly
        cases[f"alltoall axis {d}"] = torch.equal(
            spmd.gloo_alltoall(y, 0, 1, dm, d),
            cu.shard_dim_alltoall(y, 0, 1, dm, d))
    before = funcol.all_reduce
    with spmd.gloo_collectives():
        inside = funcol.all_reduce is not before
    return {"cases": cases, "patched_inside": inside,
            "restored": funcol.all_reduce is before,
            "refusals": _refusals(dm)}


def _refusals(dm):
    """What ``spmd`` takes for DTensor's refusal of an op, and what it
    does then, on a (4, 6) DTensor whose columns the model axis shards:
    its ``view(4, 3, 2)`` (3 columns a piece do not split over 2 devices)
    refused by DTensor's view rule and, in ``propagation``'s mode, the
    columns gathered first; an error of the op itself (a Cholesky
    factor of a non-square matrix) raised through the mode as it is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    full = torch.arange(24.0).reshape(4, 6)
    x = distribute_tensor(full, dm, [Replicate(), Shard(1)])
    out = {}
    try:
        x.view(4, 3, 2)
        out["view refused"] = False
    except RuntimeError as err:
        out["view refused"] = spmd._propagation_refused(err)
    with spmd._Partitioned():
        y = x.view(4, 3, 2)
    out["view gathered"] = torch.equal(y.full_tensor(), full.view(4, 3, 2))
    try:
        with spmd._Partitioned():
            torch.linalg.cholesky(x)
        out["op's error raised"] = False
    except RuntimeError as err:
        out["op's error raised"] = not spmd._propagation_refused(err)
    out["memory, collective not refusals"] = not any(
        spmd._propagation_refused(e) for e in (
            torch.OutOfMemoryError("out of memory"),
            torch.distributed.DistError("gloo")))
    return out
