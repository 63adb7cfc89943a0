"""The port's training substrate (``repro_torch.{data,optim,train}``,
``launch/train.py``) against the JAX package's, on the CPU.

Inputs come from numpy seeds and the reference's weights are carried
across (``params_from_reference``).  Tolerances: batches bit for bit;
AdamW within 1e-6 (the same f32 operations, the schedule's cosine and the
bias corrections' powers may differ in the last bit); the sketched
compression within the f32 policy's ``exactness_atol`` × max|ĝ| (the
plain versions sum in another order than the reference's); a 3-step
compressed train step's losses within 1e-4 relative (three steps of f32
products summed in another order); plans and checkpoints exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.data import pipeline as jdp
from repro.models.lm import DecoderLM as JDecoderLM
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.core import precision
from repro_torch.core.blockperm import make_plan
from repro_torch.data import pipeline as dp
from repro_torch.kernels import flashsketch as fsk
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import params_from_reference
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig

ATOL32 = precision.POLICIES["float32"].exactness_atol



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs this file beside other workers,
    and the plain versions' large elementwise passes slow down many times
    over when every worker's threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _ref_tree(name="qwen3-0.6b", seed=0, **kw):
    cfg = dataclasses.replace(jsmoke_config(JARCHS[name]), **kw)
    params = JDecoderLM(cfg).init(jax.random.PRNGKey(seed))
    return cfg, jax.tree.map(np.asarray, params)


def _torch_tree(tree_np):
    return tr.tree_map(tr.from_numpy, tree_np)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _random_like(tree_np, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        tree_np)


def _assert_trees_close(got, want, atol, rtol=0.0):
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tr.leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [tr.keystr(p) for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("vocab,batch,seq,seed,step,hosts", [
    (97, 8, 16, 3, 5, 1), (97, 8, 16, 3, 5, 4), (512, 4, 32, 0, 0, 1),
    (151_936, 4, 128, 0, 11, 1)])
def test_make_batch_is_the_reference_s(vocab, batch, seq, seed, step, hosts):
    cfg = dp.DataConfig(vocab_size=vocab, global_batch=batch, seq_len=seq,
                        seed=seed)
    jcfg = jdp.DataConfig(vocab_size=vocab, global_batch=batch, seq_len=seq,
                          seed=seed)
    for h in range(hosts):
        got = dp.make_batch(cfg, step, host_id=h, n_hosts=hosts)
        want = jdp.make_batch(jcfg, step, host_id=h, n_hosts=hosts)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    b = dp.make_batch(cfg, step)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_prefetcher_is_the_reference_s():
    cfg = dp.DataConfig(vocab_size=97, global_batch=4, seq_len=8)
    jcfg = jdp.DataConfig(vocab_size=97, global_batch=4, seq_len=8)
    pf = dp.Prefetcher(cfg, start_step=2)
    try:
        for want_step in (2, 3, 4):
            step, batch = next(pf)
            assert step == want_step
            np.testing.assert_array_equal(
                batch["tokens"], jdp.make_batch(jcfg, want_step)["tokens"])
    finally:
        pf.close()


# ----------------------------------------------------------------- optimizer

def test_apply_updates_matches_reference():
    """Three AdamW steps with decay on the smoke qwen3-0.6b tree: the
    stacked ln1/ln2 (2-D) decay, final_norm (1-D) does not."""
    _, p_np = _ref_tree(seed=1)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jupdate = jax.jit(lambda p, g, st: jadamw.apply_updates(p, g, st, jopt))
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jadamw.init_state(jp, jopt)
    tp = _torch_tree(p_np)
    tstate = adamw.init_state(tp, opt)
    for t in range(3):
        g_np = _random_like(p_np, 10 + t, scale=0.5)
        jp, jstate, jm = jupdate(jp, jax.tree.map(jnp.asarray, g_np), jstate)
        tp, tstate, tm = adamw.apply_updates(tp, _torch_tree(g_np), tstate,
                                             opt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    _assert_trees_close(tp, jp, atol=1e-6)
    _assert_trees_close(tstate["m"], jstate["m"], atol=1e-6)
    _assert_trees_close(tstate["v"], jstate["v"], atol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    # decay reached the stacked norms: they moved off 1 beyond Adam's step
    assert not torch.equal(tp["blocks"]["ln1"], torch.ones_like(
        tp["blocks"]["ln1"]))


@pytest.mark.parametrize("step", [0, 3, 99, 150, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    jcfg = jadamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    np.testing.assert_allclose(
        float(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))),
        float(jadamw.schedule(jcfg, jnp.int32(step))), rtol=1e-6)


def test_adamw_reduces_quadratic_and_keeps_bf16_states():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=100, clip_norm=0.0)
    w = torch.full((4, 4), 3.0, requires_grad=True)
    params = {"w": w}
    state = adamw.init_state(params, cfg)
    for _ in range(60):
        w.grad = None
        torch.sum(w ** 2).backward()
        params, state, _ = adamw.apply_updates(params, {"w": w.grad}, state,
                                               cfg)
    assert float(torch.sum(w.detach() ** 2)) < 0.5
    cfg16 = adamw.AdamWConfig(state_dtype="bfloat16")
    p16 = {"w": torch.ones(8, dtype=torch.bfloat16)}
    s16 = adamw.init_state(p16, cfg16)
    assert s16["m"]["w"].dtype == torch.bfloat16
    p16, s16, m = adamw.apply_updates(
        p16, {"w": torch.ones(8, dtype=torch.bfloat16)}, s16, cfg16)
    assert p16["w"].dtype == torch.bfloat16 and s16["v"]["w"].dtype == \
        torch.bfloat16
    assert np.isfinite(float(m["grad_norm"]))


# ---------------------------------------------------------------- compression

def test_plan_for_leaf_is_the_reference_s_at_full_qwen3():
    """Every leaf of the full qwen3-0.6b tree (shapes only): the same plan,
    field for field, under ratio 8; five distinct plans, all blockperm."""
    shapes = jax.eval_shape(JDecoderLM(JARCHS["qwen3-0.6b"]).init,
                            jax.random.PRNGKey(0))
    cfg, jcfg = gc.CompressConfig(ratio=8), jgc.CompressConfig(ratio=8)
    plans = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        size = int(np.prod(leaf.shape))
        got, want = gc.plan_for_leaf(cfg, size), jgc.plan_for_leaf(jcfg, size)
        assert (got is None) == (want is None), jax.tree_util.keystr(path)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            plans[(got.d_pad, got.k_pad, got.M, got.Br, got.Bc)] = got
    assert sorted(plans) == sorted([
        (167_772_160, 33_554_432, 131_072, 256, 1_280),
        (92_274_688, 16_777_216, 65_536, 256, 1_408),
        (58_720_256, 8_388_608, 32_768, 256, 1_792),
        (29_360_128, 4_194_304, 16_384, 256, 1_792),
        (28_672, 4_096, 16, 256, 1_792)])
    assert not any(p.is_global for p in plans.values())


def test_compress_gradients_matches_reference_over_the_roll():
    """Steps 0-3 of the golden-ratio roll on the smoke tree, each side's
    error state carried; ĝ and the error within exactness_atol·max|ĝ|."""
    _, p_np = _ref_tree(seed=2)
    cfg, jcfg = gc.CompressConfig(ratio=8), jgc.CompressConfig(ratio=8)
    g_np = _random_like(p_np, 20)
    jg = jax.tree.map(jnp.asarray, g_np)
    jerr = jgc.init_error_state(jg)
    jcompress = jax.jit(lambda g, e, step: jgc.compress_gradients(
        jcfg, g, e, step=step))
    tg = _torch_tree(g_np)
    terr = gc.init_error_state(tg)
    for step in range(4):
        jhat, jerr = jcompress(jg, jerr, jnp.int32(step))
        that, terr = gc.compress_gradients(cfg, tg, terr,
                                           step=torch.tensor(step))
        for (path, w), (_, g) in zip(
                jax.tree_util.tree_flatten_with_path(jhat)[0],
                tr.leaves_with_path(that)):
            tol = ATOL32 * max(float(np.abs(np.asarray(w)).max()), 1e-30)
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=tol,
                                       rtol=0,
                                       err_msg=jax.tree_util.keystr(path))
        _assert_trees_close(terr, jerr, atol=ATOL32 * 10)


@pytest.mark.parametrize("d,step", [(155_582_464, 22), (155_582_464, 23),
                                    (88_080_384, 40), (4096, 3), (28_672, 0)])
def test_roll_shift_is_the_reference_s(d, step):
    """The reference's int32 product wraps past step 22 at the embedding's
    size; the port's shift follows it."""
    stride = int(0.6180339 * d) | 1
    want = int((jnp.asarray(step, jnp.int32) * stride) % d)
    assert gc.roll_shift(step, d) == want


def test_compress_error_feedback_reduces_bias():
    cfg = gc.CompressConfig(ratio=8, min_bucket=64, kappa=4, s=2)
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(size=(4096,)).astype(
        np.float32))}
    err = gc.init_error_state(g_true)
    acc = torch.zeros_like(g_true["w"])
    T = 32
    for t in range(T):
        g_hat, err = gc.compress_gradients(cfg, g_true, err, step=t)
        acc = acc + g_hat["w"]
    mean_rel = float(torch.linalg.norm(acc / T - g_true["w"])
                     / torch.linalg.norm(g_true["w"]))
    g1, _ = gc.compress_gradients(cfg, g_true, gc.init_error_state(g_true))
    one_rel = float(torch.linalg.norm(g1["w"] - g_true["w"])
                    / torch.linalg.norm(g_true["w"]))
    assert mean_rel < one_rel * 0.5, (mean_rel, one_rel)
    assert float(torch.linalg.norm(err["w"])) < \
        30 * float(torch.linalg.norm(g_true["w"]))


def test_compress_error_feedback_diverges_without_damping():
    cfg = gc.CompressConfig(ratio=8, min_bucket=64, damping=1.0,
                            n_rotations=1)
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(size=(4096,)).astype(
        np.float32))}
    err = gc.init_error_state(g_true)
    for t in range(12):
        _, err = gc.compress_gradients(cfg, g_true, err, step=t)
    assert float(torch.linalg.norm(err["w"])) > \
        100 * float(torch.linalg.norm(g_true["w"]))


def test_compress_small_leaves_pass_through_and_wire_bytes():
    cfg = gc.CompressConfig(ratio=8, min_bucket=1024)
    g = {"small": torch.ones(10), "norm": torch.ones(3)}
    g2, err = gc.compress_gradients(cfg, g, gc.init_error_state(g))
    assert torch.equal(g2["small"], torch.ones(10))
    assert torch.equal(err["norm"], torch.zeros(3))
    params = {"a": torch.zeros(1 << 16), "b": torch.zeros(64)}
    jparams = {"a": jnp.zeros((1 << 16,)), "b": jnp.zeros((64,))}
    wb = gc.wire_bytes(cfg, params)
    assert wb == jgc.wire_bytes(jgc.CompressConfig(ratio=8, min_bucket=1024),
                                jparams)
    assert wb["reduction"] > 4.0
    # the pod mean runs on a process group: an axis name needs a mesh
    # (tests/test_torch_pod_mean.py runs it)
    with pytest.raises(ValueError, match="pod_axis"):
        gc.compress_gradients(cfg, g, err, pod_axis="pod")


# ---------------------------------------------------------------- train step

def test_compressed_train_step_matches_reference():
    """Three steps of the reference's jitted step and the port's, ratio 8
    compression, from the same weights and batches."""
    jcfg, p_np = _ref_tree(seed=3)
    tcfg = smoke_config(get_arch("qwen3-0.6b"))
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep, _ = jts.build_train_step(jcfg, jopt, jgc.CompressConfig(ratio=8))
    tstep, _ = ts.build_train_step(tcfg, opt, gc.CompressConfig(ratio=8))
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, p_np)
    js, je = jadamw.init_state(jp, jopt), jgc.init_error_state(jp)
    tp = params_from_reference(tcfg, p_np, device="cpu").params
    t_s, t_e = adamw.init_state(tp, opt), gc.init_error_state(tp)
    data = dp.DataConfig(vocab_size=tcfg.vocab_size, global_batch=2,
                         seq_len=16, seed=4)
    for step in range(3):
        batch = dp.make_batch(data, step)
        jp, js, je, jm = jstep(jp, js, je, jax.tree.map(jnp.asarray, batch))
        tp, t_s, t_e, tm = tstep(tp, t_s, t_e, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(t_s["step"]) == 3


# ---------------------------------------------------------------- checkpoint

def _ck_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32), "e": {}}


def test_checkpoint_round_trip(tmp_path):
    tree = _ck_tree()
    d = str(tmp_path / "ck")
    ckpt.save(d, 100, tree)
    assert ckpt.latest_step(d) == 100
    restored, step = ckpt.restore(d, 100, tree)
    assert step == 100
    assert restored["e"] == {}
    for (pa, a), (pb, b) in zip(tr.leaves_with_path(restored),
                                tr.leaves_with_path(tree)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    ac = ckpt.AsyncCheckpointer()
    w = torch.zeros(8, 8)
    for s in (10, 20, 30, 40):
        ac.save_async(d, s, {"w": w})
        w += 1.0        # the snapshot is taken at the call, not the write
    ac.wait()
    ckpt.prune_old(d, keep=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    restored, _ = ckpt.restore(d, 40, {"w": w})
    assert torch.equal(restored["w"], torch.full((8, 8), 3.0))


def test_checkpoint_atomic_no_partial(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.zeros(4)})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1


def test_checkpoints_restore_across_packages(tmp_path):
    """The trainer's tree (params in bf16, f32 moments, the int32 step, the
    error state): each package restores the other's checkpoint, the same
    arrays and the same names."""
    _, p_np = _ref_tree(seed=6, param_dtype="bfloat16")
    m_np = _random_like(p_np, 30)
    tree_np = {"params": p_np, "opt": {"m": m_np, "v": m_np,
                                       "step": np.asarray(5, np.int32)},
               "err": _random_like(p_np, 31)}
    jtree = jax.tree.map(jnp.asarray, tree_np)
    ttree = _torch_tree(tree_np)
    jckpt.save(str(tmp_path / "from_ref"), 5, jtree)
    ckpt.save(str(tmp_path / "from_port"), 5, ttree)
    meta = [open(os.path.join(tmp_path, k, "step_00000005",
                              "meta.json")).read()
            for k in ("from_ref", "from_port")]
    assert meta[0] == meta[1]
    got, _ = ckpt.restore(str(tmp_path / "from_ref"), 5, ttree)
    want, _ = jckpt.restore(str(tmp_path / "from_port"), 5, jtree)
    for (pa, a), (pj, j), (_, t) in zip(
            tr.leaves_with_path(got),
            jax.tree_util.tree_flatten_with_path(want)[0],
            tr.leaves_with_path(ttree)):
        assert tr.keystr(pa) == jax.tree_util.keystr(pj)
        assert a.dtype == t.dtype and torch.equal(a, t)
        assert str(np.asarray(j).dtype) == str(t.dtype).replace("torch.", "")
        assert torch.equal(tr.from_numpy(np.asarray(j)), t)


# ---------------------------------------------------------------- trainer

def test_trainer_loss_decreases_and_restarts(tmp_path):
    cfg = smoke_config(get_arch("qwen3-0.6b"))
    data_cfg = dp.DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                             seq_len=32, seed=0)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                            weight_decay=0.0)
    tcfg = TrainerConfig(total_steps=30, ckpt_every=10,
                         ckpt_dir=str(tmp_path / "ck"), log_every=1000)
    out = Trainer(cfg, opt, tcfg, data_cfg, log_fn=lambda s: None,
                  device="cpu").fit()
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.2, (first, last)
    # restart: resumes from the latest checkpoint, runs only what is left,
    # and its first loss is the live run's at that step (both from step 30)
    logs = []
    tcfg2 = TrainerConfig(total_steps=35, ckpt_every=10,
                          ckpt_dir=str(tmp_path / "ck"), log_every=1000)
    tr2 = Trainer(cfg, opt, tcfg2, data_cfg, log_fn=logs.append,
                  device="cpu")
    out2 = tr2.fit()
    assert out2["steps"] == 5
    assert logs == ["[trainer] restored checkpoint step=30"]
    live = Trainer(cfg, opt, tcfg2, data_cfg, log_fn=lambda s: None,
                   device="cpu")
    _, _, _, m = live.step_fn(out["final_params"], out["final_opt"],
                              out["final_err"], live.batch(30))
    assert float(m["loss"]) == out2["losses"][0]


def test_trainer_with_compression_trains():
    cfg = smoke_config(get_arch("internlm2-1.8b"))
    data_cfg = dp.DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                             seq_len=32, seed=0)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                            weight_decay=0.0)
    comp = gc.CompressConfig(ratio=4, min_bucket=4096)
    tcfg = TrainerConfig(total_steps=25, ckpt_every=1000, log_every=1000)
    out = Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                  log_fn=lambda s: None, device="cpu").fit()
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.1


def test_train_cli_smoke_prints_its_two_lines(capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train]")]
    assert len(lines) == 2
    assert lines[0].startswith("[train] arch=qwen3-0.6b params~")
    assert lines[1].startswith("[train] done: first-5 loss ")


# ---------------------------------------------------------- CSRs at scale

@pytest.mark.parametrize("kw", [dict(d=5000, k=512, kappa=4, s=2),
                                dict(d=3000, k=256, kappa=2, s=4),
                                dict(d=70_000, k=4096, kappa=4, s=2)])
def test_chunked_csr_is_the_unchunked_one(kw, monkeypatch):
    """The CSRs of S and Sᵀ built in chunks of a few blocks are the
    one-chunk build, bit for bit."""
    plan = make_plan(kw["d"], kw["k"], kappa=kw["kappa"], s=kw["s"], seed=3)
    cpu = torch.device("cpu")
    builds = (lambda: fsk._device_csr.__wrapped__(plan, cpu),
              lambda: fsk._device_csr_t.__wrapped__(plan, cpu),
              lambda: fsk._device_csr_t.__wrapped__(plan, cpu, True))
    whole = [b() for b in builds]
    monkeypatch.setattr(fsk, "_CSR_CHUNK_ENTRIES", 1000)
    assert fsk._chunk_blocks(plan, plan.kappa * plan.Bc * plan.s) < plan.M
    for (p0, e0), (p1, e1) in zip(whole, [b() for b in builds]):
        assert (p0 is None and p1 is None) or (
            p0.dtype == p1.dtype == torch.int64 and torch.equal(p0, p1))
        assert e0.dtype == e1.dtype and torch.equal(e0, e1)


def test_csr_int32_guard_raises_past_the_limit(monkeypatch):
    """The guard checks the int32 words only: deepseek-7b's embedding
    (3.4 G nonzeros) and qwen3-moe-30b-a3b's (2.7 G) at ratio 8 pass it,
    though their ptr passes 2**31 - 1; command-r-plus-104b's embedding
    (more than 2**30 columns) raises on its words before anything is
    built."""
    comp = gc.CompressConfig(ratio=8)
    # the raise comes before the first table or temporary is built
    monkeypatch.setattr(fsk, "_device_table", None)
    for numel in (102_400 * 4096, 151_936 * 2048):
        plan = gc.plan_for_leaf(comp, numel)
        assert plan.kappa * plan.s * plan.d_pad > 2**31 - 1
        assert 2 * plan.d_pad - 1 <= 2**31 - 1
        for what, word_max in (("S", 2 * plan.d_pad - 1),
                               ("Sᵀ", 2 * plan.k_pad - 1)):
            fsk._check_int32(plan, word_max, what)
    big = gc.plan_for_leaf(comp, 256_000 * 12_288)
    assert 2 * big.d_pad - 1 > 2**31 - 1
    for build in (lambda: fsk._device_csr.__wrapped__(big, torch.device(
                      "cpu")),
                  lambda: fsk._blockrow_csr(big, torch.device("cpu"))):
        with pytest.raises(ValueError, match=r"2\*\*30 columns.*item 8"):
            build()


def test_csr_ptr_is_int64_past_the_int32_limit(monkeypatch):
    """With the int32 limit patched below a small plan's nonzero count,
    its CSRs still build: S's, S_row's and the CSR of Sᵀ keep their ptr
    values and come back int64, the words unchanged; the tile-local Sᵀ
    (the staged transpose's) holds no ptr."""
    plan = make_plan(5000, 512, kappa=4, s=2, seed=3)
    cpu = torch.device("cpu")
    builds = {"S": lambda: fsk._device_csr.__wrapped__(plan, cpu),
              "S_row": lambda: fsk._device_csr.__wrapped__(plan, cpu, True),
              "St": lambda: fsk._device_csr_t.__wrapped__(plan, cpu),
              "St_local": lambda: fsk._device_csr_t.__wrapped__(plan, cpu,
                                                                True)}
    before = {k: b() for k, b in builds.items()}
    nnz = plan.kappa * plan.s * plan.d_pad
    monkeypatch.setattr(fsk, "_INT32_MAX", nnz - 1)
    assert 2 * plan.d_pad - 1 <= nnz - 1
    after = {k: b() for k, b in builds.items()}
    for k in ("S", "S_row", "St"):
        (p0, e0), (p1, e1) = before[k], after[k]
        assert p1.dtype == torch.int64 and torch.equal(p0, p1), k
        assert e1.dtype == torch.int32 and torch.equal(e0, e1), k
        assert int(p1[-1]) == e1.numel(), k
    assert int(after["S"][0][-1]) == nnz
    assert before["St_local"][0] is None and after["St_local"][0] is None
    assert after["St_local"][1].dtype == torch.int16
    assert torch.equal(before["St_local"][1], after["St_local"][1])
