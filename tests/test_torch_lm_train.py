"""The port's training substrate against the JAX package's, on the CPU:
``make_train_step`` under AdamW and under the arrowhead optimizer (r = 8,
band 2, a refresh every 2 steps, so step 2 refactorizes) from the same
converted state, one and three steps against the reference's
``make_train_step(cfg, run, None, precond)`` on the same Markov batches —
loss and grad norm at rtol 1e-5, parameters and AdamW moments at rtol 1e-4
relative to each leaf's largest entry, the arrowhead's statistics and
factor at 1e-4; ``token_batch`` and ``MarkovStream`` bit for bit; AdamW's
pieces; the checkpointer (roundtrip, keep-k, async, a sharded save's
async write in a world of one, the reference's
``TrainState`` paths, a params checkpoint written by either package read by
the other); ``TrainLoop`` retry and restore (``tests/test_substrate.py``'s
cases) and ``train()`` end to end; every model family (moe, ssm, hybrid,
encdec) through ``train()`` under both optimizers and through ``Server``,
and every arch id through both command lines, reduced, on the CPU."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import ModelConfig as JModelConfig, RunConfig as JRunConfig
from repro.data import synthetic as jsyn
from repro.launch import train as JTrain
from repro.optim import adamw as JAdam
from repro.optim.arrowhead import build_precond as jbuild_precond
from repro_torch import configs, pytree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data import MarkovStream, token_batch
from repro_torch.launch import serve as Serve
from repro_torch.launch import train as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import (adamw_init, adamw_update, clip_by_global_norm,
                                     cosine_lr, global_norm)
from repro_torch.optim.arrowhead import build_precond
from repro_torch.runtime.fault_tolerance import FailureInjector, StragglerMonitor, TrainLoop

SMALL = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=128, head_dim=16, qk_norm=True)
RUN = dict(compute_dtype="float32", remat="none", loss_chunk=8, precond_proj_dim=8,
           precond_band=2, precond_every=2)
STEPS = 3


def _close(got, want, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * (np.abs(want).max() or 1.0))


def _snapshot(state):
    return pytree.tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                           state)


@pytest.fixture(scope="module", params=["adamw", "arrowhead"])
def trained(request):
    """Both packages' states after 1 and 3 steps from one converted
    initialisation, and their metrics: one jitted reference step shared
    by every check of the optimizer."""
    opt = request.param
    jc, tc = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jr, tr = JRunConfig(optimizer=opt, **RUN), RunConfig(optimizer=opt, **RUN)
    key = jax.random.PRNGKey(0)
    jpre = tpre = None
    if opt == "arrowhead":
        shapes = jax.eval_shape(lambda k: JTrain.get_model(jc).init(k, jc, 16), key)
        jpre = jbuild_precond(shapes, r=8, band=2, seed=0)
    js = JTrain.init_state(key, jc, jr, 16, jpre)
    params = params_from_numpy(jax.tree.map(np.asarray, js.params))
    ts = T.TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    if opt == "arrowhead":
        tpre = build_precond(params, r=8, band=2, seed=0)
        T.attach_precond(ts, tpre)
    jstep = jax.jit(JTrain.make_train_step(jc, jr, None, jpre, total_steps=10))
    tstep = T.make_train_step(tc, tr, None, tpre, total_steps=10)
    stream = MarkovStream(128, seed=0)
    out = {"opt": opt, "j": {}, "t": {}, "jm": [], "tm": []}
    for s in range(STEPS):
        b = stream.batch(s, 2, 16)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        out["jm"].append(jm)
        out["tm"].append(tm)
        if s + 1 in (1, STEPS):
            out["j"][s + 1] = jax.tree.map(np.asarray, js)
            out["t"][s + 1] = _snapshot(ts)
    return out


@pytest.mark.parametrize("n", [1, STEPS])
def test_train_steps_match_reference(trained, n):
    for jm, tm in zip(trained["jm"][:n], trained["tm"][:n]):
        _close(tm["loss"], jm["loss"], 1e-5)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-5)
        assert tm["lr"] == float(jm["lr"])
    js, ts = trained["j"][n], trained["t"][n]
    assert int(ts.step) == int(js.step) == n
    for tree_t, tree_j in ((ts.params, js.params), (ts.opt.m, js.opt.m), (ts.opt.v, js.opt.v)):
        for a, b in zip(pytree.leaves(tree_t), jax.tree.leaves(tree_j)):
            _close(a, b, 1e-4)
    assert int(ts.opt.count) == int(js.opt.count) == n
    if trained["opt"] == "arrowhead":
        for k in ("Dr", "R", "C"):
            _close(ts.precond[k], js.precond[k], 1e-4)
            _close(ts.factor[k], js.factor[k], 1e-4)
    else:
        assert ts.precond is None and js.precond is None


def test_grad_accumulation_matches_one_batch():
    """Two microbatches of 2 give the step of one batch of 4 (the loss the
    mean of the microbatches')."""
    cfg = ModelConfig(**SMALL)
    outs = []
    for accum in (1, 2):
        run = RunConfig(grad_accum=accum, **RUN)
        state = T.init_state(torch.Generator().manual_seed(0), cfg, run)
        step = T.make_train_step(cfg, run, None, None, total_steps=10)
        batch = MarkovStream(128, seed=1).batch(0, 4, 16)
        for s in range(2):
            state, m = step(state, batch)
        outs.append((m["loss"], state.params))
    _close(outs[1][0], outs[0][0], 1e-5)
    for a, b in zip(pytree.leaves(outs[1][1]), pytree.leaves(outs[0][1])):
        _close(a, b, 1e-4)


def test_sharded_steps_wait_for_the_partition_rules():
    """``make_train_step(rules=)`` through ``shard_train_step`` at world 1
    (``launch/mesh.py::local_world``) equals ``rules=None`` bit for bit,
    three steps of each optimizer: loss, grad norm and every state leaf."""
    from repro_torch.launch.mesh import local_world, make_local_mesh
    from repro_torch.sharding.partition import make_rules, shard_tree
    cfg = ModelConfig(**SMALL)
    stream = MarkovStream(128, seed=0)
    batches = [stream.batch(s, 2, 16) for s in range(STEPS)]
    for opt in ("adamw", "arrowhead"):
        run = RunConfig(optimizer=opt, **RUN)
        states, steps = [], []
        for _ in range(2):
            st = T.init_state(torch.Generator().manual_seed(0), cfg, run)
            pre = None
            if opt == "arrowhead":
                pre = build_precond(st.params, r=8, band=2, seed=0)
                T.attach_precond(st, pre)
            states.append(st)
            steps.append(T.make_train_step(cfg, run, None, pre, total_steps=10))
        with local_world():
            mesh = make_local_mesh()
            rules = make_rules(mesh, cfg, run)
            pre = build_precond(states[1].params, r=8, band=2, seed=0) if opt == "arrowhead" \
                else None
            fn, sh = T.shard_train_step(T.make_train_step(cfg, run, rules, pre, total_steps=10),
                                        mesh, rules, states[1], batches[0])
            states[1] = shard_tree(states[1], sh)
            for b in batches:
                states[0], m0 = steps[0](states[0], b)
                states[1], m1 = fn(states[1], b)
                assert torch.equal(m0["loss"], m1["loss"])
                assert torch.equal(m0["grad_norm"], m1["grad_norm"])
        for (p0, a), (p1, b) in zip(pytree.leaves_with_path(states[0]),
                                    pytree.leaves_with_path(states[1])):
            assert p0 == p1 and torch.equal(a, b), p0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (7, 42), (3, 1000)])
def test_token_streams_are_bit_identical(seed, step):
    a, b = token_batch(seed, step, 4, 16, 1000), jsyn.token_batch(seed, step, 4, 16, 1000)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    s, js = MarkovStream(64, seed=seed), jsyn.MarkovStream(64, seed=seed)
    assert s.entropy_floor == js.entropy_floor and 0 < s.entropy_floor < np.log(64)
    np.testing.assert_array_equal(s.P, js.P)
    x, y = s.batch(step, 3, 32, {"e": np.ones(2)}), js.batch(step, 3, 32, {"e": np.ones(2)})
    assert x.keys() == y.keys()
    for k in ("tokens", "labels"):
        assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        adamw_update(g, state, params, 0.05, weight_decay=0.0)
    torch.testing.assert_close(params["w"], target, rtol=0, atol=0.05)


def test_grad_clip_and_schedule_match_reference():
    tree = {"a": torch.ones(10) * 100.0}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 100
    for s in range(0, 120, 7):
        assert cosine_lr(s, 1e-3, warmup=10, total=100) == float(
            JAdam.cosine_lr(jnp.asarray(s), 1e-3, warmup=10, total=100))
    lrs = [cosine_lr(s, 1e-3, warmup=10, total=100) for s in range(0, 100, 10)]
    assert lrs[0] < lrs[1] and lrs[-1] < lrs[2]


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(5, dtype=torch.int32)}
    ck.save(5, state, meta={"note": "x"})
    out = ck.restore(state)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 5
    assert ck.meta()["note"] == "x"


def test_checkpoint_keep_k_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.ones(3) * s})
    assert ck.all_steps() == [3, 4]
    out = ck.restore({"w": torch.zeros(3)})
    assert torch.equal(out["w"], torch.full((3,), 4.0))


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, async_save=True)
    w = torch.ones(4)
    ck.save(1, {"w": w})
    w += 1                                   # the save took its host copy already
    ck.wait()
    assert ck.all_steps() == [1]
    assert torch.equal(ck.restore({"w": w})["w"], torch.ones(4))


def test_a_sharded_save_in_a_world_of_one_is_written_in_the_writer_thread(tmp_path,
                                                                         monkeypatch):
    """``save(shardings=)`` in a world of one returns before its write (the
    write waits until it has), as an unsharded save does."""
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.launch.mesh import local_world, make_local_mesh
    from repro_torch.sharding.partition import NamedSharding, PartitionSpec
    returned, seen, savez = threading.Event(), [], np.savez

    def late_savez(*args, **kw):
        seen.append(returned.wait(30))
        savez(*args, **kw)

    monkeypatch.setattr(C.np, "savez", late_savez)
    with local_world():
        sh = {"w": NamedSharding(make_local_mesh(), PartitionSpec("data"))}
        ck = Checkpointer(str(tmp_path), keep=1)
        w = torch.ones(4)
        ck.save(1, {"w": w}, shardings=sh)
        returned.set()
        w += 1
        out = ck.restore({"w": w}, shardings=sh)
    assert seen == [True]
    assert torch.equal(out["w"], torch.ones(4))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A params dict the reference saved restores into the port with the
    same arrays, and back; a TrainState checkpoint has the reference's
    paths."""
    jp = JTrain.get_model(JModelConfig(**SMALL)).init(jax.random.PRNGKey(0),
                                                     JModelConfig(**SMALL))
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(3, jp)
    template = pytree.tree_map(torch.zeros_like, params_from_numpy(jax.tree.map(np.asarray, jp)))
    got = Checkpointer(str(tmp_path / "j")).restore(template)
    for a, b in zip(pytree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Checkpointer(str(tmp_path / "t"), async_save=False).save(4, got)
    back = JCheckpointer(str(tmp_path / "t")).restore(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # TrainState paths (field order, None fields skipped) as the reference's
    cfg = ModelConfig(**SMALL)
    ts = T.init_state(torch.Generator().manual_seed(0), cfg, RunConfig(**RUN))
    T.attach_precond(ts, build_precond(ts.params, r=8, band=2))
    js = JTrain.init_state(jax.random.PRNGKey(0), JModelConfig(**SMALL), JRunConfig(**RUN),
                           0, jbuild_precond(jp, r=8, band=2))
    from repro.checkpoint.checkpointer import _flatten
    assert [p for p, _ in pytree.leaves_with_path(ts)] == list(_flatten(js))


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_substrate.py's cases)
# ---------------------------------------------------------------------------

def _counting_loop(tmp_path, injector, retries=2):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        return state + 1, {"loss": state.to(torch.float32)}

    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    loop = TrainLoop(step_fn=step_fn, batch_fn=lambda step: step, checkpointer=ck,
                     checkpoint_every=3, max_step_retries=retries, injector=injector,
                     log_every=0, log_fn=lambda *a, **k: None)
    return loop, calls


def test_retry_recovers_from_transient_failure(tmp_path):
    inj = FailureInjector({4: 1})
    loop, calls = _counting_loop(tmp_path, inj)
    final = loop.run(torch.tensor(0), 0, 8)
    assert int(final) == 8 and inj.injected == [4] and calls["n"] == 8
    assert [float(m["loss"]) for m in loop.history] == list(range(8))


def test_hard_failure_restores_checkpoint(tmp_path):
    inj = FailureInjector({5: 10})          # exceeds retries -> hard failure
    loop, calls = _counting_loop(tmp_path, inj)
    final = loop.run(torch.tensor(0), 0, 8)
    assert int(final) == 8
    assert len(inj.injected) == 10


def test_retry_after_a_failed_precondition_repeats_the_step(tmp_path):
    """An arrowhead step whose ``precondition`` raises once (on a refresh
    step) is retried by ``TrainLoop`` on the same state: the run ends where
    the unfailed run does, the statistics' EMA and count included."""
    cfg, run = ModelConfig(**SMALL), RunConfig(optimizer="arrowhead", **RUN)
    stream = MarkovStream(128, seed=0)
    finals, calls = [], []
    for fail_at in (None, 3):
        state = T.init_state(torch.Generator().manual_seed(0), cfg, run, max_seq=16)
        pre = build_precond(state.params, r=8, band=2, seed=0)
        T.attach_precond(state, pre)
        n = {"calls": 0}

        def precondition(factor, grads, _orig=pre.precondition, _n=n, _at=fail_at, **kw):
            _n["calls"] += 1
            if _n["calls"] == _at:
                raise RuntimeError("injected failure in precondition")
            return _orig(factor, grads, **kw)

        pre.precondition = precondition
        loop = TrainLoop(step_fn=T.make_train_step(cfg, run, None, pre, total_steps=10),
                         batch_fn=lambda step: stream.batch(step, 2, 16),
                         checkpointer=Checkpointer(str(tmp_path / str(fail_at)), keep=2,
                                                   async_save=False),
                         checkpoint_every=10, log_every=0, log_fn=lambda *a, **k: None)
        finals.append(loop.run(state, 0, 4))
        calls.append(n["calls"])
    assert calls == [4, 5]
    ok, failed = finals
    assert int(ok.step) == int(failed.step) == 4
    assert int(ok.precond["count"]) == int(failed.precond["count"]) == 4
    for a, b in zip(pytree.leaves((ok.params, ok.opt.m, ok.opt.v, ok.precond, ok.factor)),
                    pytree.leaves((failed.params, failed.opt.m, failed.opt.v, failed.precond,
                                   failed.factor))):
        assert torch.equal(a, b)


def test_straggler_monitor_flags():
    mon = StragglerMonitor(factor=2.0)
    for i in range(10):
        mon.record(i, 0.01)
    mon.record(10, 0.5)
    assert mon.flagged and mon.flagged[0][0] == 10


@pytest.mark.parametrize("optimizer", ["adamw", "arrowhead"])
def test_train_end_to_end_on_the_cpu(tmp_path, optimizer):
    """``train()`` on a reduced qwen2-7b: finite losses, the checkpoint of
    the last step written, the arrowhead's state carried."""
    out = T.train("qwen2-7b", steps=3, batch=2, seq=16, optimizer=optimizer,
                  checkpoint_dir=str(tmp_path), log_every=0, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["loop"].checkpointer.latest_step() == 3
    assert (out["state"].factor is not None) == (optimizer == "arrowhead")
    assert dataclasses.replace(out["cfg"]).n_layers == 4


# ---------------------------------------------------------------------------
# every model family through the trainer and the server
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-2.7b", "whisper-medium")


def _family_cfg(arch):
    """The arch reduced to 2 layers (zamba2: one superblock of 6; whisper: 2
    encoder and 2 decoder layers, the depths the arrowhead needs equal)."""
    cfg = configs.get(arch)
    return T.reduce_config(cfg, layers=cfg.shared_attn_every or 2)


@pytest.mark.parametrize("optimizer", ["adamw", "arrowhead"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains_on_the_cpu(tmp_path, arch, optimizer):
    """``train()`` with each optimizer: finite losses, the arrowhead's grid
    one diagonal block a layer (zamba2: a superblock)."""
    cfg = _family_cfg(arch)
    out = T.train(cfg, steps=3, batch=2, seq=16, optimizer=optimizer, reduced=False,
                  checkpoint_dir=str(tmp_path), log_every=0, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    if optimizer == "arrowhead":
        depth = cfg.n_layers // (cfg.shared_attn_every or 1)
        assert out["precond"].n_layers == depth == out["precond"].grid.n_diag_tiles
        if cfg.family == "encdec":
            assert cfg.encoder_layers == cfg.n_layers
        assert all(torch.isfinite(v).all() for v in out["state"].factor.values())
    else:
        assert out["state"].factor is None


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_serves_on_the_cpu(arch):
    """``Server.generate`` through the registry's prefill and decode: the
    last greedy token is the argmax of a full forward over the prompt and
    the tokens before it.  A MoE layer's capacity grows with the sequence
    (a one-token decode step never drops an assignment, a forward of 11
    may), so the two agree only where nothing is dropped: the MoE server
    runs at ``capacity_factor = n_experts / top_k``, a capacity of the whole
    sequence."""
    cfg = _family_cfg(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    run = RunConfig(remat="none", compute_dtype="float32", loss_chunk=128)
    server = Serve.Server(cfg, run, max_len=12, device="cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = r.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    res = server.generate(batch, 4)
    assert res["tokens"].shape == (2, 4)
    seq = np.concatenate([batch["tokens"], res["tokens"]], 1)
    with torch.no_grad():
        logits, _ = server.api.prefill(server.params, {
            **{k: torch.from_numpy(v) for k, v in batch.items()},
            "tokens": torch.from_numpy(seq[:, :-1])}, cfg, run)
    assert torch.equal(torch.argmax(logits, -1), torch.from_numpy(res["tokens"][:, -1]))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_arch_runs_the_command_lines(tmp_path, arch):
    """``python -m repro_torch.launch.train`` and ``...serve`` for every
    arch id, reduced, on the CPU."""
    out = T.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq", "8",
                  "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert np.isfinite(out["losses"]).all()
    out = Serve.main(["--arch", arch, "--batch", "1", "--prompt-len", "4", "--gen", "2",
                      "--device", "cpu"])
    assert out["tokens"].shape == (1, 2)
