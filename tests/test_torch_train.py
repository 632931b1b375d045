"""The port's training path against the reference's, on shared weights and
numpy inputs from a seed (smoke configs in float32): every family's
``loss_fn`` and gradients, the remat policies, one ``make_train_fn`` step,
the ``Trainer`` (checkpoints, an injected failure, restart determinism,
weak optimizer symbols), the carried-over optimizer state, the CLI, and
the kernels' autograd plumbing (rmsnorm's ``_RMSNorm``, flash attention's
refusal to be differentiated)."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import get_config as ref_config
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_fn as ref_make_train_fn
from repro.optim import OptConfig as RefOptConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro_torch import models
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.ckpt import restore_train_state
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core import RelocType
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.launch.steps import make_train_fn
from repro_torch.models import common, transformer
from repro_torch.optim import OptConfig
from repro_torch.optim import init_opt_state
from repro_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma3-1b", "starcoder2-3b", "olmoe-1b-7b", "seamless-m4t-large-v2",
         "mamba2-370m", "zamba2-7b"]
SHAPE = (4, 16)                    # global batch, sequence length
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4    # relative; float32 on both sides
STATE_TOL = 1e-4                   # params and moments after training steps


def _configs(arch, dtype="float32"):
    return (ref_config(arch, smoke=True).replace(dtype=dtype),
            get_config(arch, smoke=True).replace(dtype=dtype))


def _ref_params(rcfg, seed=0):
    return {n: np.asarray(v) for n, v in ref_models.init_params(rcfg, seed).items()}


def _batch(cfg, step=0, seed=0):
    B, S = SHAPE
    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return b


def _port_params(pcfg, params_np):
    p = params_from_numpy(params_np, models.param_specs(pcfg), device="cpu")
    return {n: t.requires_grad_() for n, t in p.items()}


def _grads(loss, params):
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                            materialize_grads=True)
    return dict(zip(params, g))


def _rel_err(got, want):
    """Largest absolute error over the reference's largest magnitude."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, pcfg = _configs(arch)
    params_np = _ref_params(rcfg)
    batch = _batch(rcfg)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(rcfg, p, b)))(params_np, batch)
    params = _port_params(pcfg, params_np)
    loss = models.loss_fn(pcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    grads = _grads(loss, params)
    assert sorted(grads) == sorted(ref_g)
    worst = max((_rel_err(g.numpy(), ref_g[n]), n) for n, g in grads.items()
                if np.abs(np.asarray(ref_g[n])).max() > 0)
    assert worst[0] <= GRAD_TOL, worst
    for n, g in grads.items():          # unused params: zeros on both sides
        if not np.abs(np.asarray(ref_g[n])).max():
            assert not bool(g.abs().max()), n


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m", "zamba2-7b"])
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_policies_give_the_same_gradients(arch, policy):
    """Remat changes what is kept for the backward, never the numbers: each
    policy's loss and gradients equal the config's own ("nothing")."""
    rcfg, pcfg = _configs(arch)
    params_np = _ref_params(rcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rcfg).items()}
    out = {}
    for pol in ("nothing", policy):
        cfg = pcfg.replace(remat_policy=pol)
        params = _port_params(cfg, params_np)
        loss = models.loss_fn(cfg, params, batch)
        out[pol] = (loss.detach(), _grads(loss, params))
    assert torch.equal(out["nothing"][0], out[policy][0])
    for n, g in out["nothing"][1].items():
        torch.testing.assert_close(out[policy][1][n], g, rtol=1e-6, atol=0, msg=n)


def test_remat_applies_only_while_autograd_records(monkeypatch):
    """Prefill under no_grad runs each layer once, as before; a training
    forward under the "nothing" policy runs each layer's body again in the
    backward."""
    _, pcfg = _configs("gemma3-1b")
    calls = {"n": 0}
    real = transformer._block

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(transformer, "_block", counting)
    params = _port_params(pcfg, _ref_params(_configs("gemma3-1b")[0]))
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    with torch.no_grad():
        models.prefill(pcfg, params, {"tokens": batch["tokens"]}, impl="chunked")
    assert calls["n"] == pcfg.num_layers
    calls["n"] = 0
    loss = models.loss_fn(pcfg, params, batch)
    assert calls["n"] == pcfg.num_layers
    _grads(loss, params)
    assert calls["n"] == 2 * pcfg.num_layers


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CountingNorm(torch.autograd.Function):
    """rmsnorm's plain forward and backward, counted."""
    counts = {"forward": 0, "backward": 0}

    @staticmethod
    def forward(ctx, x, scale, eps):
        _CountingNorm.counts["forward"] += 1
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rn.rmsnorm_plain(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        _CountingNorm.counts["backward"] += 1
        x, scale = ctx.saved_tensors
        return (*rn.rmsnorm_backward_plain(x, scale, dy, eps=ctx.eps), None)


@pytest.mark.parametrize("arch,policy", [("gemma3-1b", "nothing"), ("gemma3-1b", "none"),
                                         ("qwen2-moe-a2.7b", "nothing")])
def test_train_step_rmsnorm_counts_match_chip_smoke(smoke, arch, policy, monkeypatch):
    """``chip_smoke.train_rms_launches`` (phase 11's exact launch counts):
    each norm once forward and once backward, and every norm inside a
    layer body once more in the remat recompute (with and without q/k
    norms; none without remat)."""
    rcfg, pcfg = _configs(arch)
    pcfg = pcfg.replace(remat_policy=policy)
    monkeypatch.setattr(transformer, "rms_norm",
                        lambda x, scale, eps=1e-6: _CountingNorm.apply(x, scale, eps))
    _CountingNorm.counts.update(forward=0, backward=0)
    params = _port_params(pcfg, _ref_params(rcfg))
    loss = models.loss_fn(pcfg, params, {k: torch.from_numpy(v)
                                         for k, v in _batch(pcfg).items()})
    _grads(loss, params)
    assert _CountingNorm.counts == smoke.train_rms_launches(pcfg)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    rcfg, pcfg = _configs("starcoder2-3b")
    kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=3)
    params_np = _ref_params(rcfg)
    ref_step = jax.jit(ref_make_train_fn(rcfg, RefOptConfig(**kw),
                                         num_microbatches=microbatches))
    step = make_train_fn(pcfg, OptConfig(**kw), num_microbatches=microbatches)
    rp, ro = {n: jnp.asarray(a) for n, a in params_np.items()}, None
    ro = ref_init_opt_state(rp)
    params = _port_params(pcfg, params_np)
    opt = init_opt_state(params)
    for i in range(3):
        b = _batch(rcfg, step=i)
        rp, ro, rm = ref_step(rp, ro, b)
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=STATE_TOL), key
    assert int(opt["step"]) == int(ro["step"]) == 3
    for n in params:
        for what, got, want in (("param", params[n], rp[n]), ("m", opt["m"][n], ro["m"][n]),
                                ("v", opt["v"][n], ro["v"][n])):
            assert _rel_err(got.detach().numpy(), want) <= STATE_TOL, (what, n)


def test_opt_state_from_numpy_continues_the_reference_training():
    """Both packages train on for 2 steps from one carried-over state (the
    reference's params and {m, v, step} after 2 of its steps)."""
    rcfg, pcfg = _configs("gemma3-1b")
    kw = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=6)
    ref_step = jax.jit(ref_make_train_fn(rcfg, RefOptConfig(**kw)))
    rp = {n: jnp.asarray(a) for n, a in _ref_params(rcfg).items()}
    ro = ref_init_opt_state(rp)
    for i in range(2):
        rp, ro, _ = ref_step(rp, ro, _batch(rcfg, step=i))
    carried = {"m": {n: np.asarray(a) for n, a in ro["m"].items()},
               "v": {n: np.asarray(a) for n, a in ro["v"].items()},
               "step": np.asarray(ro["step"])}
    params = _port_params(pcfg, {n: np.asarray(a) for n, a in rp.items()})
    opt = opt_state_from_numpy(carried, models.param_specs(pcfg), device="cpu")
    assert opt["step"].shape == () and int(opt["step"]) == 2
    step = make_train_fn(pcfg, OptConfig(**kw))
    for i in range(2, 4):
        b = _batch(rcfg, step=i)
        rp, ro, _ = ref_step(rp, ro, b)
        params, opt, _ = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
    for n in params:
        assert _rel_err(params[n].detach().numpy(), rp[n]) <= STATE_TOL, n
        assert _rel_err(opt["m"][n].numpy(), ro["m"][n]) <= STATE_TOL, n
        assert _rel_err(opt["v"][n].numpy(), ro["v"][n]) <= STATE_TOL, n


# ------------------------------------------------------------------ trainer
def _tcfg(cls=TrainConfig, opt=OptConfig, **kw):
    base = dict(steps=6, checkpoint_every=3,
                opt=opt(peak_lr=1e-3, warmup_steps=2, decay_steps=6))
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("fail_at", [-1, 4], ids=["steady", "failure-at-4"])
def test_trainer_matches_reference_trainer(tmp_path, fail_at):
    """One published init (the reference's), the same synthetic stream: the
    port's Trainer and the reference's give the same loss at every step,
    through a checkpoint and, with a failure at step 4, a restart."""
    rcfg, pcfg = _configs("gemma3-1b")
    params_np = _ref_params(rcfg)
    B, S = SHAPE
    ref = RefTrainer(tmp_path / "ref", rcfg, RefShapeConfig("t", S, B, "train"),
                     make_local_mesh(),
                     _tcfg(RefTrainConfig, RefOptConfig, fail_at_step=fail_at))
    ref.publish(params_np)
    want = ref.run()
    tr = Trainer(tmp_path / "port", pcfg, ShapeConfig("t", S, B, "train"),
                 _tcfg(fail_at_step=fail_at), device="cpu")
    tr.publish(params_np)
    got = tr.run()
    assert (got.steps_done, got.restarts, got.checkpoint_saves) == (
        want.steps_done, want.restarts, want.checkpoint_saves)
    assert len(got.losses) == len(want.losses) == 6 + (fail_at > 0)
    np.testing.assert_allclose(got.losses, want.losses, rtol=STATE_TOL)
    assert [s["resume_step"] for s in got.startup_stats] == [
        s["resume_step"] for s in want.startup_stats]
    # the step compiled once per program identity: the reference's sources
    assert [s["compile_source"] for s in got.startup_stats] == [
        s["compile_source"] for s in want.startup_stats]
    assert {s["compiled_as"] for s in got.startup_stats} == {"eager"}


def test_train_completes_and_checkpoints(tmp_path):
    cfg = get_config("gemma3-1b", smoke=True)
    tr = Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"), _tcfg(),
                 device="cpu")
    tr.publish()
    tr.ckpt.keep_last = True
    res = tr.run()
    assert res.steps_done == 6 and res.checkpoint_saves == 2 and res.restarts == 0
    assert all(np.isfinite(res.losses)) and len(res.step_s) == 6
    st = res.startup_stats[0]
    assert st["strategy"] == "stable" and st["compile_source"] == "compiled"
    assert st["compiled_as"] == "eager"      # the CPU runs the program eagerly
    # the trained state is the device arena's own bytes: views, no copy
    base = tr.image.arena.untyped_storage().data_ptr()
    for n, t in tr.params.items():
        assert t.untyped_storage().data_ptr() == base and t.requires_grad, n
    assert tr.opt_state["step"].untyped_storage().data_ptr() == base
    assert int(tr.opt_state["step"]) == 6
    # the step-6 checkpoint, loaded back, is the snapshot and the live state
    params, opt, step = restore_train_state(tr.executor, tr.app_name)
    assert step == 6 and int(opt["step"]) == 6
    snap = {**tr.ckpt.last_snapshot[0], **tr.ckpt.last_snapshot[1]}
    flat = {**params, "opt/step": opt["step"].reshape(1),
            **{f"opt/{mv}/{n}": a for mv in ("m", "v") for n, a in opt[mv].items()}}
    assert sorted(snap) == sorted(flat)
    for n, t in snap.items():
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == np.asarray(
            flat[n]).tobytes(), n
    for n, t in tr.params.items():
        assert torch.equal(t.detach(), snap[n]), n


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    cfg = get_config("gemma3-1b", smoke=True)
    tr = Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"),
                 _tcfg(fail_at_step=4), device="cpu")
    tr.publish()
    res = tr.run()
    assert res.restarts == 1 and res.steps_done == 6
    assert [s["resume_step"] for s in res.startup_stats] == [0, 3]
    assert "ckpt_wait_s" in res.startup_stats[1]
    # step 3 ran before the failure and again after the restart, from the
    # step-3 checkpoint: the same loss, bit for bit
    assert res.losses[3] == res.losses[4]


def test_repeated_failure_is_raised_after_max_restarts(tmp_path, monkeypatch):
    from repro_torch.train import trainer

    monkeypatch.setattr(trainer, "MAX_RESTARTS", 2)
    cfg = get_config("gemma3-1b", smoke=True)
    tr = Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"), _tcfg(),
                 device="cpu")
    tr.publish()
    starts = []
    real = tr._startup

    def failing_step_startup():
        out = real()
        starts.append(out[3])

        def step_fn(*a):
            raise RuntimeError("device lost")
        return out[0], out[1], step_fn, out[3], out[4]

    monkeypatch.setattr(tr, "_startup", failing_step_startup)
    with pytest.raises(RuntimeError, match="device lost"):
        tr.run()
    assert starts == [0, 0, 0]


def test_restart_determinism(tmp_path):
    """Crash-and-resume lands on the same weights as an uninterrupted run:
    checkpointed state + deterministic data stream + stable-path restore."""
    cfg = get_config("starcoder2-3b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    a = Trainer(tmp_path / "a", cfg, shape, _tcfg(), device="cpu")
    a.publish()
    a.run()
    b = Trainer(tmp_path / "b", cfg, shape, _tcfg(fail_at_step=5), device="cpu")
    b.publish()
    assert b.run().restarts == 1
    ia = a.ws.load(a.app_name, strategy="stable", device="cpu")
    ib = b.ws.load(b.app_name, strategy="stable", device="cpu")
    for name in models.param_specs(cfg):
        torch.testing.assert_close(ib.tensors[name].float(), ia.tensors[name].float(),
                                   atol=1e-6, rtol=0, msg=name)


def test_optimizer_state_weak_symbols(tmp_path):
    """opt/* are weak refs: INIT (zeros) before the first checkpoint,
    DIRECT bindings afterwards."""
    cfg = get_config("gemma3-1b", smoke=True)
    tr = Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"), _tcfg(),
                 device="cpu")
    tr.publish()

    def opt_types(prefix):
        t = tr.ws.load(tr.app_name, strategy="stable").table
        return {t.name_at(r["symbol_name"]): int(r["type"]) for r in t.rows
                if t.name_at(r["symbol_name"]).startswith(prefix)}

    assert set(opt_types("opt/").values()) == {int(RelocType.INIT)}
    img0 = tr.ws.load(tr.app_name, strategy="stable", device="cpu")
    assert not any(bool(t.any()) for n, t in img0.tensors.items() if n.startswith("opt/"))
    tr.run()
    after = opt_types("opt/")
    assert set(after.values()) == {int(RelocType.DIRECT)}
    img1 = tr.ws.load(tr.app_name, strategy="stable", device="cpu")
    assert int(img1.tensors["opt/step"][0]) == 6
    some = next(n for n in after if n.startswith("opt/m/"))
    assert float(img1.tensors[some].abs().sum()) > 0


def test_trainer_raises_without_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma3-1b", smoke=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Trainer(tmp_path / "reg", cfg, ShapeConfig("t", 16, 4, "train"), _tcfg())


def test_train_cli_resumes_on_its_registry(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train as cli

    def run(steps):
        monkeypatch.setattr(sys, "argv", [
            "train", "--arch", "gemma3-1b", "--device", "cpu", "--steps", str(steps),
            "--checkpoint-every", "2", "--batch", "4", "--seq", "16",
            "--registry", str(tmp_path / "reg")])
        cli.main()
        return json.loads(capsys.readouterr().out)

    first = run(4)
    assert (first["steps"], first["checkpoint_saves"]) == (4, 2)
    assert [s["resume_step"] for s in first["startups"]] == [0]
    second = run(6)           # a new process would see the same registry
    assert second["steps"] == 6 and second["startups"][0]["resume_step"] == 4
    assert np.isfinite(second["last_loss"])


# ------------------------------------------------------- kernels and autograd
def test_rmsnorm_autograd_function_matches_plain_autograd(monkeypatch):
    """``_RMSNorm`` (the CUDA path's Function) with its two launches stood
    in by the plain versions: the same gradients as autograd through
    ``rmsnorm_plain``, one backward call, x and scale saved."""
    calls = []

    def fake_backward(x, scale, dy, eps):
        calls.append((tuple(x.shape), tuple(dy.shape), eps))
        return rn.rmsnorm_backward_plain(x, scale, dy, eps=eps)

    monkeypatch.setattr(rn, "_launch", lambda x, s, eps: rn.rmsnorm_plain(x, s, eps=eps))
    monkeypatch.setattr(rn, "_launch_backward", fake_backward)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((2, 3, 24)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 3, 24)).astype(np.float32))
    x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    y = rn._RMSNorm.apply(x, s, 1e-5)
    got = torch.autograd.grad(y, (x, s), dy.transpose(0, 1).contiguous().transpose(0, 1))
    x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    want = torch.autograd.grad(rn.rmsnorm_plain(x, s, eps=1e-5), (x, s), dy)
    assert calls == [((2, 3, 24), (2, 3, 24), 1e-5)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_flash_attention_refuses_to_be_differentiated_off_the_cpu():
    q = torch.empty((1, 4, 2, 16), device="meta", requires_grad=True)
    kv = torch.empty((1, 4, 1, 16), device="meta")
    with pytest.raises(RuntimeError, match="impl='chunked'"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(kv.expand(1, 4, 2, 16), kv, kv.requires_grad_())
    with torch.no_grad():               # no graph to cut: the device check
        with pytest.raises(ValueError, match="no kernel"):
            fa.flash_attention(q, kv, kv)


def test_flash_attention_on_the_cpu_stays_differentiable():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 8, 1, 16)).astype(np.float32))
            for _ in range(2))
    q.requires_grad_()
    out = fa.flash_attention(q, k, v)
    (g,) = torch.autograd.grad(out.sum(), q)
    ref = common.naive_attention(q, k, v)
    (g_ref,) = torch.autograd.grad(ref.sum(), q)
    torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-5)
