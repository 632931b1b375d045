"""The port's multi-device layer across real processes on the CPU (gloo),
held against the reference's UNSHARDED functions on the same numpy inputs
and weights: sharding changes placement, not arithmetic. (The reference's
own multi-device path refuses every mesh larger than 1x1 under this JAX:
``tests/test_system.py::test_dryrun_subprocess_small_mesh``.)

Each check starts ``tests/torch_dist_worker.py`` once per rank and reads
what rank 0 wrote: ``build_step``'s train, prefill and decode steps on a
2x2 mesh (4 ranks) and on a 1x1 mesh (the same bits as the meshless
steps), a greedy decode step at batch 1 over a sharded vocabulary (ties
planted across shards), the ``Trainer`` on a 1x2 mesh against the
reference ``Trainer``,
``adamw_update``'s global norm over sharded gradients, and
``int8_allreduce_mean``."""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import models as ref_models
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import get_config as ref_config
from repro.dist.compression import dequantize_int8 as ref_dequantize
from repro.dist.compression import quantize_int8 as ref_quantize
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_decode_fn as ref_decode_fn
from repro.launch.steps import make_prefill_fn as ref_prefill_fn
from repro.launch.steps import make_train_fn as ref_train_fn
from repro.optim import OptConfig as RefOptConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro_torch.dist.compression import dequantize_int8, quantize_int8

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
B, S = 4, 16
OPT = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=10, eps=1e-4)
LOSS_TOL = 1e-5          # relative
STATE_TOL = 1e-5         # relative L2, each updated parameter and grad_norm
LOGIT_TOL = 1e-4         # absolute
DECODE_STEPS = 4         # torch_dist_worker.DECODE_STEPS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(tmp_path, world: int, case: str, inputs: dict, *args, timeout=120):
    """Start ``world`` ranks of the worker; return what rank 0 saved."""
    inp, out = tmp_path / f"{case}-in.pt", tmp_path / f"{case}-out.pt"
    torch.save(inputs, inp)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), case, str(inp), str(out), *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"rank {r}:\n{logs[r][-3000:]}" for r, p in enumerate(procs) if p.returncode]
    assert not failed, "\n".join(failed)
    return torch.load(out, weights_only=False)


def _inputs(arch, seed=0, **overrides):
    """The reference's smoke config of ``arch`` (with ``overrides``), its
    seeded weights and a batch; the worker applies the same overrides."""
    rcfg = ref_config(arch, smoke=True).replace(**overrides)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(rcfg, seed).items()}
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if rcfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    return rcfg, {"params": params, "batch": batch, "opt": OPT, "overrides": overrides}


def _reference_steps(rcfg, inp):
    """The reference's unsharded train step, prefill and greedy decode."""
    params = {n: jnp.asarray(v) for n, v in inp["params"].items()}
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    p, _, metrics = jax.jit(ref_train_fn(rcfg, RefOptConfig(**inp["opt"])))(
        params, ref_init_opt_state(params), batch)
    prompt = {k: v for k, v in batch.items() if k in ("tokens", "frames")}
    logits, cache = jax.jit(ref_prefill_fn(rcfg))(params, prompt)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    decode, toks = jax.jit(ref_decode_fn(rcfg)), []
    for _ in range(DECODE_STEPS):
        tok, cache = decode(params, cache, tok)
        toks.append(np.asarray(tok))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {n: np.asarray(v) for n, v in p.items()},
            "logits": np.asarray(logits), "tokens": np.concatenate(toks, 1)}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


_TRACE = r"""
import json, sys
import torch
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.dist import hlo_analysis
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
from repro_torch.models import common

arch, spec, B, S, impl, whole_vocabulary, overrides = json.loads(sys.argv[1])
cfg = get_config(arch, smoke=True).replace(**overrides)
mesh = dryrun.dryrun_mesh(spec)
bundle = build_step(cfg, ShapeConfig("t", S, B, "train"), mesh, impl=impl)
if whole_vocabulary:                 # the loss's only path before it had a sharded one
    common.is_sharded = lambda logits: False
shapes = set()
record = hlo_analysis.StepTrace._record

def seen(self, func, args, kwargs, out):
    record(self, func, args, kwargs, out)
    shapes.update((tuple(t.shape), str(t.dtype).removeprefix("torch."))
                  for t in hlo_analysis._tensors(out) if isinstance(t, torch.Tensor))

hlo_analysis.StepTrace._record = seen
_, mem = dryrun.trace_step(bundle, mesh)
print(json.dumps({"shapes": sorted(shapes), "peak": mem["temp_size_in_bytes"]}))
"""


def trace_train_step(arch, mesh, *, B=8, S=64, impl="chunked", whole_vocabulary=False,
                     **overrides):
    """``arch``'s smoke config (with ``overrides``) traced through
    ``build_step``'s train step on a fake ``mesh`` (``dryrun.dryrun_mesh``)
    in a subprocess: the (shape, dtype) of every tensor an op made, and the
    step's peak bytes. ``whole_vocabulary`` sends the loss down its
    whole-vocabulary path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    arg = json.dumps([arch, mesh, B, S, impl, whole_vocabulary, overrides])
    res = subprocess.run([sys.executable, "-c", _TRACE, arg], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    return {(tuple(s), dt) for s, dt in got["shapes"]}, got["peak"]


# the cache's placements over the "model" axis on a 2x2 mesh: gemma3-1b's one
# KV head and the mamba states stay whole; two KV heads shard (seamless's,
# and zamba2's shared block's)
CACHE_MODEL_2X2 = {"gemma3-1b": {Replicate()}, "mamba2-370m": {Replicate()},
                   "seamless-m4t-large-v2": {Shard(3)},
                   "zamba2-7b": {Replicate(), Shard(3)}}


@pytest.mark.parametrize("arch", list(CACHE_MODEL_2X2))
def test_build_step_on_a_2x2_mesh_matches_the_unsharded_reference(tmp_path, arch):
    """4 ranks, 2x2 (data x model): the train step's loss, grad_norm and
    every updated parameter, the prefill logits and 4 greedy decode tokens
    against the reference's unsharded steps (an encoder-decoder's frames go
    to the train step and the prefill)."""
    rcfg, inp = _inputs(arch)
    got = _run(tmp_path, 4, "steps", inp, arch, "2x2")
    want = _reference_steps(rcfg, inp)
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    assert _rel_l2(float(got["grad_norm"]), want["grad_norm"]) <= STATE_TOL
    worst = max((_rel_l2(got["params"][n].numpy(), w), n) for n, w in want["params"].items())
    assert worst[0] <= STATE_TOL, worst
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    # the mesh really sharded: the embedding over the model axis (vocab),
    # the cache over the data axis (batch)
    assert got["placements"]["embed/tokens"] == [str(Shard(1)), str(Shard(0))]
    assert {tuple(p) for p in got["cache_placements"].values()} == {
        (str(Shard(1)), str(m)) for m in CACHE_MODEL_2X2[arch]}
    # the loss took the vocabulary-parallel path, on this device's shard
    assert got["vocab_parallel_shards"] == [(B // 2, S, rcfg.vocab_size // 2)]


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_build_step_on_a_1x1_mesh_gives_the_meshless_bits(tmp_path, arch):
    """1 rank, 1x1: the train, prefill and decode steps through DTensors
    give the same bits as the port's meshless steps."""
    _, inp = _inputs(arch)
    got = _run(tmp_path, 1, "steps", inp, arch, "1x1")
    plain = got.pop("meshless")
    assert got["vocab_parallel_shards"] == []       # a replicated vocabulary
    for key in ("loss", "grad_norm", "logits", "tokens"):
        assert torch.equal(got[key], plain[key]), key
    for n, t in plain["params"].items():
        assert torch.equal(got["params"][n], t), n


def _ref_greedy(rcfg, weights, prompt):
    """The reference's unsharded prefill, its greedy token, then one
    ``serve_step``: (the step's token, the step's logits)."""
    params = {n: jnp.asarray(v) for n, v in weights.items()}
    logits, cache = jax.jit(ref_prefill_fn(rcfg))(params, {"tokens": jnp.asarray(prompt)})
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    step_logits, _ = jax.jit(functools.partial(ref_models.decode_step, rcfg))(
        params, cache, tok)
    nxt, _ = jax.jit(ref_decode_fn(rcfg))(params, cache, tok)
    return int(np.asarray(nxt)[0, 0]), np.asarray(step_logits)[0, -1], int(tok[0, 0])


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_greedy_decode_over_a_sharded_vocabulary_matches_the_reference(tmp_path, mesh):
    """Batch 1, the logits' vocabulary sharded over the "model" axis (4 or
    2 ways): the decode step's token is the reference's unsharded
    ``serve_step`` token. Then ties are planted: two embedding rows (tied to
    the output) in different quarters of the vocabulary, neither in the
    prompt, both set to twice the winner's row, so the step's largest logit
    occurs twice, on two shards; the lower index wins, as ``jnp.argmax``
    picks it."""
    rcfg, inp = _inputs("gemma3-1b")
    prompt = inp["batch"]["tokens"][:1]
    base = inp["params"]
    want, _, first = _ref_greedy(rcfg, base, prompt)
    q = rcfg.vocab_size // 4
    used = {want, first, *prompt.ravel().tolist()}
    weight_sets, wants = [base], [want]
    for lo, hi in ((0, 3), (1, 2)):              # quarters of the vocabulary
        a = next(k for k in range(lo * q, (lo + 1) * q) if k not in used)
        b = next(k for k in reversed(range(hi * q, (hi + 1) * q)) if k not in used)
        planted = dict(base)
        emb = planted["embed/tokens"].copy()
        emb[a] = emb[b] = 2 * emb[want]
        planted["embed/tokens"] = emb
        tok, lg, _ = _ref_greedy(rcfg, planted, prompt)
        assert lg[a] == lg[b] == lg.max() and tok == a
        weight_sets.append(planted)
        wants.append(tok)
    got = _run(tmp_path, 4, "greedy", {"params": weight_sets, "tokens": prompt},
               "gemma3-1b", mesh)
    assert got["tokens"][:, 0].tolist() == wants
    # the step's logits were sharded over the vocabulary by the "model" axis
    assert all(pl[1] == str(Shard(2)) for pl in got["logit_placements"]), got



@pytest.mark.parametrize("fail_at", [-1, 4], ids=["steady", "failure-at-4"])
def test_trainer_on_a_1x2_mesh_matches_the_reference_trainer(tmp_path, fail_at):
    """2 ranks, the ``Trainer`` on a 1x2 mesh (rank 0 publishes, both load
    and train their shards, a checkpoint every 3 steps, and with a failure
    at step 4 a restart): the same loss at every step as the reference's
    ``Trainer`` on one device, and the same restarts and resume steps."""
    rcfg, inp = _inputs("gemma3-1b")
    inp.update(shape=(B, S), steps=6, checkpoint_every=3,
               opt=dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6))
    ref = RefTrainer(tmp_path / "ref", rcfg, RefShapeConfig("t", S, B, "train"),
                     make_local_mesh(),
                     RefTrainConfig(steps=6, checkpoint_every=3, fail_at_step=fail_at,
                                    opt=RefOptConfig(**inp["opt"])))
    ref.publish(inp["params"])
    want = ref.run()
    got = _run(tmp_path, 2, "trainer", inp, "gemma3-1b", "1x2", tmp_path / "port", fail_at)
    assert (got["steps_done"], got["restarts"], got["checkpoint_saves"]) == (
        want.steps_done, want.restarts, want.checkpoint_saves)
    assert got["resume_steps"] == [s["resume_step"] for s in want.startup_stats]
    # the step compiled once per program identity; a restart hits the cache
    # and loads into the program's own shards
    assert got["compile_sources"] == [s["compile_source"] for s in want.startup_stats]
    assert got["compiled_as"] == ["eager"] and got["same_state"]
    assert len(got["losses"]) == len(want.losses) == 6 + (fail_at > 0)
    np.testing.assert_allclose(got["losses"], want.losses, rtol=LOSS_TOL)


def test_trainer_on_a_1x1_mesh_trains_the_arena_in_place_with_the_meshless_bits(tmp_path):
    """1 rank: a meshless ``Trainer`` and one on a 1x1 mesh over the same
    published world give the same loss bits, and the mesh run's params are
    DTensors over views of its arena, which holds the trained values."""
    _, inp = _inputs("gemma3-1b")
    inp.update(shape=(B, S), steps=3)
    got = _run(tmp_path, 1, "trainer_local", inp, "gemma3-1b", tmp_path / "reg")
    assert len(got["mesh"]) == 3 and got["mesh"] == got["meshless"]
    assert got["views"] and got["in_place"]


def test_adamw_global_norm_is_over_every_shard(tmp_path):
    """4 ranks, 2x2: gradients sharded on either mesh axis, on both, and
    replicated; ``adamw_update``'s grad_norm is the norm of the whole
    gradients (not a sum of per-shard partial sums), and each parameter
    moves as the unsharded update moves it."""
    from repro_torch.optim import OptConfig, adamw_update, init_opt_state

    rng = np.random.default_rng(3)
    shapes = [(8, 6), (4, 10), (6, 4), (2, 2)]
    inp = {"p": [rng.standard_normal(s).astype(np.float32) for s in shapes],
           "g": [rng.standard_normal(s).astype(np.float32) for s in shapes],
           "opt": OPT}
    got = _run(tmp_path, 4, "norm", inp, "2x2")
    params = {f"p{i}": torch.from_numpy(p.copy()) for i, p in enumerate(inp["p"])}
    grads = {f"p{i}": torch.from_numpy(g) for i, g in enumerate(inp["g"])}
    with torch.no_grad():
        want_p, _, metrics = adamw_update(params, grads, init_opt_state(params),
                                          OptConfig(**OPT))
    whole = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in inp["g"])))
    assert abs(float(got["grad_norm"]) - whole) <= 1e-6 * whole
    assert abs(float(got["grad_norm"]) - float(metrics["grad_norm"])) <= 1e-6 * whole
    for n, t in want_p.items():
        torch.testing.assert_close(got["params"][n], t, rtol=1e-6, atol=1e-7)


def test_int8_allreduce_mean_at_four_ranks(tmp_path):
    """Each rank quantizes its own tensor; the gathered mean equals the mean
    of the reference's ``dequantize_int8(quantize_int8(x_r))`` over the
    four inputs."""
    rng = np.random.default_rng(5)
    xs = [(rng.standard_normal((16, 24)) * (r + 1)).astype(np.float32) for r in range(4)]
    got = _run(tmp_path, 4, "int8", {"x": xs})
    want = np.mean([np.asarray(ref_dequantize(*ref_quantize(x))) for x in xs], axis=0)
    np.testing.assert_allclose(got["mean"].numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["normal", "bf16", "zeros", "ties"])
def test_quantize_int8_gives_the_reference_bits(case):
    """The codes and the scale are the reference's bits on the same input
    (round half to even included), and dequantizing gives its values."""
    rng = np.random.default_rng(7)
    if case == "zeros":
        x = np.zeros((5, 7), np.float32)
    elif case == "ties":               # values on half steps of the grid
        x = (np.arange(-254, 255, dtype=np.float32) / 2.0)
    else:
        x = (rng.standard_normal((33, 17)) * 3).astype(np.float32)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if case == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    q, s = quantize_int8(xt)
    rq, rs = ref_quantize(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_dequantize(rq, rs)))
