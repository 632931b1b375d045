"""The port's training substrate against the reference's, on the same numpy
inputs from a seed: rmsnorm's gradient (the closed form and autograd
through the plain version, against ``jax.vjp`` of the reference's jnp
``rms_norm``), AdamW (``adamw_update``, ``lr_at``, clipping) and the
synthetic data pipeline (byte-equal batches, seek, prefetch order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.data import make_batch as ref_make_batch
from repro.models.common import rms_norm as ref_rms_norm
from repro.optim import OptConfig as RefOptConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import init_opt_state as ref_init_opt_state
from repro.optim import lr_at as ref_lr_at
from repro_torch.data import Prefetcher, SyntheticTokens, make_batch, to_device
from repro_torch.kernels.rmsnorm import rmsnorm_backward_plain, rmsnorm_plain
from repro_torch.optim import OptConfig, adamw_update, init_opt_state, lr_at

# (abs, rel): float32 on both sides, sums in another order; bf16 rounds dx
# and dscale once, at other places than XLA may
RMS_BWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (3e-2, 2.0**-7)}
OPT_TOL = 1e-6


def _within(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - rtol * np.abs(want)
    assert excess.max() <= atol, f"{what}: worst excess {excess.max()} over {atol}"


# --------------------------------------------------------- rmsnorm backward
@pytest.mark.parametrize("d", [7, 300, 1152, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_vjp_of_reference(d, dtype):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    s = (1.0 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((3, 5, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b: ref_rms_norm(a, b), jnp.asarray(x, jdt),
                     jnp.asarray(s, jdt))
    want_dx, want_ds = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(dy, jdt)))

    tdt = getattr(torch, dtype)
    xt, st, dyt = (torch.from_numpy(a).to(tdt) for a in (x, s, dy))
    dx, ds = rmsnorm_backward_plain(xt, st, dyt)
    assert dx.dtype == tdt and ds.dtype == tdt and ds.shape == (d,)
    xg, sg = xt.clone().requires_grad_(), st.clone().requires_grad_()
    auto_dx, auto_ds = torch.autograd.grad(rmsnorm_plain(xg, sg), (xg, sg), dyt)
    atol, rtol = RMS_BWD_TOL[dtype]
    for what, got, want in (("dx", dx, want_dx), ("dscale", ds, want_ds),
                            ("autograd dx", auto_dx, want_dx),
                            ("autograd dscale", auto_ds, want_ds)):
        _within(got.float().numpy(), want, atol, rtol, f"{what} d={d} {dtype}")


# -------------------------------------------------------------------- AdamW
def _opt_pair(**kw):
    return RefOptConfig(**kw), OptConfig(**kw)


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference_over_five_steps(clip):
    rcfg, cfg = _opt_pair(peak_lr=1e-2, min_lr=1e-3, warmup_steps=2, decay_steps=4,
                          weight_decay=0.1, clip_norm=clip)
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "e": (4, 3, 5)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    ref_p = {n: jnp.asarray(a) for n, a in params.items()}
    ref_s = ref_init_opt_state(ref_p)
    p = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    st = init_opt_state(p)
    for step in range(5):
        grads = {n: (rng.standard_normal(s) * 3).astype(np.float32)
                 for n, s in shapes.items()}
        ref_p, ref_s, ref_m = ref_adamw_update(
            ref_p, {n: jnp.asarray(g) for n, g in grads.items()}, ref_s, rcfg)
        with torch.no_grad():
            p, st, m = adamw_update(p, {n: torch.from_numpy(g) for n, g in grads.items()},
                                    st, cfg)
        assert int(st["step"]) == int(ref_s["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=OPT_TOL)
        for n in shapes:
            for what, got, want in (("param", p[n], ref_p[n]),
                                    ("m", st["m"][n], ref_s["m"][n]),
                                    ("v", st["v"][n], ref_s["v"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OPT_TOL,
                                           atol=OPT_TOL, err_msg=f"{what} {n} step {step}")
    clipped = float(ref_m["grad_norm"]) > clip
    assert clipped == (clip == 1.0)


def test_adamw_updates_params_and_moments_in_place():
    p = {"w": torch.ones(4)}
    st = init_opt_state(p)
    ids = (p["w"].data_ptr(), st["m"]["w"].data_ptr(), st["v"]["w"].data_ptr(),
           st["step"].data_ptr())
    with torch.no_grad():
        p2, st2, _ = adamw_update(p, {"w": torch.full((4,), 0.5)}, st, OptConfig())
    assert (p2["w"].data_ptr(), st2["m"]["w"].data_ptr(), st2["v"]["w"].data_ptr(),
            st2["step"].data_ptr()) == ids
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    assert bool((st["m"]["w"] != 0).all()) and bool((p["w"] != 1).all())


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_lr_at_matches_reference(step):
    rcfg, cfg = _opt_pair(peak_lr=1.0, min_lr=0.1, warmup_steps=10, decay_steps=100)
    got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(ref_lr_at(rcfg, jnp.int32(step))), rel=OPT_TOL)


def test_lr_schedule_warmup_and_decay():
    cfg = OptConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10, decay_steps=100)
    at = lambda s: float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
    assert at(5) == pytest.approx(0.5)
    assert at(10) == pytest.approx(1.0, rel=1e-3)
    assert at(100) == pytest.approx(0.1, rel=1e-3)


def test_adamw_minimizes_quadratic():
    cfg = OptConfig(peak_lr=0.1, min_lr=0.05, warmup_steps=1, decay_steps=1000,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    with torch.no_grad():
        for _ in range(300):
            params, state, _ = adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clipping_reports_the_norm_before_clipping():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=0, decay_steps=10, clip_norm=1.0,
                    weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    with torch.no_grad():
        params, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5
    # Adam's first step is a unit step whatever the clipped gradient's size
    assert float(params["w"].abs().max()) == pytest.approx(float(metrics["lr"]), rel=1e-6)


def test_init_opt_state_is_float32_beside_bf16_params():
    params = {"w": torch.zeros((3, 2), dtype=torch.bfloat16), "b": torch.zeros(2)}
    st = init_opt_state(params)
    for mv in ("m", "v"):
        assert {n: (t.dtype, tuple(t.shape)) for n, t in st[mv].items()} == {
            "w": (torch.float32, (3, 2)), "b": (torch.float32, (2,))}
    assert st["step"].shape == () and st["step"].dtype == torch.int32


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,shard,shards,frames", [
    (0, 0, 0, 1, 0), (0, 3, 1, 4, 0), (7, 11, 3, 4, 0), (2**20 + 3, 5, 0, 2, 8),
    (1, 1, 1, 2, 16)])
def test_make_batch_is_the_reference_byte_for_byte(seed, step, shard, shards, frames):
    kw = dict(vocab_size=1000, global_batch=8, seq_len=16, step=step, seed=seed,
              shard=shard, num_shards=shards, with_frames=frames)
    got, want = make_batch(**kw), ref_make_batch(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_synthetic_tokens_follow_the_reference_stream():
    kw = dict(vocab_size=50, global_batch=2, seq_len=8, seed=3, start_step=2)
    ours, ref = SyntheticTokens(**kw), RefSyntheticTokens(**kw)
    for _ in range(4):
        a, b = next(ours), next(ref)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["labels"].tobytes() == b["labels"].tobytes()


def test_data_seek_resume():
    it = SyntheticTokens(vocab_size=50, global_batch=2, seq_len=8)
    b0, b1, b2 = next(it), next(it), next(it)
    it.seek(1)
    np.testing.assert_array_equal(next(it)["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])


def test_prefetcher_preserves_order_and_transforms_on_the_consumer():
    it = SyntheticTokens(vocab_size=50, global_batch=2, seq_len=8)
    direct = [next(it)["tokens"] for _ in range(5)]
    fetched = Prefetcher(SyntheticTokens(vocab_size=50, global_batch=2, seq_len=8),
                         transform=lambda b: to_device(b, "cpu"))
    for want in direct:
        got = next(fetched)["tokens"]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_prefetcher_close_ends_the_producer_of_an_endless_stream():
    fetched = Prefetcher(SyntheticTokens(vocab_size=50, global_batch=2, seq_len=8),
                         depth=1)
    next(fetched)
    fetched._thread.join(timeout=0.2)
    assert fetched._thread.is_alive()        # blocked on the full queue
    fetched.close()
    assert not fetched._thread.is_alive()


def test_to_device_gives_contiguous_tensors_of_the_batch():
    b = make_batch(vocab_size=100, global_batch=4, seq_len=8, step=0, with_frames=4)
    t = to_device(b, "cpu")
    for k, v in b.items():
        assert t[k].is_contiguous() and t[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(t[k].numpy(), v)
