"""The vocabulary-parallel cross entropy (``repro_torch.models.common``).

On a mesh whose "model" axis shards the vocabulary, the loss runs as local
math on each shard (``shard_lse``, ``shard_label_logit``, ``shard_grad``)
and a combine step (``combine_shards``) that reduces over the shards with
the reductions it is given. Here:

* the shard functions and the combine over 1, 2, 4 and 16 vocabulary
  slices in one process (a max and a sum over the stacked shards), held
  against the port's plain ``cross_entropy`` and the reference's
  ``repro.models.common.cross_entropy`` with ``jax.grad`` on the same
  seeded numpy logits, float32 and bfloat16, with and without a mask;
* ``build_step``'s train step on a 1x4 gloo mesh (4 ranks, the vocabulary
  in quarters) and on a 2x1 one (2 ranks, the batch in halves, the
  vocabulary replicated) against the reference's unsharded step (the 2x2
  case is in ``tests/test_torch_dist.py``);
* a traced train step on a fake 1x4 mesh: no tensor holds the whole
  vocabulary at the whole batch, and the step's peak bytes fall against the
  same trace taken through the whole-vocabulary path that the loss took
  before it had a vocabulary-parallel path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import cross_entropy as ref_cross_entropy
from repro_torch.models.common import (
    cross_entropy,
    nll_over_shards,
    shard_grad,
    shard_label_logit,
)
from test_torch_dist import B as DIST_B
from test_torch_dist import (LOGIT_TOL, LOSS_TOL, STATE_TOL, _inputs, _reference_steps,
                             _rel_l2, _run, trace_train_step)
from test_torch_dist import S as DIST_S

B, S, V = 3, 7, 256
GRAD_TOL = 1e-5          # relative L2 of dlogits


def _logits(dtype: str, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    return xt, xj, labels, mask


def _over_shards(x, labels, mask, n):
    """Loss, dlogits and lse from ``n`` vocabulary slices of ``x`` through
    ``nll_over_shards`` (the shard functions and the combine's
    single-process form)."""
    loss, grads, lse = nll_over_shards(x.split(x.shape[-1] // n, dim=-1), labels, mask)
    return loss, torch.cat(grads, dim=-1), lse


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_shards_and_combine_match_the_plain_and_the_reference_loss(n, dtype, masked):
    xt, xj, labels, mask = _logits(dtype)
    lab_t = torch.from_numpy(labels)
    mask_t = torch.from_numpy(mask) if masked else None
    loss, grad, _ = _over_shards(xt, lab_t, mask_t, n)

    leaf = xt.clone().requires_grad_()
    plain = cross_entropy(leaf, lab_t, mask_t)
    (plain_grad,) = torch.autograd.grad(plain, leaf)
    plain = plain.detach()
    mask_j = jnp.asarray(mask) if masked else None
    ref_loss, ref_grad = jax.value_and_grad(
        lambda z: ref_cross_entropy(z, jnp.asarray(labels), mask_j))(xj)
    ref_grad = np.asarray(ref_grad.astype(jnp.float32))

    assert abs(float(loss) - float(plain)) <= LOSS_TOL * abs(float(plain))
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    assert grad.dtype == xt.dtype
    assert _rel_l2(grad.float().numpy(), plain_grad.float().numpy()) <= GRAD_TOL
    assert _rel_l2(grad.float().numpy(), ref_grad) <= GRAD_TOL
    if n == 1:       # one shard: the whole tensor's loss, bit for bit
        assert torch.equal(loss, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_slice_gives_logsumexps_bits(dtype):
    """With one shard the combine's ``M + log(sum exp(lse_r - M))`` is
    ``torch.logsumexp``'s own result, bit for bit; with several it differs
    from it by float32 rounding only."""
    xt, _, labels, _ = _logits(dtype, seed=1)
    want = torch.logsumexp(xt.float(), dim=-1)
    _, _, lse = _over_shards(xt, torch.from_numpy(labels), None, 1)
    assert torch.equal(lse, want)
    for n in (2, 4, 16):
        _, _, lse = _over_shards(xt, torch.from_numpy(labels), None, n)
        torch.testing.assert_close(lse, want, rtol=1e-6, atol=0)


def test_label_logit_is_counted_on_exactly_one_shard():
    """Every label lies in exactly one slice: the masked label logits sum
    to the gathered logit, and a shard's gradient subtracts g only at its
    own labels."""
    xt, _, labels, _ = _logits("float32", seed=2)
    lab = torch.from_numpy(labels)
    w = V // 4
    parts = [shard_label_logit(s, lab, i * w) for i, s in enumerate(xt.split(w, -1))]
    assert torch.equal(((torch.stack(parts) != 0).sum(0)), torch.ones_like(lab))
    torch.testing.assert_close(sum(parts), torch.gather(xt, -1, lab[..., None].long())[..., 0],
                               rtol=0, atol=0)
    lse = torch.logsumexp(xt, -1)
    g = torch.ones(B, S)
    for i, s in enumerate(xt.split(w, -1)):
        d = shard_grad(s, lab, i * w, lse, g) - torch.exp(s - lse[..., None])
        inside = (lab >= i * w) & (lab < (i + 1) * w)
        assert torch.equal((d != 0).sum(-1), inside.long())


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m", "zamba2-7b", "olmoe-1b-7b",
                                  "qwen2-moe-a2.7b"])
def test_build_step_on_a_1x4_mesh_matches_the_unsharded_reference(tmp_path, arch):
    """4 ranks, 1x4 (the vocabulary in quarters over "model", the batch
    whole): the train step's loss, grad_norm and every updated parameter,
    the prefill logits and 4 greedy decode tokens against the reference's
    unsharded steps; the loss ran on each rank's quarter."""
    rcfg, inp = _inputs(arch)
    got = _run(tmp_path, 4, "steps", inp, arch, "1x4")
    want = _reference_steps(rcfg, inp)
    assert got["vocab_parallel_shards"] == [(DIST_B, DIST_S, rcfg.vocab_size // 4)]
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    assert _rel_l2(float(got["grad_norm"]), want["grad_norm"]) <= STATE_TOL
    worst = max((_rel_l2(got["params"][n].numpy(), w), n) for n, w in want["params"].items())
    assert worst[0] <= STATE_TOL, worst
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])



@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_build_step_on_a_2x1_mesh_keeps_the_loss_on_each_batch_shard(tmp_path, arch):
    """2 ranks, 2x1 (the batch in halves over "data", the vocabulary
    replicated): the loss ran on each rank's half of the batch with the
    whole vocabulary and no reduction over it, and the train step's loss,
    grad_norm and every updated parameter match the reference's unsharded
    step."""
    rcfg, inp = _inputs(arch)
    got = _run(tmp_path, 2, "steps", inp, arch, "2x1")
    want = _reference_steps(rcfg, inp)
    assert got["vocab_parallel_shards"] == [(DIST_B // 2, DIST_S, rcfg.vocab_size)]
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    assert _rel_l2(float(got["grad_norm"]), want["grad_norm"]) <= STATE_TOL
    worst = max((_rel_l2(got["params"][n].numpy(), w), n) for n, w in want["params"].items())
    assert worst[0] <= STATE_TOL, worst
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])

def test_traced_step_on_a_fake_1x4_mesh_never_holds_the_whole_vocabulary():
    """gemma3-1b's smoke config at a vocabulary of 4096 (so that the loss's
    tensors dominate the step), batch 8 x 64, traced on a fake 1x4 mesh.
    Through the vocabulary-parallel loss no tensor has the whole vocabulary
    as its last axis at the whole batch; through the whole-vocabulary path
    (the loss's only path before, forced here by declaring the logits
    unsharded) such tensors appear, and the step's peak bytes are higher
    by more than one float32 logits tensor of the whole vocabulary (the
    gathered logits; at this size the two paths' peaks measured 19.19 and
    6.60 MB)."""
    B, S, V = 8, 64, 4096
    got = {}
    for path in ("vocab_parallel", "whole_vocabulary"):
        shapes, peak = trace_train_step("gemma3-1b", "1x4", B=B, S=S, vocab_size=V,
                                        whole_vocabulary=path == "whole_vocabulary")
        shapes = {s for s, _ in shapes}
        got[path] = {"peak": peak, "shards": (B, S, V // 4) in shapes,
                     "whole": any(s and s[-1] == V and torch.Size(s[:-1]).numel() == B * S
                                  for s in shapes)}
    new, old = got["vocab_parallel"], got["whole_vocabulary"]
    assert not new["whole"] and new["shards"]
    assert old["whole"]
    assert old["peak"] - new["peak"] > 8 * 64 * 4096 * 4, got
