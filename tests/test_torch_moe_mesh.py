"""The MoE family and the chunked attention on a device mesh.

``models/moe.py`` runs the route, the scatter into (B, E, C, d) and the
gather back on each device's batch rows, and the expert products on each
device's experts; ``models/common.py``'s ``chunked_attention`` runs its
online-softmax loop on each device's batch rows and heads
(``dist/heads.py``). Here:

* olmoe-1b-7b and qwen2-moe-a2.7b through ``build_step`` on 2x2 and 1x2
  gloo meshes (and qwen2-moe at 3 experts, which the 2-way "model" axis
  does not divide, so the expert weights shard their hidden axis instead,
  as qwen2-moe's 60 experts do over 16 devices) against the reference's
  unsharded train step, prefill and greedy decode (the 1x4 cases are in
  ``tests/test_torch_loss_parallel.py``);
* olmoe on a 1x1 mesh: the meshless steps' bits;
* traced train steps on a fake 1x4 mesh: zamba2-7b's smoke config never
  makes a chunked-attention accumulator of q's global shape, and olmoe's
  step runs to its end with each device's expert products on its own
  experts; on a fake 2x2 mesh zamba2's shared block keeps each device's
  batch rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from test_torch_dist import (B, LOGIT_TOL, LOSS_TOL, S, STATE_TOL, _inputs, _reference_steps,
                             _rel_l2, _run, trace_train_step)

MESHES = {"2x2": 4, "1x2": 2}


def _check(got, want):
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    assert _rel_l2(float(got["grad_norm"]), want["grad_norm"]) <= STATE_TOL
    worst = max((_rel_l2(got["params"][n].numpy(), w), n) for n, w in want["params"].items())
    assert worst[0] <= STATE_TOL, worst
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_build_step_on_a_mesh_matches_the_unsharded_reference(tmp_path, arch, mesh):
    """The train step's loss, grad_norm and every updated parameter, the
    prefill logits and 4 greedy decode tokens against the reference's
    unsharded steps; each expert product ran on this device's batch rows
    and its half of the experts (the smoke config's 4 experts over the
    2-way "model" axis)."""
    rcfg, inp = _inputs(arch)
    got = _run(tmp_path, MESHES[mesh], "steps", inp, arch, mesh)
    _check(got, _reference_steps(rcfg, inp))
    rows = B // 2 if mesh == "2x2" else B
    E, k = rcfg.num_experts, rcfg.experts_per_token
    C = -(-k * S * 5 // (E * 4))                  # capacity at factor 1.25
    assert rcfg.capacity_factor == 1.25
    assert set(got["expert_shards"]) == {(rows, E // 2, C, rcfg.d_model)}
    assert got["placements"]["blocks/experts/w_gate"][1] == str(Shard(1))


def test_moe_experts_the_model_axis_does_not_divide(tmp_path):
    """qwen2-moe-a2.7b's smoke config at 3 experts on a 1x2 mesh: the
    expert weights shard their hidden axis over "model", each device's
    buffer holds every expert, and the down projection's partial sums are
    reduced before the gather back; the steps match the reference's."""
    rcfg, inp = _inputs("qwen2-moe-a2.7b", num_experts=3)
    got = _run(tmp_path, 2, "steps", inp, "qwen2-moe-a2.7b", "1x2")
    _check(got, _reference_steps(rcfg, inp))
    assert got["placements"]["blocks/experts/w_gate"] == [str(Replicate()), str(Shard(3))]
    assert {s[:2] for s in got["expert_shards"]} == {(B, 3)}


def test_moe_build_step_on_a_1x1_mesh_gives_the_meshless_bits(tmp_path):
    """1 rank, olmoe-1b-7b on a 1x1 mesh: the train, prefill and decode
    steps through DTensors give the same bits as the meshless steps."""
    _, inp = _inputs("olmoe-1b-7b")
    got = _run(tmp_path, 1, "steps", inp, "olmoe-1b-7b", "1x1")
    plain = got.pop("meshless")
    for key in ("loss", "grad_norm", "logits", "tokens"):
        assert torch.equal(got[key], plain[key]), key
    for n, t in plain["params"].items():
        assert torch.equal(got["params"][n], t), n


def test_traced_step_on_a_fake_1x4_mesh_keeps_each_attention_accumulator_local():
    """zamba2-7b's smoke config (4 heads of 32, 2 KV heads), batch 8 x 64,
    its train step traced on a fake 1x4 mesh with the chunked attention:
    no float32 tensor of q's global (b, h, sq, hd) shape is allocated, nor
    of its (b, h, sq) row statistics; each device's accumulators hold its
    one head (it reads its KV head, sliced from the whole pair). Before
    the repair they were made at the global shape on every device."""
    shapes, _ = trace_train_step("zamba2-7b", "1x4")
    for whole in ((8, 4, 64, 32), (8, 4, 64)):
        assert (whole, "float32") not in shapes, whole
    assert ((8, 1, 64, 32), "float32") in shapes
    assert ((8, 1, 64), "float32") in shapes


def test_traced_moe_step_on_a_fake_1x4_mesh_runs_to_its_end():
    """olmoe-1b-7b's smoke config, batch 8 x 64, its train step traced on a
    fake 1x4 mesh: the step runs to its end, and the expert products ran
    on each device's one of the 4 experts (its (8, 1, C, 64) buffer and
    (8, 1, C, 32) hidden activations)."""
    shapes, peak = trace_train_step("olmoe-1b-7b", "1x4")
    C = -(-2 * 64 * 5 // (4 * 4))
    assert ((8, 1, C, 64), "float32") in shapes
    assert ((8, 1, C, 32), "float32") in shapes
    assert peak > 0


def test_traced_hybrid_step_on_a_fake_2x2_mesh_keeps_the_shared_block_on_its_rows():
    """zamba2-7b's smoke config, batch 8 x 64, its train step traced on a
    fake 2x2 mesh: the shared block's concat(x, x0) (width 2d = 128) and
    its attention accumulators hold this device's 4 rows, never the whole
    batch (the embeddings are placed as the mamba layers' inputs, and the
    block's weights gathered over "data" at use; before, the batch was
    gathered whole at the concat)."""
    shapes, _ = trace_train_step("zamba2-7b", "2x2")
    assert ((4, 64, 128), "float32") in shapes
    assert ((8, 64, 128), "float32") not in shapes
    assert ((4, 2, 64, 32), "float32") in shapes
    assert not any(len(s) == 4 and s[0] == 8 and s[2:] == (64, 32) for s, _ in shapes)
