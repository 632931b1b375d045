"""The port's serving path end to end against the reference's: one
Workspace root, published by the port, served by both engines."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import EpochCache as RefEpochCache
from repro.link import Workspace as RefWorkspace
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core import EpochCache
from repro_torch.core.errors import AdoptDeadlineError
from repro_torch.launch import serve as launch_serve
from repro_torch.link import Workspace
from repro_torch.serve import ServeEngine, faults

ARCH = "gemma3-1b"
PROMPT, NEW = 20, 6           # prompt longer than the smoke window of 16


@pytest.fixture()
def roots(tmp_path):
    """(port workspace, reference workspace) on one root the port published."""
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = launch_serve.publish_model(ws, get_config(ARCH, smoke=True), device="cpu")
    ref = RefWorkspace.open(ws.root, epoch_cache=RefEpochCache())
    return ws, ref, app


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (3, PROMPT), dtype=np.int32)


def _engines(roots):
    ws, ref, app = roots
    port = ServeEngine.from_workspace(
        get_config(ARCH, smoke=True), ws, app, cache_len=PROMPT + NEW, device="cpu")
    want = RefServeEngine.from_workspace(
        ref_config(ARCH, smoke=True), ref, app, cache_len=PROMPT + NEW)
    return port, want


def _commit_v2(ws, seed=1):
    cfg = get_config(ARCH, smoke=True)
    params = models.init_params(cfg, seed, "cpu")
    bundle, payload = bundle_from_params(
        f"weights:{cfg.name}", "v2", params, specs=models.param_specs(cfg))
    with ws.management() as tx:
        tx.publish(bundle, payload)


def test_port_and_reference_engines_generate_the_same_tokens(roots):
    port, want = _engines(roots)
    assert port.load_stats.strategy == "stable-mmap-cached"
    got, stats = port.generate(_prompts(), NEW)
    ref, _ = want.generate(_prompts(), NEW)
    assert got.shape == (3, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert stats.tokens_out == 3 * NEW and stats.prefill_s > 0


def test_adopt_epoch_flips_both_engines_to_the_new_weights(roots):
    ws, ref_ws, app = roots
    port, want = _engines(roots)
    before, _ = port.generate(_prompts(1), NEW)
    _commit_v2(ws)
    port.adopt_epoch(ws, app, deadline_s=30.0)
    want.adopt_epoch(ref_ws, app)
    got, _ = port.generate(_prompts(1), NEW)
    ref, _ = want.generate(_prompts(1), NEW)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, before)


def test_wedged_adopt_rolls_back_to_the_served_weights(roots):
    ws, _, app = roots
    port, _ = _engines(roots)
    old = {n: t.clone() for n, t in port.params.items()}
    _commit_v2(ws)
    faults.install(faults.FaultPlan(wedge_adopt_s=30.0))
    try:
        with pytest.raises(AdoptDeadlineError) as exc:
            port.adopt_epoch(ws, app, deadline_s=0.25)
    finally:
        faults.clear()
    assert exc.value.rolled_back_to == ws.epoch_gen
    assert all(torch.equal(old[n], port.params[n]) for n in old)


def test_launcher_serves_the_smoke_config(roots):
    ws, ref_ws, _ = roots
    run = launch_serve.serve(get_config(ARCH, smoke=True), ws, batch=2,
                             prompt_len=PROMPT, max_new=4, device="cpu")
    assert run.summary["load_strategy"] == "stable"
    assert run.summary["out_shape"] == [2, 4]
    assert run.tokens.min() >= 0 and run.tokens.max() < 256
    want = RefServeEngine.from_workspace(ref_config(ARCH, smoke=True), ref_ws,
                                         f"serve:{run.engine.cfg.name}",
                                         strategy="stable", cache_len=PROMPT + 4)
    ref, _ = want.generate(run.prompts, 4)
    np.testing.assert_array_equal(run.tokens, ref)


def test_launcher_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
        "--max-new", "3", "--device", "cpu", "--registry", str(tmp_path / "r")])
    launch_serve.main()
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["out_shape"] == [2, 3]
