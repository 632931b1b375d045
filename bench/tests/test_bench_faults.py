"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU, at the program's reduced size, with one fault planted in the
program for the run's length: a decode step that returns its state
unchanged; half of the batch left out (the logits of every other slot zero); a token altered
where it is produced; for a replica start, an arena left as it was (the
page copy skipped). The cells run on one card, so there is no exchange
between cards to leave out.
"""

from __future__ import annotations

import pytest
import torch

from .smoke import root_with, run_smoke

SERVING = ["olmoe-1b-7b.chat", "mamba2-370m.chat"]


def _root(name, tmp_path):
    """The SSM's serving path is no cell of BENCHMARK.json (PERF.md §7); it
    is tested as a cell of a copy, compared by its widest gap."""
    if name == "mamba2-370m.chat":
        return root_with(tmp_path, name, "mamba2-370m", "chat",
                         {"sample_requests": 8, "limits": {"logit_gap": 0.45}})
    return None


def _state_unchanged(orig):
    def step(cfg, params, cache, tokens):
        saved = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
        logits, new = orig(cfg, params, cache, tokens)
        for k, v in saved.items():
            new[k].copy_(v)
        return logits, new
    return step


def _half_batch(orig):
    def step(cfg, params, cache, tokens):
        logits, new = orig(cfg, params, cache, tokens)
        logits = logits.clone()
        logits[1::2] = 0                 # every other slot: the low slots fill first
        return logits, new
    return step


def _altered(orig):
    def pick(logits, keys, counters, **kw):
        return (orig(logits, keys, counters, **kw) + 1) % logits.shape[-1]
    return pick


@pytest.mark.parametrize("name", SERVING)
def test_sound_run_is_correct(name, tmp_path):
    assert run_smoke(name, root=_root(name, tmp_path))["correct"]


@pytest.mark.parametrize("name", SERVING)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
def test_faulted_serving_is_not_correct(name, fault, monkeypatch, tmp_path):
    from repro_torch import models
    from repro_torch.serve import scheduler

    if fault == "token_altered":
        monkeypatch.setattr(scheduler, "pick_tokens", _altered(scheduler.pick_tokens))
    else:
        wrap = _state_unchanged if fault == "state_unchanged" else _half_batch
        monkeypatch.setattr(models, "decode_step", wrap(models.decode_step))
    out = run_smoke(name, root=_root(name, tmp_path))
    assert not out["correct"], out["checks"]


def test_sound_start_is_correct():
    assert run_smoke("mamba2-370m.replica-start")["correct"]


def test_start_with_arena_unchanged_is_not_correct(monkeypatch):
    import repro_torch.kernels.paged_reloc_copy as prc

    monkeypatch.setattr(prc, "paged_reloc_copy", lambda blob, arena, src, dst: arena)
    out = run_smoke("mamba2-370m.replica-start")
    assert not out["correct"] and out["checks"]["arena_mismatch"]["value"] > 0


def test_start_with_token_altered_is_not_correct(monkeypatch):
    from repro_torch.serve import ServeEngine

    orig = ServeEngine.generate

    def generate(self, prompts, max_new_tokens):
        toks, stats = orig(self, prompts, max_new_tokens)
        return (toks + 1) % self.cfg.vocab_size, stats

    monkeypatch.setattr(ServeEngine, "generate", generate)
    out = run_smoke("mamba2-370m.replica-start")
    assert not out["correct"] and out["checks"]["logit_gap"]["value"] > 0.05
