"""The plain references against the program's plain path at the program's
reduced sizes on the CPU: equal in float32, apart in a lower precision;
and the control of the served-token check, at that size."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from bench.cell import ROOT
from bench.model import program_config
from bench.reference import logits
from bench.reference.olmoe import kept_slots
from bench.weights import make_weights


TOL = 1e-4     # float32 against float32: rounding of sums in other orders


def _smoke(name: str, dtype: str = "float32"):
    from repro_torch import models

    conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    conf["dtype"] = dtype
    cfg, conf = program_config(conf, smoke=True)
    return cfg, conf, make_weights(models.param_specs(cfg), 2**31 + 5, "cpu")


def _served_logits(cfg, w, prompt, fed):
    """The program's prefill of ``prompt``, then one decode step per token
    of ``fed``: the logits at every position after the prompt's last."""
    from repro_torch import models

    with torch.inference_mode():
        lg, cache = models.prefill(cfg, w, {"tokens": prompt[None].int()}, impl="naive",
                                   cache_len=len(prompt) + len(fed))
        out = [lg[0, -1].float()]
        for t in fed[:-1]:
            lg, cache = models.decode_step(cfg, w, cache, t.view(1, 1).int())
            out.append(lg[0, -1].float())
    return torch.stack(out)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-370m"])
def test_reference_is_the_program_in_float32_and_not_below(name):
    cfg, conf, w = _smoke(name)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (40,), generator=g)
    fed = torch.randint(0, cfg.vocab_size, (6,), generator=g)
    got = _served_logits(cfg, w, prompt, fed)
    seq = torch.cat([prompt, fed[:-1]])
    scale = got.abs().max()
    ref = logits(w, conf, seq, len(prompt), "f32")[len(prompt) - 1:]
    assert (ref - got).abs().max() <= TOL * scale
    for prec in ("bf16", "fp8"):
        low = logits(w, conf, seq, len(prompt), prec)[len(prompt) - 1:]
        assert (low - got).abs().max() > 10 * TOL * scale, prec


def test_capacity_drops_slots_in_the_prompt_only():
    _, conf, _ = _smoke("olmoe-1b-7b")
    top_e = torch.tensor([[0, 1]] * 5 + [[0, 2]] * 3)
    keep = kept_slots(top_e, prompt_len=6, E=4, cf=1.25)     # cap ceil(2*6/4*1.25) = 4
    # experts 0 and 1 take tokens 0-3 and drop token 4; token 5's expert 2
    # is its first; the two decoded tokens have no cap
    want = [[True, True]] * 4 + [[False, False], [False, True]] + [[True, True]] * 2
    assert keep.tolist() == want


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-370m"])
def test_the_control_fails_where_the_program_passes(name):
    """At the reduced size, in the configuration's bfloat16: on the tokens
    the program serves greedily, the float8 control's gaps lie far above
    the program's, by both numbers a check may compare."""
    from repro_torch.serve import ServeEngine

    from bench import compare

    cfg, conf, w = _smoke(name, "bfloat16")
    g = torch.Generator().manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (4, 24), generator=g).numpy()
    out, _ = ServeEngine(cfg, w, cache_len=24 + 16, device="cpu").generate(prompts, 16)
    served, ctrl = [], []
    for p, t in zip(prompts, out):
        gap, low = compare.gaps(w, conf, p, t, "cpu", "fp8")
        served.append(gap)
        ctrl.append(low)
    r = compare.readings(served, ctrl)
    assert r["control_gap_mean"] > 3 * r["logit_gap_mean"], r
    assert r["control_gap"] > r["logit_gap"], r


def test_smoke_configs_copy_the_file():
    conf = json.loads((ROOT / "bench/configs/olmoe-1b-7b.json").read_text())
    before = copy.deepcopy(conf)
    program_config(conf, smoke=True)
    assert conf == before


def test_the_control_is_not_correct_at_the_cells_own_limits():
    """The chat cell run at the reduced size with the float8 control read on
    its sample: the control's gaps, put in the program's place, fail the
    cell's own limits (``bench/checks/<cell>.json``) through the run's
    comparison, where the program's pass them. (The start cell's limit is a
    widest gap at the full size's logit scale, which the reduced model's
    logits do not reach in either precision; its control is judged on the
    card by ``bench/control.py``, below.)"""
    from bench import compare

    from .smoke import run_smoke

    out = run_smoke("olmoe-1b-7b.chat", limit=None, control="fp8")
    limits = {n: c["limit"] for n, c in out["checks"].items() if n != "unchecked"}
    ctrl = compare.control_checks(out["readings"], limits)
    assert ctrl and set(ctrl) == set(limits), (ctrl, out["checks"])
    assert not compare.passed(ctrl), ctrl
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_the_control_command_judges_at_the_cells_limits(name, scale, monkeypatch, capsys):
    """``bench/control.py`` holds the control's readings to the cell's own
    limits: readings at half of each limit pass, so the command fails (exit
    1); readings at twice each fail, as a sound limit needs (exit 0)."""
    from bench import compare, control
    from bench.cell import resolve

    limits = resolve(name).checks["limits"]
    readings = {"logit_gap": 0.0, "logit_gap_mean": 0.0}
    readings.update({"control_" + n[len("logit_"):]: scale * lim for n, lim in limits.items()})
    fake = {"correct": True, "readings": readings, "metrics": {},
            "checks": compare.checks(readings, limits)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(control, "run_cell", lambda *a, **k: fake)
    rc = control.main(["--workload", name, "--seeds", "1,2", "--seconds", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["control_correct"] for x in lines] == [scale < 1] * 2
    assert rc == (1 if scale < 1 else 0)
