"""The comparison that decides ``correct``, and its control.

A served token is judged by the plain float32 reference run once over its
request's prompt and served tokens (teacher forcing): its gap is how far
the reference's logit for it lies below the reference's best logit at that
position. A greedy server in the configuration's precision picks the
reference's best or a token within rounding of it; a wrong state, a wrong
cache row or an altered token lies far below. The number compared is the
widest gap over a sample of the run's finished requests, drawn from the
seed with the longest among them.

The control puts the reference, computed in the precision below the
configuration's (``reference.precision.control``), in the program's place:
at each position of the same prompts and tokens, the gap of the token that
it puts first. Its gaps, held to the cell's limits in the program's place
(``control_checks``), have to come out not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import reference


def sample(lengths: dict, n: int, seed: int) -> list:
    """``n`` keys of ``lengths`` ({key: tokens}): the longest, then others
    drawn from the seed."""
    if not lengths:
        return []
    keys = sorted(lengths)
    longest = max(keys, key=lambda k: (lengths[k], -k))
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(picked)]


def gaps(weights, conf, prompt, tokens, device, prec: str | None = None):
    """Per served token: (the gap of the served token, and with ``prec`` the
    gap of the token the ``prec`` reference puts first), float32 (T,)."""
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    toks = torch.as_tensor(np.asarray(tokens), device=device).long()
    seq = torch.cat([prompt, toks[:-1]])
    P = prompt.shape[0]
    with torch.inference_mode():
        ref = reference.logits(weights, conf, seq, P, "f32")[P - 1:]
        best = ref.max(-1).values
        served = best - ref.gather(1, toks[:, None])[:, 0]
        if prec is None:
            return served, None
        low = reference.logits(weights, conf, seq, P, prec)[P - 1:]
        pick = low.argmax(-1)
        return served, best - ref.gather(1, pick[:, None])[:, 0]


def readings(served: list, control: list) -> dict:
    """The numbers a check may compare, from the gaps of every compared
    token: the widest (``logit_gap``) and the mean (``logit_gap_mean``), and
    with a control the same of its gaps (``control_gap``,
    ``control_gap_mean``)."""
    out = {}
    for name, parts in (("logit_gap", served), ("control_gap", control)):
        if parts:
            g = torch.cat(parts)
            out[name], out[name + "_mean"] = float(g.max()), float(g.mean())
    return out


def checks(values: dict, limits: dict) -> dict:
    """``{name: {value, limit}}`` for each number the cell's ``limits`` name
    and the run read (with nothing compared, the driver's ``unchecked``
    fails the run)."""
    return {n: {"value": values[n], "limit": float(lim)}
            for n, lim in limits.items() if n in values}


def control_checks(readings: dict, limits: dict) -> dict:
    """``checks`` of the control: its gaps put in the program's place, held
    to the same limits. A sound limit makes ``passed`` of these false."""
    ctrl = {"logit_" + n[len("control_"):]: v
            for n, v in readings.items() if n.startswith("control_")}
    return checks(ctrl, limits)


def check(name: str, value: float, limit: float) -> dict:
    return {name: {"value": float(value), "limit": float(limit)}}


def passed(checks: dict) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
