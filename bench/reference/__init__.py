"""Plain PyTorch references of the benchmark's models, in float32.

Each module computes a whole sequence's logits from the weights the
benchmark made and the sizes in the configuration's file, with no kernel,
cache or batching: ``logits(weights, conf, tokens, prompt_len, prec)``.
``prec`` is ``"f32"`` for the reference itself, or the lower precision of
the control (``precision.control``). Each module also counts its model
step's operations and bytes (``prefill_work``, ``decode_work``), which
``bench/roofline.py`` finds by the same name. Nothing here imports the
program.
"""

from __future__ import annotations

import importlib


def logits(weights, conf: dict, tokens, prompt_len: int, prec: str = "f32"):
    """(S, V) float32 logits of ``tokens`` (S,), a prompt of ``prompt_len``
    tokens followed by served ones, from ``conf["reference"]``'s module."""
    mod = importlib.import_module(f"bench.reference.{conf['reference']}")
    return mod.logits(weights, conf, tokens, prompt_len, prec)
