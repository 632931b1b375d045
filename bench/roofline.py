"""Operations and bytes of a kernel call and of a model step, from shapes.

The least time a piece of work can take on the chip is the larger of its
operations over the peak rate and its bytes over the memory bandwidth
(``bound_s``). A share of the roofline is that bound over the measured
time. Counts follow the configuration's file (``bench/configs``), never the
program: a product of (m, k) by (k, n) is 2mkn operations; bytes count each
input read once and each output written once (weights, cache rows read,
cache rows and logits written), not the activations between kernels; where
the work depends on the data, they count what the inputs need: the cache
rows up to each sequence's position, the rows of sequences in flight, the
experts that tokens are routed to (in expectation over a uniform router:
``experts_hit``), the top-k of each token's experts and not their padded
capacity. Each family's model step is counted beside its reference, by
``prefill_work`` and ``decode_work`` of ``bench/reference/<family>.py``
(the configuration's ``reference``), from the parts here.

Peaks of one NVIDIA H100 SXM (the data sheet, dense): 989 TFLOP/s in bf16,
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM, at a
power limit of 700 W; ``run.py`` prints the card's limit beside them.
"""

from __future__ import annotations

import importlib

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_S)


def itemsize(conf) -> int:
    return _ITEMSIZE[conf["dtype"]]


def experts_hit(E: int, k: int, tokens: int) -> float:
    """Expected distinct experts that ``tokens`` tokens route to, k each."""
    return E * (1.0 - (1.0 - k / E) ** tokens)


# ------------------------------------------------------------ shared parts
def head(c, rows: int, tokens: int) -> tuple[float, float]:
    """Embedding rows gathered, then the output projection for ``rows``."""
    d, V = c["hidden_size"], c["vocab_size"]
    return 2 * rows * d * V, (tokens * d + d * V) * itemsize(c) + rows * V * 4


def flash_call(c, S: int) -> tuple[float, float]:
    """One causal self-attention call over a prompt of S tokens (one layer):
    QK^T and PV over the S(S+1)/2 pairs; Q, K, V read and O written once."""
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    flops = 4 * hd * H * S * (S + 1) / 2
    return flops, (2 * S * H * hd + 2 * S * KV * hd) * itemsize(c)


def _family(conf: dict):
    return importlib.import_module(f"bench.reference.{conf['reference']}")


def prefill(conf: dict, S: int) -> tuple[float, float]:
    """(operations, bytes) of one B=1 prefill of S tokens: the whole prompt
    through every layer, its cache or state written, the last position's
    logits."""
    return _family(conf).prefill_work(conf, S)


def decode(conf: dict, positions) -> tuple[float, float]:
    """(operations, bytes) of one decode step of the sequences in flight,
    each writing the position given (reading the cache up to it)."""
    return _family(conf).decode_work(conf, list(positions))


def page_copy_bytes(payload_bytes: int) -> int:
    """The paged relocation copy reads each payload byte and writes it once."""
    return 2 * int(payload_bytes)
