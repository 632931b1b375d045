#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped or caught):

1. build: compile every CUDA C++ kernel of the port with nvcc (one process
   per source, started together); the Triton kernel compiles at its first
   launch in phase 2;
2. kernels: hold each kernel against its plain PyTorch version on the card
   (flash attention: the reference's kernel sweep cases plus the serving
   shapes, f32 within 1e-4 and bf16 within 2e-2; rmsnorm: the sweep cases
   plus the serving shapes, f32 within 1e-5 and bf16 within 3e-2 + 2**-7
   relative), and time kernel, plain version and one PyTorch library call;
3. main path: ``repro_torch.launch.serve.serve`` with gemma3-1b at its
   published size (26 layers, bf16) in a fresh Workspace: publish, load with
   ``strategy="stable"``, copy to the card, prefill 4 prompts of 1024
   tokens and decode 32 new tokens. The kernel launch counts of that run
   must be exactly 26 flash-attention launches per prefill and 105 rmsnorm
   launches per prefill and per decode step. Its prefill logits must be
   finite and, against a float32 plain-attention run on the card, no
   further off than 1.5x the bf16 plain-attention run;
4. small input: gemma3-1b's smoke config on the card (kernels) and on the
   CPU (plain versions, which the CPU tests hold against the JAX
   reference) give the same logits within 1e-4 and the same greedy tokens.

Output: progress lines, then the kernel record as one JSON line, the
card's name and power limit, and last the contract line
``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json``. Without a card, or without the repository
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "build"          # gitignored, like the kernel builds

# the reference's kernel sweep (tests/test_kernels.py): B, Sq, Sk, H, KV, hd,
# causal, window; then its window block-skip case and the serving shapes
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 1, 128, True, 0),
    (2, 96, 96, 2, 2, 32, True, 0),
    (1, 128, 128, 4, 4, 64, True, 64),
    (1, 64, 192, 4, 2, 64, False, 0),
    (1, 200, 72, 2, 1, 16, True, 0),
    (1, 512, 512, 2, 2, 32, True, 100),
]
RMS_CASES = [(1, 8), (4, 300), (37, 128), (128, 1024), (5, 7),
             (4096, 1152), (4, 1024, 4, 256)]
FA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # other summation order
RMS_TOL = {"float32": (1e-5, 0.0), "bfloat16": (3e-2, 2.0**-7)}  # (abs, rel)

# the main path
ARCH, BATCH, PROMPT, NEW = "gemma3-1b", 4, 1024, 32
FLASH_PER_PREFILL = 26
RMS_PER_STEP = 105            # 4 per layer (attn, q, k, mlp) + final norm

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 tensor flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, min_total_ms: float = 40.0) -> float:
    """Mean milliseconds per call on the card: CUDA events around a run of
    back-to-back calls after a warm-up (so a small kernel's time includes
    its launch cost when the host is the slower side)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    n = 5
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        total = a.elapsed_time(b)
        if total >= min_total_ms or n >= 2000:
            return total / n
        n *= 4


# --------------------------------------------------------------- phase 1
def build_kernels() -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa

    t0 = time.perf_counter()
    logs = build.build_all([fa.SOURCE])
    wall = time.perf_counter() - t0
    for source, text in logs.items():
        usage = [ln.strip() for ln in text.splitlines() if "Used" in ln]
        log(f"built {source} in {build.build_seconds[source]:.1f} s; ptxas: "
            + "; ".join(sorted(set(usage))))
    return {"nvcc_wall_s": wall, "per_source_s": dict(build.build_seconds)}


# --------------------------------------------------------------- phase 2
def _mask(sq, sk, window, device):
    import torch

    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    m = qp >= kp
    if window > 0:
        m &= qp - kp < window
    return m


def flash_work(case) -> tuple[float, float]:
    """(bytes, flops) the function needs: each input read once, the output
    written once; 4*hd flops per visible (q, k) pair (QK^T and PV)."""
    B, Sq, Sk, H, KV, hd, causal, window = case
    elem = 2  # bf16
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * elem
    pairs = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = min(Sk, q + 1) if causal else Sk
        pairs += max(0, hi - lo)
    return nbytes, 4.0 * hd * pairs * B * H


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mix_bound(work, peak_flops: float) -> dict:
    """Per-launch bound of a mix of launches [(count, bytes, flops)]: the
    least time for all of its work, over the number of launches."""
    n = sum(c for c, _, _ in work)
    t, by = bound_ms(sum(c * b for c, b, _ in work) / n,
                     sum(c * f for c, _, f in work) / n, peak_flops)
    return {"bound_ms": t, "bound_by": by}


def check_flash(cfg) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    windows = [w for w in (0, cfg.sliding_window)]
    serving = [(BATCH, PROMPT, PROMPT, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, True, w) for w in windows]
    errs, worst_serving = [], 0.0
    for case in FA_CASES + serving:
        B, Sq, Sk, H, KV, hd, causal, window = case
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
            k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dt)
            v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dt)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
            err = (got.float() - want.float()).abs().max().item()
            name = str(dt).removeprefix("torch.")
            errs.append({"case": case, "dtype": name, "max_abs_err": err})
            if not err <= FA_TOL[name]:
                fail(f"flash_attention {case} {name}: max err {err} > {FA_TOL[name]}")
            if case in serving and dt == torch.bfloat16:
                worst_serving = max(worst_serving, err)
    log(f"flash_attention: {len(errs)} cases agree with the plain version")

    # times at the serving shapes, weighted as the main path launches them
    from repro_torch.models.transformer import _layer_windows

    mix = {w: _layer_windows(cfg).count(w) for w in windows}
    per_shape, totals = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    work = []
    for case in serving:
        B, Sq, Sk, H, KV, hd, causal, window = case
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn((B, Sk, KV, hd), generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn((B, Sk, KV, hd), generator=g, device=dev, dtype=torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = _mask(Sq, Sk, window, dev)

        def library():
            if window > 0:
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        row = {
            "case": case,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                                 window=window)),
            "library_ms": time_ms(library),
        }
        nbytes, flops = flash_work(case)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, BF16_FLOPS)
        work.append((mix[window], nbytes, flops))
        row["weight"] = mix[window]
        per_shape.append(row)
        for key in totals:
            totals[key] += row[key] * mix[window] / FLASH_PER_PREFILL
        log(f"flash_attention window={window}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:119",
        "max_abs_err": worst_serving,
        **totals,
        **mix_bound(work, BF16_FLOPS),
        "_cases": errs,
        "_per_shape": per_shape,
    }


def rms_mix(cfg) -> dict:
    """{(rows, d): launches} of one main-path run (prefill + decode steps)."""
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    mix: dict = {}

    def add(shape, n):
        mix[shape] = mix.get(shape, 0) + n

    add((BATCH * PROMPT, d), 2 * L)            # attn_norm, mlp_norm
    add((BATCH * PROMPT * H, hd), L)           # q_norm
    add((BATCH * PROMPT * KV, hd), L)          # k_norm
    add((BATCH, d), 1)                         # final_norm, last position
    steps = NEW - 1
    add((BATCH, d), (2 * L + 1) * steps)
    add((BATCH * H, hd), L * steps)
    add((BATCH * KV, hd), L * steps)
    return mix


def check_rmsnorm(cfg) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    mix = rms_mix(cfg)
    errs, worst_serving = [], 0.0
    for shape in RMS_CASES + sorted(mix):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            s = torch.randn(shape[-1], generator=g, device=dev).to(dt)
            got = rn.rmsnorm(x, s)
            torch.cuda.synchronize()
            want = rn.rmsnorm_plain(x, s)
            name = str(dt).removeprefix("torch.")
            atol, rtol = RMS_TOL[name]
            diff = (got.float() - want.float()).abs()
            excess = (diff - rtol * want.float().abs()).max().item()
            err = diff.max().item()
            errs.append({"shape": shape, "dtype": name, "max_abs_err": err})
            if not excess <= atol:
                fail(f"rmsnorm {shape} {name}: error {err} beyond {atol} + {rtol}*|x|")
            if shape in mix and dt == torch.bfloat16:
                worst_serving = max(worst_serving, err)
    # the final norm's input at prefill: the last position, rows strided
    x = torch.randn((BATCH, 16, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)[:, -1:, :]
    s = torch.randn((cfg.d_model,), generator=g, device=dev, dtype=torch.bfloat16)
    err = (rn.rmsnorm(x, s).float() - rn.rmsnorm_plain(x, s).float()).abs()
    if not (err - RMS_TOL["bfloat16"][1] * rn.rmsnorm_plain(x, s).float().abs()
            ).max().item() <= RMS_TOL["bfloat16"][0]:
        fail(f"rmsnorm on strided rows: error {err.max().item()}")
    errs.append({"shape": "strided last position", "dtype": "bfloat16",
                 "max_abs_err": err.max().item()})
    log(f"rmsnorm: {len(errs)} cases agree with the plain version")

    total = sum(mix.values())
    per_shape, totals = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    work = []
    for (rows, d), n in sorted(mix.items()):
        x = torch.randn((rows, d), generator=g, device=dev, dtype=torch.bfloat16)
        s = torch.randn((d,), generator=g, device=dev, dtype=torch.bfloat16)
        row = {
            "shape": (rows, d),
            "ms": time_ms(lambda: rn.rmsnorm(x, s)),
            "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, s)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6)),
        }
        nbytes, flops = (2 * rows * d + d) * 2, 4.0 * rows * d
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, F32_FLOPS)
        work.append((n, nbytes, flops))
        row["weight"] = n
        per_shape.append(row)
        for key in totals:
            totals[key] += row[key] * n / total
        log(f"rmsnorm {(rows, d)} x{n}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms")
    return {
        "name": "rmsnorm",
        "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm/ops.py",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:31",
        "max_abs_err": worst_serving,
        **totals,
        **mix_bound(work, F32_FLOPS),
        "_cases": errs,
        "_per_shape": per_shape,
    }


# --------------------------------------------------------------- phase 3
def profile_generate(engine, prompts) -> dict:
    """One more steady generate under torch.profiler: device time by kernel
    and the card's busy share of the wall time (the profiler's own cost
    lengthens the wall, so the idle share it gives is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = engine.generate(prompts, NEW)
        wall = time.perf_counter() - t0
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    out = {
        "wall_s": wall, "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3) if busy_ms else None,
        "top_kernels_ms": [(k[:90], ms, n) for k, ms, n in kernels[:20]],
    }
    log(f"profiled generate: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {out['idle_share']}")
    for name, ms, n in out["top_kernels_ms"][:8]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name}")
    return out


def main_path(cfg) -> dict:
    import torch

    from repro_torch import models
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.launch.serve import serve
    from repro_torch.link import Workspace

    root = tempfile.mkdtemp(prefix="chip-smoke-ws-")
    try:
        ws = Workspace.open(root)
        fa.launches = rn.launches = 0
        t0 = time.perf_counter()
        run = serve(cfg, ws, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                    strategy="stable", device="cuda")
        wall = time.perf_counter() - t0
        counts = {"flash_attention": fa.launches, "rmsnorm": rn.launches}
        want = {"flash_attention": FLASH_PER_PREFILL, "rmsnorm": RMS_PER_STEP * NEW}
        log(f"main path ran in {wall:.1f} s; launches {counts}, expected {want}")
        if counts != want:
            fail(f"kernel launches {counts} != {want}")
        s = run.summary
        if tuple(run.tokens.shape) != (BATCH, NEW) or not (
            0 <= run.tokens.min() and run.tokens.max() < cfg.vocab_size
        ):
            fail(f"bad tokens {run.tokens.shape}")
        engine = run.engine
        # steady state: the same generate again, kernels and cuBLAS warm
        _, steady = engine.generate(run.prompts, NEW)
        profile = profile_generate(engine, run.prompts)

        tokens = torch.as_tensor(run.prompts, device="cuda")
        with torch.inference_mode():
            kern, _ = models.prefill(cfg, engine.params, {"tokens": tokens}, impl="kernel")
            plain, _ = models.prefill(cfg, engine.params, {"tokens": tokens}, impl="naive")
            p32 = {n: t.float() for n, t in engine.params.items()}
            ref, _ = models.prefill(cfg.replace(dtype="float32"), p32,
                                    {"tokens": tokens}, impl="naive")
            del p32
        if not bool(torch.isfinite(kern).all()):
            fail("prefill logits are not finite")
        err_k = (kern.float() - ref).abs().max().item()
        err_p = (plain.float() - ref).abs().max().item()
        log(f"prefill logits vs f32 plain: kernel path {err_k:.5f}, bf16 plain "
            f"path {err_p:.5f}")
        if not err_k <= 1.5 * err_p:
            fail(f"kernel path error {err_k} > 1.5 x bf16 plain error {err_p}")
        result = {
            "launches": counts,
            "wall_s": wall,
            "load_strategy": s["load_strategy"],
            "load_s": s["load_s"],
            "prefill_s": s["prefill_s"],
            "decode_s": s["decode_s"],
            "tok_per_s": s["tok_per_s"],
            "steady_prefill_s": steady.prefill_s,
            "steady_decode_s": steady.decode_s,
            "steady_tok_per_s": steady.tok_per_s,
            "logits_err_kernel": err_k,
            "logits_err_bf16_plain": err_p,
            "profile": profile,
            "n_params": models.n_params(cfg),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        log("main path: " + json.dumps({k: result[k] for k in (
            "load_s", "prefill_s", "decode_s", "tok_per_s", "steady_prefill_s",
            "steady_decode_s", "steady_tok_per_s")}))
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------- phase 4
def small_input() -> dict:
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(ARCH, smoke=True)
    cpu = models.init_params(cfg, 0, "cpu")
    gpu = {n: t.to("cuda") for n, t in cpu.items()}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40), dtype=np.int32)
    outs = {}
    with torch.inference_mode():
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            t = torch.as_tensor(toks, device=dev)
            logits, cache = models.prefill(cfg, params, {"tokens": t}, cache_len=48)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            seq = [tok]
            for _ in range(7):
                lg, cache = models.decode_step(cfg, params, cache, tok)
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                seq.append(tok)
            outs[dev] = (logits.float().cpu(), torch.cat(seq, 1).cpu())
    err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    same = torch.equal(outs["cpu"][1], outs["cuda"][1])
    log(f"smoke config card vs CPU: logits err {err:.2e}, tokens equal {same}")
    if not (err <= 1e-4 and same):
        fail("card and CPU disagree on the smoke config")
    return {"logits_err": err, "tokens_equal": same}


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no {SRC / 'repro_torch'}: run chip_smoke.py from a checkout")
    sys.path.insert(0, str(SRC))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config

    resolve_device("cuda")                   # TF32 off for f32 products
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    detail = {"card": card, "build": build_kernels()}
    kernels = [check_flash(cfg), check_rmsnorm(cfg)]
    detail["main_path"] = main_path(cfg)
    for k in kernels:
        k["launches"] = detail["main_path"]["launches"][k["name"]]
    detail["small_input"] = small_input()
    detail["kernels"] = kernels
    detail["total_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"done in {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
