#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped or caught):

1. build: compile the port's three CUDA C++ sources with nvcc (one process
   per source, started together), print ``-Xptxas -v``'s registers and
   spills for the flash-attention and rmsnorm kernels, and check that the
   flash library's SASS holds tensor-core ``HGMMA`` instructions (with the
   toolkit's ``cuobjdump``; "not checked" where there is none). Set-up then
   publishes gemma3-1b at its published size (26 layers, bf16, random
   weights from seed 0) into a fresh Workspace and loads it once on the
   host (``device=None``) as the byte reference;
2. kernels: hold each kernel against its plain PyTorch version on the card
   (flash attention: the reference's kernel sweep cases plus the serving
   shapes, f32 within 1e-4 on the CUDA-core route and bf16 within 2e-2, on
   the wgmma route at hd >= 64; rmsnorm: the sweep cases plus the serving
   shapes, f32 within 1e-5 and bf16 within 3e-2 + 2**-7 relative;
   paged_reloc_copy: the reference's cases and gemma3-1b's real page table
   over a 2.0 GB arena, exactly equal), and time kernel, plain version and
   one PyTorch library call; flash attention's simt route is timed at its
   own shapes (the smoke config's) and, as a yardstick, at the serving
   shapes through its C entry; rmsnorm and ``F.rms_norm`` are timed in
   turns (their calls' time is the host's), and their device times come
   from the profiler;
3. main path: ``repro_torch.launch.serve.serve`` with that app: load with
   ``strategy="stable"``, which builds the arena on the card with one
   paged_reloc_copy launch (the params are views of it), prefill 4 prompts
   of 1024 tokens and decode 32 new tokens. The launch counts of that run
   must be exactly 1 paged copy, 26 flash-attention launches per prefill
   (all on the wgmma route) and 105 rmsnorm launches per prefill and per
   decode step; every slot of
   the device arena must equal the host image's bytes. Its prefill logits
   must be finite and, against a float32 plain-attention run on the card,
   no further off than 1.5x the bf16 plain-attention run;
4. small input: gemma3-1b's smoke config on the card (kernels) and on the
   CPU (plain versions, which the CPU tests hold against the JAX
   reference) give the same logits within 1e-4 and the same greedy tokens;
   and the same ``serve_loop`` (float32, mixed prompt lengths, 2 slots)
   gives identical completions on both, greedy and sampled;
5. serving across an epoch: ``ServeEngine.from_workspace(strategy=
   "stable", cache_len=1056)`` then ``serve_loop(max_batch=4)`` over 12
   greedy requests (prompt lengths drawn with seed 0 from 256..1024, 32 new
   tokens each). After handing over the 6th request the source commits a
   ``v2`` bundle (seed 1); ``epoch_watch``/``adopt_epoch`` flip the engine
   at a request boundary, rebuilding the arena on the card. It must
   complete 12, flip exactly once with no abort, launch the paged copy
   twice, flash attention 26 times per admission (all wgmma) and rmsnorm
   105 times per
   admission and per step, and serve from params byte-equal to the v2 host
   image after the flip. Rates leave out the commit's own wall time.

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
# serving across an epoch (phase 5)
SERVE_REQUESTS, SERVE_SLOTS, SERVE_CACHE = 12, 4, 1056
SERVE_LENS = (256, 512, 768, 1024)
FLIP_AFTER = 6                # the source commits v2 after this many requests
# the reference's paged-copy cases (tests/test_kernels.py): (pages, copies)
PAGED_CASES = [(4, 2), (64, 64), (128, 37)]

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


def time_pair_ms(fn, other, rounds: int = 3) -> tuple[float, float]:
    """Medians of ``time_ms`` of two calls timed in turns (fn, other, other,
    fn, ...): for small calls whose time is the host's, which drifts."""
    a, b = [], []
    for _ in range(rounds):
        a.append(time_ms(fn))
        b.append(time_ms(other))
        b.append(time_ms(other))
        a.append(time_ms(fn))
    return sorted(a)[len(a) // 2], sorted(b)[len(b) // 2]


# --------------------------------------------------------------- phase 1
def ptxas_kernels(text: str) -> list[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: name, registers, spills."""
    rows, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = {"kernel": line.split("'")[1], "regs": None, "spill_bytes": 0}
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            cur["spill_bytes"] = nums[1] + nums[2]    # stack, stores, loads
        elif cur is not None and line.strip().startswith("ptxas info    : Used"):
            cur["regs"] = int(line.split("Used")[1].split()[0])
    names = [r["kernel"] for r in rows]
    if names and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60)
        for r, name in zip(rows, res.stdout.splitlines()):
            name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
            r["kernel"] = name.split("(")[0]
    return rows


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or the copy that Triton's package carries."""
    import importlib.util

    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cand.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    return next((str(c) for c in cand if c.exists()), None)


def build_kernels() -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_reloc_copy import ops as prc
    from repro_torch.kernels.rmsnorm import ops as rn

    t0 = time.perf_counter()
    logs = build.build_all([fa.SOURCE, rn.SOURCE, prc.SOURCE])
    wall = time.perf_counter() - t0
    out = {"nvcc_wall_s": wall, "per_source_s": dict(build.build_seconds), "ptxas": {}}
    for source, text in logs.items():
        log(f"built {source} in {build.build_seconds[source]:.1f} s")
        for line in text.splitlines():
            if "warning" in line.lower():
                log(f"  nvcc: {line.strip()}")
        rows = ptxas_kernels(text)
        out["ptxas"][source] = rows
        if source == prc.SOURCE:
            continue
        if source == rn.SOURCE:        # 48 instantiations: one summary line
            log(f"  ptxas: {len(rows)} kernels, at most "
                f"{max(r['regs'] for r in rows)} registers, "
                f"{sum(r['spill_bytes'] for r in rows)} spill bytes in all")
            for r in rows:
                if r["spill_bytes"]:
                    log(f"  ptxas: {r['kernel']} spills {r['spill_bytes']} bytes")
            continue
        for r in rows:
            log(f"  ptxas: {r['kernel']}: {r['regs']} registers, "
                f"{r['spill_bytes']} spill bytes")
    tool = cuobjdump()
    if tool is None:
        out["hgmma"] = "not checked"
        log("HGMMA in the flash library's SASS: not checked (no cuobjdump)")
    else:
        res = subprocess.run([tool, "-sass", str(build.library_path(fa.SOURCE))],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"cuobjdump failed: {res.stderr.strip()[-2000:]}")
        n = res.stdout.count("HGMMA")
        out["hgmma"] = n
        log(f"HGMMA in the flash library's SASS: {n} instructions ({tool})")
        if not n:
            fail("the flash library holds no HGMMA: the wgmma route is not real")
    return out


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
            kind = fa.route(dt, hd)
            before = fa.launches_by_route[kind]
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if fa.launches_by_route[kind] != before + 1:
                fail(f"flash_attention {case}: the {kind} route did not launch")
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
            err = (got.float() - want.float()).abs().max().item()
            name = str(dt).removeprefix("torch.")
            errs.append({"case": case, "dtype": name, "route": kind, "max_abs_err": err})
            if not err <= FA_TOL[name]:
                fail(f"flash_attention {case} {name}: max err {err} > {FA_TOL[name]}")
            if case in serving and dt == torch.bfloat16:
                worst_serving = max(worst_serving, err)
    log(f"flash_attention: {len(errs)} cases agree with the plain version "
        f"({sum(e['route'] == 'wgmma' for e in errs)} on the wgmma route)")

    # times at the serving shapes, weighted as the main path launches them
    from repro_torch.models.transformer import _layer_windows

    mix = {w: _layer_windows(cfg).count(w) for w in windows}
    per_shape, work = [], []
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "simt_ms": 0.0,
              "device_ms": 0.0, "library_device_ms": 0.0}
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
            "route": fa.route(q.dtype, hd),
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                                 window=window)),
            "library_ms": time_ms(library),
            "simt_ms": time_ms(simt_launcher(q, k, v, window)),
            "device_ms": device_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                              window=window)),
            "library_device_ms": device_ms(library),
        }
        nbytes, flops = flash_work(case)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, BF16_FLOPS)
        work.append((mix[window], nbytes, flops))
        row["weight"] = mix[window]
        per_shape.append(row)
        for key in totals:
            totals[key] += row[key] * mix[window] / FLASH_PER_PREFILL
        log(f"flash_attention window={window}: {row['route']} kernel {row['ms']:.4f} ms "
            f"(device {row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms (device {row['library_device_ms']:.4f} ms), simt "
            f"kernel {row['simt_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    simt = simt_at_smoke_shapes()
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
        "_simt_route": simt,
    }


def simt_launcher(q, k, v, window):
    """A zero-argument call of the CUDA-core kernel's C entry on bf16 q/k/v
    (outside the wrapper, which routes bf16 at hd 256 to wgmma): the simt
    route's time at the serving shapes, as a yardstick. Not counted."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa

    lib = fa._library()
    o = torch.empty_like(q)
    b, sq, h, hd = q.shape
    args = (1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            k.shape[1], h, k.shape[2],
            *[t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)],
            1, window, 0, hd**-0.5, torch.cuda.current_stream().cuda_stream)

    def run():
        err = lib.fa_forward_simt(*args)
        if err:
            fail(f"simt flash kernel: {lib.fa_error_string(err).decode()}")
    return run


def simt_at_smoke_shapes() -> dict:
    """The simt route where the port sends it: gemma3-1b's smoke config
    (float32, H 4, KV 1, hd 16) at the phase-4 prefill shape (2 x 40)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa

    cfg = get_config(ARCH, smoke=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = torch.randn((2, 40, H, hd), generator=g, device="cuda")
    k = torch.randn((2, 40, KV, hd), generator=g, device="cuda")
    v = torch.randn((2, 40, KV, hd), generator=g, device="cuda")
    row = {"case": (2, 40, 40, H, KV, hd, True, cfg.sliding_window),
           "route": fa.route(q.dtype, hd),
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, window=cfg.sliding_window)),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, window=cfg.sliding_window))}
    log(f"flash_attention smoke shape {row['case']} f32: {row['route']} kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")
    return row


def device_ms(fn, calls: int = 50) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler
    (the CUDA-event times of small launches measure the host instead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / calls


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
        ms, library_ms = time_pair_ms(lambda: rn.rmsnorm(x, s),
                                      lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6))
        row = {
            "shape": (rows, d),
            "ms": ms,
            "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, s)),
            "library_ms": library_ms,
            "device_ms": device_ms(lambda: rn.rmsnorm(x, s)),
            "library_device_ms": device_ms(lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6)),
        }
        nbytes, flops = (2 * rows * d + d) * 2, 4.0 * rows * d
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, F32_FLOPS)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        work.append((n, nbytes, flops))
        row["weight"] = n
        per_shape.append(row)
        for key in totals:
            totals[key] += row[key] * n / total
        log(f"rmsnorm {(rows, d)} x{n}: kernel {row['ms']:.4f} ms a call (device "
            f"{row['device_ms'] * 1e3:.3f} us, {row['bound_share']:.1%} of the bound), "
            f"plain {row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms "
            f"(device {row['library_device_ms'] * 1e3:.3f} us), bound "
            f"{row['bound_ms']:.5f} ms")
    return {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:31",
        "max_abs_err": worst_serving,
        **totals,
        "device_ms": sum(r["device_ms"] * r["weight"] for r in per_shape) / total,
        **mix_bound(work, F32_FLOPS),
        "_cases": errs,
        "_per_shape": per_shape,
    }


def check_paged(table) -> dict:
    """paged_reloc_copy against its plain version, exactly: the reference's
    cases, then gemma3-1b's own page table (``table``) over a random blob."""
    import numpy as np
    import torch

    from repro_torch.core.objects import PAGE_BYTES, align_up
    from repro_torch.core.relocation import blob_layout
    from repro_torch.kernels.paged_reloc_copy import ops as prc

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def pages(n):
        return torch.from_numpy(
            rng.integers(-(2**31), 2**31 - 1, (n, 8, 128), dtype=np.int32)).to(dev)

    cases = [(n, m, rng.integers(0, n, m).astype(np.int32),
              rng.permutation(n)[:m].astype(np.int32)) for n, m in PAGED_CASES]
    cases.append((8, 1, np.array([0], np.int32), np.array([3], np.int32)))  # untouched
    cases.append((8, 0, np.zeros(0, np.int32), np.zeros(0, np.int32)))      # n == 0
    for n, m, src, dst in cases:
        blob, arena = pages(max(n, 4)), pages(n)
        want = prc.paged_reloc_copy_plain(blob, arena.clone(), src, dst)
        got = prc.paged_reloc_copy(blob, arena, src, dst)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"paged_reloc_copy differs from its plain version on ({n}, {m})")
    log(f"paged_reloc_copy: {len(cases)} reference cases equal the plain version")

    # the serving shape: gemma3-1b's page table over a 2.0 GB arena
    src, dst = table._pt_src, table._pt_dst
    n = int(src.size)
    _, blob_pages = blob_layout(table)
    arena_pages = align_up(table.arena_size, PAGE_BYTES) // PAGE_BYTES
    g = torch.Generator(device=dev).manual_seed(3)
    blob = torch.randint(-(2**31), 2**31 - 1, (blob_pages, 8, 128), generator=g,
                         dtype=torch.int32, device=dev)
    arena = torch.zeros((arena_pages, 8, 128), dtype=torch.int32, device=dev)
    want = prc.paged_reloc_copy_plain(blob, torch.zeros_like(arena), src, dst)
    prc.paged_reloc_copy(blob, arena, src, dst)
    torch.cuda.synchronize()
    if not torch.equal(arena, want):
        fail("paged_reloc_copy differs from its plain version at the serving shape")
    del want
    log(f"paged_reloc_copy: gemma3-1b page table ({n} pages, {n * PAGE_BYTES} "
        "bytes) equals the plain version")

    src_d = torch.from_numpy(src).to(dev)
    dst_d = torch.from_numpy(dst).to(dev)
    src_l, dst_l = src_d.long(), dst_d.long()
    nbytes = n * PAGE_BYTES
    flat_blob, flat_arena = blob.view(-1), arena.view(-1)
    m = min(blob.numel(), arena.numel(), nbytes // 4)
    row = {
        "ms": time_ms(lambda: prc.launch(blob, arena, src_d, dst_d)),
        "wrapper_ms": time_ms(lambda: prc.paged_reloc_copy(blob, arena, src, dst)),
        "plain_ms": time_ms(lambda: prc.paged_reloc_copy_plain(blob, arena, src_l, dst_l)),
        "library_ms": time_ms(
            lambda: arena.index_copy_(0, dst_l, blob.index_select(0, src_l))),
        "copy_ms": time_ms(lambda: flat_arena[:m].copy_(flat_blob[:m])),
    }
    row["copy_bytes"] = 4 * m
    row["bound_ms"], row["bound_by"] = bound_ms(2.0 * nbytes, 0.0, BF16_FLOPS)
    row["achieved_tb_s"] = 2.0 * nbytes / (row["ms"] * 1e-3) / 1e12
    row["copy_tb_s"] = 2.0 * 4 * m / (row["copy_ms"] * 1e-3) / 1e12
    log(f"paged_reloc_copy n={n}: kernel {row['ms']:.4f} ms ({row['achieved_tb_s']:.3f} "
        f"TB/s), with host checks + index upload {row['wrapper_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, index_copy_ {row['library_ms']:.4f} ms, contiguous "
        f"copy_ {row['copy_ms']:.4f} ms ({row['copy_tb_s']:.3f} TB/s), bound "
        f"{row['bound_ms']:.4f} ms (bytes)")
    del blob, arena
    torch.cuda.empty_cache()
    return {
        "name": "paged_reloc_copy",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_reloc_copy.cu",
        "replaces": "src/repro/kernels/paged_reloc_copy/paged_reloc_copy.py:43",
        "max_abs_err": 0.0,          # held to exact equality above
        "pages": n,
        **row,
    }


# --------------------------------------------------------------- set-up
def publish(cfg, root) -> tuple:
    """A Workspace at ``root`` holding gemma3-1b's app (weights from seed 0,
    made on the card), and the app loaded on the host: the byte reference."""
    from repro_torch.launch.serve import publish_model
    from repro_torch.link import Workspace

    ws = Workspace.open(root)
    t0 = time.perf_counter()
    app = publish_model(ws, cfg, device="cuda")
    t1 = time.perf_counter()
    host = ws.load(app, strategy="stable")
    log(f"set-up: published {app} in {t1 - t0:.1f} s; host load "
        f"{host.stats.startup_s:.3f} s")
    return ws, app, host, {"publish_s": t1 - t0, "host_load_s": host.stats.startup_s}


def load_split(stats) -> dict:
    return {k: getattr(stats, k) for k in (
        "strategy", "table_load_s", "upload_s", "kernel_s", "host_rows_s", "io_s",
        "startup_s", "bytes_loaded")}


def slots_equal(params, host) -> None:
    """Every param (one arena slot each) byte-equal to the host image's."""
    import numpy as np
    import torch

    for name, arr in host.tensors.items():
        want = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        got = params[name].reshape(-1).view(torch.uint8)
        if not torch.equal(got, want.to(got.device)):
            fail(f"device arena slot {name!r} differs from the host image")


def counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_reloc_copy import ops as prc
    from repro_torch.kernels.rmsnorm import ops as rn

    return {"flash_attention": fa.launches, "rmsnorm": rn.launches,
            "paged_reloc_copy": prc.launches,
            "flash_routes": dict(fa.launches_by_route)}


def zero_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_reloc_copy import ops as prc
    from repro_torch.kernels.rmsnorm import ops as rn

    fa.launches = rn.launches = prc.launches = 0
    fa.launches_by_route.update(wgmma=0, simt=0)


# --------------------------------------------------------------- phase 3
def profiled(run, what: str) -> dict:
    """``run()`` under torch.profiler: device time by kernel and the card's
    busy share of the wall time (the profiler's own cost lengthens the
    wall, so the idle share it gives is an upper bound). ``run`` ends in a
    synchronisation and returns a dict of its own figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        figures = run()
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
        "wall_s": wall, **figures,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3) if busy_ms else None,
        "top_kernels_ms": [(k[:90], ms, n) for k, ms, n in kernels[:20]],
    }
    log(f"profiled {what}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {out['idle_share']}")
    for name, ms, n in out["top_kernels_ms"][:8]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name}")
    return out


def main_path(cfg, ws, host) -> dict:
    import torch

    from repro_torch import models
    from repro_torch.launch.serve import serve

    zero_counts()
    t0 = time.perf_counter()
    run = serve(cfg, ws, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                strategy="stable", device="cuda")
    wall = time.perf_counter() - t0
    got = counts()
    want = {"flash_attention": FLASH_PER_PREFILL, "rmsnorm": RMS_PER_STEP * NEW,
            "paged_reloc_copy": 1,
            "flash_routes": {"wgmma": FLASH_PER_PREFILL, "simt": 0}}
    log(f"main path ran in {wall:.1f} s; launches {got}, expected {want}")
    if got != want:
        fail(f"kernel launches {got} != {want}")
    s = run.summary
    if tuple(run.tokens.shape) != (BATCH, NEW) or not (
        0 <= run.tokens.min() and run.tokens.max() < cfg.vocab_size
    ):
        fail(f"bad tokens {run.tokens.shape}")
    engine = run.engine
    slots_equal(engine.params, host)
    split = load_split(engine.load_stats)
    log(f"device arena equals the host image in all {len(host.tensors)} slots; "
        f"load split {json.dumps(split)}")
    # steady state: the same generate again, kernels and cuBLAS warm
    _, steady = engine.generate(run.prompts, NEW)

    def steady_generate():
        _, stats = engine.generate(run.prompts, NEW)
        return {"prefill_s": stats.prefill_s, "decode_s": stats.decode_s}

    profile = profiled(steady_generate, "generate")

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
        "launches": got,
        "wall_s": wall,
        "load_strategy": s["load_strategy"],
        "load_s": s["load_s"],
        "load_split": split,
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
    del run, engine
    torch.cuda.empty_cache()
    return result


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

    # the same serve_loop on both: mixed lengths around the window of 16
    from repro_torch.serve import STOP, Request, ServeEngine

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (12, 16, 21, 9, 30)]
    loops = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        engine = ServeEngine(cfg, params, cache_len=48, device=dev)
        for mode, kw in (("greedy", {}), ("sampled", {"temperature": 0.8, "top_k": 16,
                                                      "sampling_seed": 3})):
            feed = iter([Request(rid=i, prompt=p, max_new_tokens=8)
                         for i, p in enumerate(prompts)] + [STOP])
            done = {}
            engine.serve_loop(lambda: next(feed, STOP),
                              lambda c: done.setdefault(c.rid, c.tokens.tolist()),
                              max_batch=2, **kw)
            loops[(dev, mode)] = done
    for mode in ("greedy", "sampled"):
        if loops[("cpu", mode)] != loops[("cuda", mode)] or len(loops[("cpu", mode)]) != 5:
            fail(f"{mode} serve_loop differs between card and CPU")
    log("smoke serve_loop card vs CPU: identical completions, greedy and sampled")
    return {"logits_err": err, "tokens_equal": same, "serve_loop_equal": True}


# --------------------------------------------------------------- phase 5
def commit_v2(cfg, ws) -> None:
    """A management transaction publishing gemma3-1b's ``v2`` weights
    (seed 1) under the same bundle name: the next generation."""
    from repro_torch import models
    from repro_torch.ckpt import bundle_from_params

    params = models.init_params(cfg, 1, "cuda")
    bundle, payload = bundle_from_params(
        f"weights:{cfg.name}", "v2", params, specs=models.param_specs(cfg))
    del params
    with ws.management() as tx:
        tx.publish(bundle, payload)


def serve_epoch(cfg, ws, app) -> dict:
    import numpy as np
    import torch

    from repro_torch.serve import STOP, Request, ServeEngine

    zero_counts()
    t0 = time.perf_counter()
    engine = ServeEngine.from_workspace(cfg, ws, app, strategy="stable",
                                        cache_len=SERVE_CACHE, device="cuda")
    start_s = time.perf_counter() - t0
    start_split = load_split(engine.load_stats)
    rng = np.random.default_rng(0)
    lens = rng.choice(SERVE_LENS, SERVE_REQUESTS)
    pending = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(n),),
                                                   dtype=np.int32),
                       max_new_tokens=NEW) for i, n in enumerate(lens)]
    state = {"handed": 0, "commit_s": 0.0}

    def source():
        if state["handed"] == FLIP_AFTER and not state["commit_s"]:
            t = time.perf_counter()
            commit_v2(cfg, ws)
            state["commit_s"] = time.perf_counter() - t
        if state["handed"] == len(pending):
            return STOP
        state["handed"] += 1
        return pending[state["handed"] - 1]

    done = {}
    t1 = time.perf_counter()
    report = engine.serve_loop(
        source, lambda c: done.setdefault(c.rid, c), max_batch=SERVE_SLOTS,
        epoch_watch=ws.epoch_watch(),
        on_epoch=lambda change: engine.adopt_epoch(ws, app, strategy="stable"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = counts()
    want = {"flash_attention": FLASH_PER_PREFILL * report.admitted,
            "rmsnorm": RMS_PER_STEP * (report.admitted + report.steps),
            "paged_reloc_copy": 2,
            "flash_routes": {"wgmma": FLASH_PER_PREFILL * report.admitted, "simt": 0}}
    s = report.summary()
    log(f"serve across an epoch: {json.dumps(s)}; launches {got}, expected {want}")
    if got != want:
        fail(f"kernel launches {got} != {want}")
    if report.completed != SERVE_REQUESTS or report.rollovers != 1 or report.rollover_aborts:
        fail(f"completed {report.completed}, rollovers {report.rollovers}, "
             f"aborts {report.rollover_aborts}")
    for c in done.values():
        if c.tokens.shape != (NEW,) or not (0 <= c.tokens.min() and
                                            c.tokens.max() < cfg.vocab_size):
            fail(f"bad completion {c.rid}: {c.tokens}")
    slots_equal(engine.params, ws.load(app, strategy="stable"))
    log("after the flip every param equals the v2 host image")

    def steady_loop():          # one more wave on v2, all slots busy
        wave = iter(pending[:SERVE_SLOTS] + [STOP])
        rep = engine.serve_loop(lambda: next(wave), lambda c: None,
                                max_batch=SERVE_SLOTS)
        torch.cuda.synchronize()
        return {"steps": rep.steps, "admitted": rep.admitted}

    loop_profile = profiled(steady_loop, "serve_loop wave")
    served_s = wall - state["commit_s"]
    lat = np.array([c.latency_s for c in done.values()])
    out = {
        "report": s,
        "launches": got,
        "requests": SERVE_REQUESTS,
        "prompt_lens": [int(n) for n in lens],
        "replica_start_s": start_s,
        "start_split": start_split,
        "flip_split": load_split(engine.load_stats),
        "commit_s": state["commit_s"],
        "wall_s": wall,
        "served_s": served_s,
        "req_per_s": report.completed / served_s,
        "tok_per_s": report.tokens_out / served_s,
        "rollover_stall_s": report.rollover_stall_s,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_max_s": float(lat.max()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": loop_profile,
    }
    log("serving: " + json.dumps({k: out[k] for k in (
        "replica_start_s", "commit_s", "served_s", "req_per_s", "tok_per_s",
        "rollover_stall_s", "latency_p50_s")}))
    log("replica start split: " + json.dumps(start_split))
    log("flip load split: " + json.dumps(out["flip_split"]))
    del engine
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no {SRC / 'repro_torch'}: run chip_smoke.py from a checkout")
    sys.path.insert(0, str(SRC))
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
    root = tempfile.mkdtemp(prefix="chip-smoke-ws-")
    try:
        ws, app, host, detail["setup"] = publish(cfg, root)
        kernels = [check_flash(cfg), check_rmsnorm(cfg), check_paged(host.table)]
        detail["main_path"] = main_path(cfg, ws, host)
        del host
        detail["small_input"] = small_input()
        detail["serve_epoch"] = serve_epoch(cfg, ws, app)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths = {"main_path": detail["main_path"]["launches"],
             "serve_epoch": detail["serve_epoch"]["launches"]}
    kernels[0]["launches_by_route"] = {p: c["flash_routes"] for p, c in paths.items()}
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if not k["launches"]:
            fail(f"{k['name']} was not launched on the main path")
    detail["kernels"] = kernels
    detail["total_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    # device_ms: the profiler's device time a launch, beside "ms" (CUDA
    # events over back-to-back calls, the host's rate where it is slower);
    # null for the page copy, whose event time is its device time
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"done in {detail['total_s']:.1f} s")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
