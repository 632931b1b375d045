#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 2,7]

Phases (any failure exits non-zero; no phase is skipped or caught):

1. build: compile the port's three CUDA C++ sources with nvcc (one process
   per source, started together), print ``-Xptxas -v``'s registers and
   spills for the flash-attention and rmsnorm kernels (rmsnorm's forward,
   its backward and the backward's column sums apart), and check that the
   flash library's SASS holds tensor-core ``HGMMA`` instructions (with the
   toolkit's ``cuobjdump``; "not checked" where there is none). Set-up then
   publishes gemma3-1b at its published size (26 layers, bf16, random
   weights from seed 0) into a fresh Workspace and loads it once on the
   host (``device=None``) as the byte reference;
2. kernels: hold each kernel against its plain PyTorch version on the card
   (flash attention: the reference's kernel sweep cases plus the serving
   shapes, f32 within 1e-4 on the CUDA-core route and bf16 within 2e-2, on
   the wgmma route at hd >= 64; the sweep's shapes again at hd 224, a
   windowed case and zamba2-7b's prefill shape (4, 1024, 32, 224), bf16 on
   the wgmma route within 2e-2; rmsnorm: the sweep cases plus every served
   family's shapes, f32 within 1e-5 and bf16 within 3e-2 + 2**-7 relative;
   paged_reloc_copy: the reference's cases and gemma3-1b's real page table
   over a 2.0 GB arena, exactly equal), and time kernel, plain version and
   one PyTorch library call; flash attention's simt route is timed at its
   own shapes (the smoke config's) and, as a yardstick, at the serving
   shapes through its C entry; rmsnorm and ``F.rms_norm`` are timed in
   turns (their calls' time is the host's), and their device times come
   from the profiler. Every timed call of flash attention and rmsnorm takes
   the next of several copies of its inputs, totalling more than twice
   the 50 MB L2, so no reading is of inputs left in L2 by the call before.
   rmsnorm's backward kernel: the sweep cases in f32 and bf16 and
   gemma3-1b's training shapes ((8192, 1152), (32768, 256), (8192, 256)) in
   bf16, dx within the forward's tolerances, dscale within 1e-4 of the
   float32 plain sum's largest value, both the same bits on a second call;
   timed at the training shapes beside ``torch.autograd.grad`` through
   ``F.rms_norm``, no reading faster than its bound;
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
4. small input: the smoke configs of gemma3-1b, olmoe-1b-7b,
   qwen2-moe-a2.7b, seamless-m4t-large-v2, mamba2-370m and zamba2-7b on
   the card (kernels) and on
   the CPU (plain versions, which the CPU tests hold against the JAX
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
   image after the flip. Rates leave out the commit's own wall time;
6. the traffic plane (``repro_torch.serve.traffic``), each worker a
   spawned process with its own CUDA context on the one card:
   - fleet load: ``ServeEngine.spawn_fleet(processes=2, strategy=
     "stable-shm")`` after checking that /dev/shm holds the 2.0 GB arena;
     at most one fill, both workers' digests equal to the host image's;
   - drive A: ``run_traffic`` with 2 workers (``strategy="stable"``: each
     builds its arena on the card), 32 streamed greedy requests of 1024
     tokens and 32 new tokens at a Poisson 1 req/s (below what two
     workers serve), 4 slots a worker, and a v3 commit (prebuilt bundle,
     seed 2) after the 16th request. It must complete 32 of 32, both
     workers must adopt v3 with digests equal to the v3 host image, 32 x
     32 partial frames with no gap, duplicate or mismatch, tokens in the
     vocabulary, each worker's own launch counts (from its statistics
     file) exactly 2 paged copies, 26 x admitted flash launches (all
     wgmma) and 105 x (admitted + steps) rmsnorm launches, and every
     served token within 3x the bf16 logit error of the argmax of an
     independent float32 forward (plain attention, no cache, in this
     process) of prompt + stream on the generation that served it; the
     card's memory is sampled with nvidia-smi;
   - drive B: 12 streamed requests of 256 tokens at 4 req/s into 2
     ``stable-shm`` workers under supervision; worker 1 SIGKILLs itself at
     its 40th decode step (its warmup takes 31), so it dies holding a
     request. It must complete 12 of 12 with at least one restart and
     one re-route and every stream whole.
   The flip-window latencies include the commit's wall time: the
   dispatcher runs ``rollover_fn`` synchronously, as the reference's does;
7. olmoe-1b-7b at its published widths (16 layers, d 2048, 64 experts
   top-8, bf16, random weights from seed 0) in a fresh Workspace: phase
   3's static batch (exactly 1 paged copy, 16 flash launches a prefill, all
   wgmma, 65 rmsnorm launches a prefill and a decode step, every slot
   byte-equal to the host image); each MoE layer of the kernel-path
   prefill held against an independent host routing (stable top-k, slot
   places, capacity per row: exactly equal) and a float32 FFN per expert
   (within MOE_OUT_TOL); the prefill logits finite, their error against a
   float32 run reported with the tokens routed differently; every token
   within tolerance of a teacher-forced float32 run (``tokens_check``);
   then ``serve_loop(max_batch=4)`` over 8 greedy requests of mixed prompt
   lengths (256..1024), all complete, launches exact, tokens checked;
8. seamless-m4t-large-v2 at its published widths (24 encoder and 24
   decoder layers, d 1024, hd 64, LayerNorm, bf16): the static batch with
   72 flash launches a prefill (24 of them non-causal cross-attention), 0
   rmsnorm, 1 paged copy, byte-equal slots, prefill logits within 1.5x the
   bf16 plain run's error of a float32 run, tokens checked; then
   ``serve_loop(max_batch=4)`` over 8 requests of mixed prompt lengths,
   which the reference's scheduler cannot serve: all complete, launches
   exact, tokens checked;
9. mamba2-370m at its published widths (48 layers, d 1024, d_inner 2048,
   32 SSM heads of 64, state 128, chunk 128, tied output layer, bf16;
   368,338,432 parameters) in a fresh Workspace: the static batch with 1
   paged copy, 0 flash launches and 97 rmsnorm launches a prefill and a
   decode step, byte-equal slots, prefill logits within 1.5x the bf16
   plain run's error of a float32 run, tokens checked; then the
   mixed-length ``serve_loop``;
10. zamba2-7b at its published widths (81 mamba layers, d 3584, 112 SSM
   heads, state 64; one shared attention block at 2*d = 7168 applied 14
   times, 32 heads of hd 224, d_ff 14,336; vocab 32,000, bf16;
   7,085,109,456 parameters, a 14.17 GB arena): as phase 9, with 14 flash
   launches a prefill, all on the wgmma route at hd 224, and 191 rmsnorm
   launches a prefill and a step;
11. training gemma3-1b at its published widths (bf16, remat "nothing",
   AdamW with float32 moments) at the reference's train_4k sequence length,
   global batch 2, through ``repro_torch.train.Trainer``: first step 0's
   loss and every gradient on the kernel path against a float32 plain-norm
   run on the card, within 1.5x the bf16 plain-norm run's error; then
   publish, an epoch-path start (opt/* INIT), steps, the step-3 checkpoint
   (a management event, published on a background thread), a failure
   injected at step 4, a restart on the table-driven path from opt/step,
   and step 4. It must launch exactly 2 paged copies, 0 flash and, a step,
   the rmsnorm forward and backward counts of ``train_rms_launches`` (209
   and 105); restart once from step 3, with opt/* INIT at the first start
   and DIRECT after; the checkpoint's bytes, loaded back on the host, must
   equal the trainer's snapshot and the restart's arena the host image;
   step 3's loss must be the same bits before and after the restart, and
   every loss finite. One more step is profiled;
12. the multi-device layer on one card: gemma3-1b at its published widths
   on ``make_local_mesh()`` (the production axis names at 1 x 1, over a
   one-rank NCCL group), in a fresh Workspace with one publish. Serving:
   ``build_step``'s prefill (flash kernel) of 4 x 1024 tokens and 31
   decode steps on the arena of a stable load, against the meshless
   ``models.prefill`` / ``decode_step`` on the same params: the logits the
   same bits, the tokens equal, launches exactly 26 flash (wgmma) and 105
   rmsnorm a prefill and a step. Training: a meshless ``Trainer`` and one
   with ``mesh=make_local_mesh()``, 3 steps of 2 x 4096 tokens each, no
   checkpoint: the same loss bits; the mesh run's launches exactly 1 paged
   copy, 209 rmsnorm forward and 105 backward a step, 0 flash; its params
   DTensors over views of its arena, which holds the trained values. Then
   ``int8_allreduce_mean`` over the group equals ``dequantize_int8(
   quantize_int8(x))``. The step, prefill and decode step times are
   printed beside the meshless ones (DTensor's host cost).

``--phases`` runs only the listed phases (the build always runs) and prints
no result lines: it is for development on the card.

Output: progress lines, then the kernel record as one JSON line, the
card's name and power limit, and last the contract line
``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json``. Without a card, or without the repository
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
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
# rmsnorm's backward at gemma3-1b's training shapes (phase 11: 2 x 4096
# tokens), launches a step: attn, mlp and final norm; q-norm (4 heads); k-norm
RMS_BWD_TRAIN = {(8192, 1152): 53, (32768, 256): 26, (8192, 256): 26}
RMS_BWD_TRAIN_KERNELS = (     # the instantiations those shapes run (bf16)
    "rmsnorm_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 8, 128, 2>",
    "rmsnorm_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 8, 32, 1>")
RMS_BWD_FLOPS = 12            # per element: the two row sums, dx, dscale's term
DSCALE_TOL = 1e-4             # of the float32 plain sum's largest value

# the main path
ARCH, BATCH, PROMPT, NEW = "gemma3-1b", 4, 1024, 32
FLASH_PER_PREFILL = 26
RMS_PER_STEP = 105            # 4 per layer (attn, q, k, mlp) + final norm
# serving across an epoch (phase 5)
SERVE_REQUESTS, SERVE_SLOTS, SERVE_CACHE = 12, 4, 1056
SERVE_LENS = (256, 512, 768, 1024)
FLIP_AFTER = 6                # the source commits v2 after this many requests
# the traffic plane (phase 6): two worker processes on the card
# drive A's rate stays below what two workers served under overload
# (1.25-1.6 req/s at 4 req/s offered), so its latencies describe a steady load
TRAFFIC_REQUESTS, TRAFFIC_RATE_HZ, TRAFFIC_ROLL_AT = 32, 1.0, 16
KILL_REQUESTS, KILL_PROMPT, KILL_RATE_HZ = 12, 256, 4.0
KILL_STEP = 40                # worker 1's warmup takes 31 steps: mid-stream
# the reference's paged-copy cases (tests/test_kernels.py): (pages, copies)
PAGED_CASES = [(4, 2), (64, 64), (128, 37)]
# the MoE and encoder-decoder families at their published widths (phases 7
# and 8): the same static batch, then serve_loop over mixed prompt lengths
MOE_ARCH, ENCDEC_ARCH = "olmoe-1b-7b", "seamless-m4t-large-v2"
MOE_FLASH, MOE_RMS = 16, 65   # per prefill; rmsnorm 4 a layer + final norm
ENCDEC_FLASH, ENCDEC_CROSS = 72, 24   # 24 encoder + 24 decoder self, 24 cross
MIX_REQUESTS = 8              # serve_loop requests of SERVE_LENS tokens
# the SSM and hybrid families at their published widths (phases 9 and 10):
# launches a prefill (rmsnorm also a decode step): mamba2 2 norms a block
# and the final norm; zamba2 also 14 shared-block invocations, each one
# flash launch at hd 224 and 2 norms
SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "zamba2-7b"
SSM_FLASH, SSM_RMS = 0, 97              # 2 x 48 + 1
HYBRID_FLASH, HYBRID_RMS = 14, 191      # 2 x 81 + 2 x 14 + 1
# training at published widths (phase 11): gemma3-1b at the reference's
# train_4k sequence length, global batch 2 (8,192 tokens a step); a failure
# injected at step 4, after the step-3 checkpoint
TRAIN_SEQ, TRAIN_BATCH = 4096, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 5, 3, 4
TRAIN_OPT = {"peak_lr": 1e-4, "warmup_steps": 2, "decay_steps": 5}
# the multi-device layer on one card (phase 12): make_local_mesh(), the
# static batch's prompts then this many decode steps, and this many
# training steps at the training shape, each beside its meshless run
MESH_DECODE, MESH_TRAIN_STEPS = 31, 3
# the kernel path's loss and gradient errors against a float32 plain-norm
# run: at most this times the bf16 plain-norm run's
GRAD_RATIO = 1.5
# an MoE layer's output against the per-expert float32 FFN, relative to the
# layer's largest output value (bf16 rounds each product and sum at 2**-8)
MOE_OUT_TOL = 0.03
# olmoe's forward logits: the kernel path's mean error against a float32
# run, at most this times the bf16 plain-attention run's. A mean over all
# 4 x 1024 x 50304 logits: routing flips near ties (a fifth of the
# token-layers between any two bf16 runs) make a max over a few positions
# swing from run to run
MOE_LOGIT_RATIO = 1.5

# device_ms profiles that recorded no device time (each is taken again)
EMPTY_PROFILES: list[dict] = []
T0 = time.perf_counter()      # the stamp of every log line counts from here

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 tensor flop/s
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6               # the H100's L2 (NVIDIA data sheet)
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script started."""
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


def rotating(fn, sets: list):
    """A zero-argument call of ``fn`` that takes the next tuple of ``sets``
    (``input_sets``) at each call, in turn. It also keeps each call's
    result until its set comes round again, so the outputs rotate over as
    many buffers: an output written into the block of the call before
    would find its lines in L2 and never pay their write to memory."""
    state = {"i": 0}
    kept = [None] * len(sets)

    def call():
        i = state["i"] % len(sets)
        state["i"] += 1
        kept[i] = None
        kept[i] = fn(*sets[i])
        return kept[i]
    return call


def input_sets(make, set_bytes: int) -> list:
    """Copies of one timed call's inputs, totalling more than twice the L2
    (``L2_BYTES``): ``make(n)`` returns a tuple of tensors, each with a
    leading axis of n copies, and set i is their i-th copies. A timed call
    that takes them in turn (``rotating``) finds none of its inputs in L2
    from the calls before it, as the model's caller does not."""
    n = int(2 * L2_BYTES // set_bytes) + 1
    made = make(n)
    return [tuple(t[i] for t in made) for i in range(n)]


def time_ms(fn, min_total_ms: float = 40.0) -> float:
    """Mean milliseconds per call on the card: CUDA events around a run of
    back-to-back calls after a warm-up (so a small kernel's time includes
    its launch cost when the host is the slower side). A kernel's timed
    calls rotate their inputs over ``input_sets``, so L2 holds none of
    them."""
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
        if source == rn.SOURCE:        # 48 instantiations a pass: summary lines
            for what, prefix in (("forward", "rmsnorm_kernel"),
                                 ("backward", "rmsnorm_bwd_kernel"),
                                 ("backward column sums", "col_sum_kernel")):
                part = [r for r in rows if r["kernel"].startswith(prefix)]
                log(f"  ptxas {what}: {len(part)} kernels, at most "
                    f"{max((r['regs'] for r in part), default=0)} registers, "
                    f"{sum(r['spill_bytes'] for r in part)} spill bytes in all")
            for r in rows:
                if r["spill_bytes"] or r["kernel"] in RMS_BWD_TRAIN_KERNELS:
                    log(f"  ptxas: {r['kernel']}: {r['regs']} registers, "
                        f"{r['spill_bytes']} spill bytes")
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
        sets = flash_sets(case, g)
        mask = _mask(Sq, Sk, window, dev)

        def sdpa(q, k, v):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window > 0:
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        kernel = rotating(lambda q, k, v: fa.flash_attention(q, k, v, causal=True,
                                                             window=window), sets)
        library = rotating(sdpa, sets)
        row = {
            "case": case,
            "route": fa.route(torch.bfloat16, hd),
            "ms": time_ms(kernel),
            "plain_ms": time_ms(rotating(lambda q, k, v: fa.flash_attention_plain(
                q, k, v, causal=True, window=window), sets)),
            "library_ms": time_ms(library),
            "simt_ms": time_ms(simt_launcher(*sets[0], window)),
            "device_ms": device_ms(kernel, f"flash {case}"),
            "library_device_ms": device_ms(library, f"sdpa {case}"),
        }
        del sets
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


def flash_sets(case, g) -> list:
    """bf16 (q, k, v) sets for a flash case, rotated by its timed calls."""
    import torch

    B, Sq, Sk, H, KV, hd = case[:6]
    set_bytes = (B * Sq * H * hd + 2 * B * Sk * KV * hd) * 2
    return input_sets(lambda n: tuple(
        torch.randn((n, B, S, h, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        for S, h in ((Sq, H), (Sk, KV), (Sk, KV))), set_bytes)


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


def flash_path_cases() -> dict:
    """The prefill shapes of phases 7, 8 and 10 (B, Sq, Sk, H, KV, hd,
    causal, window): olmoe at hd 128, seamless's self-attention at hd 64
    and its cross-attention, non-causal, over the encoder's 1024 positions,
    and zamba2's shared block at hd 224 (2 * d / heads)."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid

    moe, ed, hy = get_config(MOE_ARCH), get_config(ENCDEC_ARCH), get_config(HYBRID_ARCH)
    return {
        f"{HYBRID_ARCH} shared": (BATCH, PROMPT, PROMPT, hy.num_heads, hy.num_kv_heads,
                                  hybrid._hd(hy), True, 0),
        f"{MOE_ARCH} self": (BATCH, PROMPT, PROMPT, moe.num_heads, moe.num_kv_heads,
                             moe.resolved_head_dim, True, 0),
        f"{ENCDEC_ARCH} self": (BATCH, PROMPT, PROMPT, ed.num_heads, ed.num_kv_heads,
                                ed.resolved_head_dim, True, 0),
        f"{ENCDEC_ARCH} cross": (BATCH, PROMPT, PROMPT, ed.num_heads, ed.num_kv_heads,
                                 ed.resolved_head_dim, False, 0),
    }


def check_flash_hd224() -> list[dict]:
    """The wgmma route at hd 224 (on the hd-256 tile) against the plain
    version, bf16 within 2e-2: the reference's sweep shapes at hd 224 and
    causal attention with a window."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [c[:5] + (224,) + c[6:] for c in FA_CASES] + [
        (2, 1024, 1024, 8, 8, 224, True, 512)]
    out = []
    for case in cases:
        B, Sq, Sk, H, KV, hd, causal, window = case
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device="cuda",
                               dtype=torch.bfloat16)
                   for S, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        if fa.route(q.dtype, hd) != "wgmma":
            fail(f"flash_attention {case}: bf16 at hd 224 is not on the wgmma route")
        before = fa.launches_by_route["wgmma"]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if fa.launches_by_route["wgmma"] != before + 1:
            fail(f"flash_attention {case}: the wgmma route did not launch")
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        out.append({"case": case, "dtype": "bfloat16", "route": "wgmma",
                    "max_abs_err": err})
        if not err <= FA_TOL["bfloat16"]:
            fail(f"flash_attention {case} bf16: max err {err} > {FA_TOL['bfloat16']}")
    log(f"flash_attention hd 224: {len(out)} cases on the wgmma route agree with the "
        f"plain version (max err {max(e['max_abs_err'] for e in out):.2e})")
    return out


def check_flash_paths() -> list[dict]:
    """flash_attention at the new paths' shapes: against its plain version
    (bf16 within 2e-2, on the wgmma route), then timed beside SDPA and its
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for what, case in flash_path_cases().items():
        B, Sq, Sk, H, KV, hd, causal, window = case
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for S, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        before = fa.launches_by_route["wgmma"]
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if fa.launches_by_route["wgmma"] != before + 1:
            fail(f"flash_attention {what}: the wgmma route did not launch")
        err = (got.float() - fa.flash_attention_plain(q, k, v, causal=causal).float()
               ).abs().max().item()
        if not err <= FA_TOL["bfloat16"]:
            fail(f"flash_attention {what} {case}: max err {err} > {FA_TOL['bfloat16']}")
        del q, k, v, got
        sets = flash_sets(case, g)

        def sdpa(q, k, v):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        kernel = rotating(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal), sets)
        library = rotating(sdpa, sets)
        row = {"path": what, "case": case, "max_abs_err": err,
               "ms": time_ms(kernel),
               "plain_ms": time_ms(rotating(lambda q, k, v: fa.flash_attention_plain(
                   q, k, v, causal=causal), sets)),
               "library_ms": time_ms(library),
               "device_ms": device_ms(kernel, f"flash {what}"),
               "library_device_ms": device_ms(library, f"sdpa {what}")}
        del sets
        row["bound_ms"], row["bound_by"] = bound_ms(*flash_work(case), BF16_FLOPS)
        rows.append(row)
        log(f"flash_attention {what} {case}: err {err:.2e}, kernel {row['ms']:.4f} ms "
            f"(device {row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms (device {row['library_device_ms']:.4f} ms), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def device_ms(fn, what: str, calls: int = 50, attempts: int = 3) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler
    (the CUDA-event times of small launches measure the host instead). A
    profile that recorded no device time at all is logged, kept in
    ``EMPTY_PROFILES`` (written to ``build/chip_smoke.json``) and taken
    again, up to ``attempts`` times; if none records any, the run fails.
    Why a profile comes back empty is not known yet."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / calls
        EMPTY_PROFILES.append({
            "what": what, "attempt": attempt, "events": len(events),
            "cuda_events": sum(e.device_type == torch.autograd.DeviceType.CUDA
                               for e in events)})
        log(f"device_ms({what}): profile {attempt} of {attempts} recorded no "
            f"device time ({EMPTY_PROFILES[-1]})")
    fail(f"torch.profiler recorded no device time for {what} in {attempts} profiles")


def rms_mix(cfg) -> dict:
    """{(rows, d): launches} of one main-path run (prefill + decode steps).
    mamba2: each block's norm at d and gated norm at d_inner; the hybrid
    adds its shared block's two norms at 2*d per invocation."""
    L, d = cfg.num_layers, cfg.d_model
    mix: dict = {}

    def add(shape, n):
        mix[shape] = mix.get(shape, 0) + n

    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import hybrid

        invocations = hybrid.n_invocations(cfg) if cfg.family == "hybrid" else 0
        for rows, n in ((BATCH * PROMPT, 1), (BATCH, NEW - 1)):
            add((rows, d), L * n)                   # norm
            add((rows, cfg.ssm_inner), L * n)       # gate_norm
            if invocations:
                add((rows, 2 * d), 2 * invocations * n)  # shared norm, mlp_norm
        add((BATCH, d), NEW)                        # final_norm
        return mix
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    add((BATCH * PROMPT, d), 2 * L)            # attn_norm, mlp_norm
    add((BATCH * PROMPT * H, hd), L)           # q_norm
    add((BATCH * PROMPT * KV, hd), L)          # k_norm
    add((BATCH, d), 1)                         # final_norm, last position
    steps = NEW - 1
    add((BATCH, d), (2 * L + 1) * steps)
    add((BATCH * H, hd), L * steps)
    add((BATCH * KV, hd), L * steps)
    return mix


def rms_rows(mix: dict, g) -> list[dict]:
    """rmsnorm timed at each (rows, d) of a main-path mix: the kernel and
    ``F.rms_norm`` in turns (their calls' time is the host's), the plain
    version, profiler device times, and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn

    out = []
    for (rows, d), n in sorted(mix.items()):
        sets = input_sets(lambda k: (torch.randn((k, rows, d), generator=g, device="cuda",
                                                 dtype=torch.bfloat16),), rows * d * 2)
        s = torch.randn((d,), generator=g, device="cuda", dtype=torch.bfloat16)
        kernel = rotating(lambda x: rn.rmsnorm(x, s), sets)
        library = rotating(lambda x: F.rms_norm(x, (d,), weight=s, eps=1e-6), sets)
        ms, library_ms = time_pair_ms(kernel, library)
        row = {
            "shape": (rows, d),
            "ms": ms,
            "plain_ms": time_ms(rotating(lambda x: rn.rmsnorm_plain(x, s), sets)),
            "library_ms": library_ms,
            "device_ms": device_ms(kernel, f"rmsnorm {rows}x{d}"),
            "library_device_ms": device_ms(library, f"F.rms_norm {rows}x{d}"),
        }
        del sets
        row["bytes"], row["flops"] = (2 * rows * d + d) * 2, 4.0 * rows * d
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["flops"], F32_FLOPS)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["weight"] = n
        out.append(row)
        log(f"rmsnorm {(rows, d)} x{n}: kernel {row['ms']:.4f} ms a call (device "
            f"{row['device_ms'] * 1e3:.3f} us, {row['bound_share']:.1%} of the bound), "
            f"plain {row['plain_ms']:.4f} ms, F.rms_norm {row['library_ms']:.4f} ms "
            f"(device {row['library_device_ms'] * 1e3:.3f} us), bound "
            f"{row['bound_ms']:.5f} ms")
    return out


def check_rmsnorm(cfg, others) -> dict:
    """rmsnorm against its plain version at the sweep cases and at both
    configs' main-path shapes, then timed at each; the record's times are
    ``cfg``'s mix; each of ``others``' go to ``_per_shape_other``."""
    import torch

    from repro_torch.kernels.rmsnorm import ops as rn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    mix = rms_mix(cfg)
    other_mixes = {c.name: rms_mix(c) for c in others}
    errs, worst_serving = [], 0.0
    for shape in RMS_CASES + sorted(set(mix).union(*other_mixes.values())):
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

    per_shape = rms_rows(mix, g)
    total = sum(mix.values())
    totals = {key: sum(r[key] * r["weight"] for r in per_shape) / total
              for key in ("ms", "plain_ms", "library_ms", "device_ms")}
    per_other = {}
    for name, other_mix in other_mixes.items():
        log(f"rmsnorm at {name}'s shapes:")
        per_other[name] = rms_rows(other_mix, g)
    return {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:31",
        "max_abs_err": worst_serving,
        **totals,
        **mix_bound([(r["weight"], r["bytes"], r["flops"]) for r in per_shape],
                    F32_FLOPS),
        "_cases": errs,
        "_per_shape": per_shape,
        "_per_shape_other": per_other,
    }


def rms_bwd_inputs(shape, dt, g, copies: int = 1) -> tuple:
    """x, scale and dy for the backward at ``shape``: x and dy with a
    leading axis of ``copies``."""
    import torch

    x = torch.randn((copies,) + shape, generator=g, device="cuda").to(dt)
    s = (1 + 0.5 * torch.randn(shape[-1], generator=g, device="cuda")).to(dt)
    dy = torch.randn((copies,) + shape, generator=g, device="cuda").to(dt)
    return x, s, dy


def check_rmsnorm_backward() -> dict:
    """rmsnorm's backward kernel against ``rmsnorm_backward_plain``: the
    sweep's cases in float32 and bfloat16, gemma3-1b's training shapes in
    bfloat16; dx within RMS_TOL, dscale within DSCALE_TOL of the float32
    plain sum's largest value (plus bf16's rounding of each value), and
    both the same bits on a second call. Then each training shape timed:
    the kernel and the library's backward (``torch.autograd.grad`` through
    ``F.rms_norm``, graphs built beforehand) in turns, the plain version,
    profiler device times, and the bound, with inputs rotated out of L2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rn

    g = torch.Generator(device="cuda").manual_seed(5)
    errs, worst = [], 0.0
    cases = [(shape, dt) for shape in RMS_CASES for dt in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in RMS_BWD_TRAIN]
    for shape, dt in cases:
        x, s, dy = (t[0] if t.dim() > 1 else t for t in rms_bwd_inputs(shape, dt, g))
        dx, ds = rn._launch_backward(x, s, dy, 1e-6)
        dx2, ds2 = rn._launch_backward(x, s, dy, 1e-6)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
            fail(f"rmsnorm backward {shape} {name}: two calls differ")
        want_dx, _ = rn.rmsnorm_backward_plain(x, s, dy)
        f32_ds = rn.rmsnorm_backward_plain(x.float(), s.float(), dy.float())[1]
        atol, rtol = RMS_TOL[name]
        diff = (dx.float() - want_dx.float()).abs()
        err = diff.max().item()
        if not (diff - rtol * want_dx.float().abs()).max().item() <= atol:
            fail(f"rmsnorm backward {shape} {name}: dx error {err} beyond {atol} + "
                 f"{rtol}*|dx|")
        ds_err = (ds.float() - f32_ds).abs()
        ds_tol = DSCALE_TOL * f32_ds.abs().max() + (
            2.0**-8 * f32_ds.abs() if dt == torch.bfloat16 else 0)
        if not bool((ds_err <= ds_tol).all()):
            fail(f"rmsnorm backward {shape} {name}: dscale error "
                 f"{ds_err.max().item()} beyond {DSCALE_TOL} of its largest value")
        errs.append({"shape": shape, "dtype": name, "dx_max_abs_err": err,
                     "dscale_max_rel_err": (ds_err.max() / f32_ds.abs().max()).item()})
        if shape in RMS_BWD_TRAIN:
            worst = max(worst, err)
    log(f"rmsnorm backward: {len(errs)} cases agree with the plain version, the "
        "same bits on a second call")

    per_shape = []
    for shape, n in RMS_BWD_TRAIN.items():
        rows, d = shape
        sets_n = int(2 * L2_BYTES // (2 * rows * d * 2)) + 1
        x, s, dy = rms_bwd_inputs(shape, torch.bfloat16, g, sets_n)
        sets = [(x[i], dy[i]) for i in range(sets_n)]
        xs = [x[i].detach().requires_grad_() for i in range(sets_n)]
        sg = s.detach().requires_grad_()
        ys = [F.rms_norm(xi, (d,), weight=sg, eps=1e-6) for xi in xs]
        lib_sets = [(xs[i], ys[i], dy[i]) for i in range(sets_n)]
        kernel = rotating(lambda xi, dyi: rn._launch_backward(xi, s, dyi, 1e-6), sets)
        library = rotating(lambda xi, yi, dyi: torch.autograd.grad(
            yi, (xi, sg), dyi, retain_graph=True), lib_sets)
        ms, library_ms = time_pair_ms(kernel, library)
        row = {
            "shape": shape, "ms": ms, "library_ms": library_ms,
            "plain_ms": time_ms(rotating(
                lambda xi, dyi: rn.rmsnorm_backward_plain(xi, s, dyi), sets)),
            "device_ms": device_ms(kernel, f"rmsnorm backward {rows}x{d}"),
            "library_device_ms": device_ms(library, f"F.rms_norm backward {rows}x{d}"),
        }
        del sets, lib_sets, xs, ys, x, dy
        row["bytes"] = (3 * rows * d + 2 * d) * 2      # x, dy, dx; scale, dscale
        row["flops"] = float(RMS_BWD_FLOPS * rows * d)
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["flops"], F32_FLOPS)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        if row["bound_share"] > 1.0:
            fail(f"rmsnorm backward {shape}: device time {row['device_ms']} ms is "
                 f"below its bound {row['bound_ms']} ms")
        row["weight"] = n
        per_shape.append(row)
        log(f"rmsnorm backward {shape} x{n}: kernel {row['ms']:.4f} ms a call (device "
            f"{row['device_ms'] * 1e3:.3f} us, {row['bound_share']:.1%} of the bound), "
            f"plain {row['plain_ms']:.4f} ms, F.rms_norm backward "
            f"{row['library_ms']:.4f} ms (device {row['library_device_ms'] * 1e3:.3f} us),"
            f" bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    torch.cuda.empty_cache()
    total = sum(RMS_BWD_TRAIN.values())
    totals = {key: sum(r[key] * r["weight"] for r in per_shape) / total
              for key in ("ms", "plain_ms", "library_ms", "device_ms",
                          "library_device_ms")}
    return {
        "name": "rmsnorm_backward",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/models/common.py:25",
        "replaces_what": "jax.vjp of the reference's jnp rms_norm (it has no "
                         "Pallas backward)",
        "max_abs_err": worst,
        **totals,
        **mix_bound([(r["weight"], r["bytes"], r["flops"]) for r in per_shape],
                    F32_FLOPS),
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


# --------------------------------------------------------------- phase 3
def profiled(run, what: str) -> dict:
    """``run()`` under torch.profiler: device time by kernel and the card's
    busy share of the wall time (the profiler's own cost lengthens the
    wall, so the idle share it gives is an upper bound). ``run`` ends in a
    synchronisation and returns a dict of its own figures. Only the card's
    activity is traced: host-side operator events added nothing read here
    and took most of a profile's time to collect (tens of seconds at
    zamba2-7b's 100,000 launches of a generate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def decode_bytes(cfg, cache_rows: float) -> float:
    """Bytes one decode step of a BATCH-row batch must move, from ``cfg``'s
    parameter specs: every weight of the decoder but the embedding table
    (of which BATCH rows, unless it is the tied output layer), the hybrid's
    shared block once per invocation; the keys and values of each
    attention (a transformer layer's, or a hybrid invocation's at its
    2*d/heads head_dim) over ``cache_rows`` rows (an encoder-decoder's
    cross keys and values over PROMPT rows; its encoder is not read); and
    an SSM's conv and SSM state, read and written."""
    import numpy as np

    from repro_torch import models
    from repro_torch.device import torch_dtype
    from repro_torch.models import hybrid, mamba2

    encoder = ("enc/", "enc_final_norm/", "frontend/")
    uses = hybrid.n_invocations(cfg) if cfg.family == "hybrid" else 1
    nbytes = 0
    for n, spec in models.param_specs(cfg).items():
        if (n == "embed/tokens" and not cfg.tie_embeddings) or n.startswith(encoder):
            continue
        size = int(np.prod(spec.shape)) * torch_dtype(spec.dtype).itemsize
        nbytes += size * (uses if n.startswith("shared_attn/") else 1)
    nbytes += BATCH * cfg.d_model * torch_dtype(cfg.dtype).itemsize
    if cfg.family in ("ssm", "hybrid"):
        shapes, _ = mamba2.cache_spec(cfg, BATCH, 0)
        for name in ("conv", "ssm"):
            shape, dt = shapes[name]
            nbytes += 2 * int(np.prod(shape)) * torch_dtype(dt).itemsize
    if cfg.family == "ssm":
        return float(nbytes)
    if cfg.family == "hybrid":
        kv_row = uses * BATCH * cfg.num_kv_heads * hybrid._hd(cfg) * 2 * 2
    else:
        kv_row = cfg.num_layers * BATCH * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2
    return float(nbytes + kv_row * (cache_rows + (PROMPT if cfg.is_encdec else 0)))


def static_batch(cfg, ws, host, want: dict) -> tuple:
    """The static batch of phases 3 and 7-10: ``serve`` with ``strategy=
    "stable"`` (1 paged copy) over BATCH prompts of PROMPT tokens, NEW new
    tokens; the launch counts must equal ``want``, every slot the host
    image's bytes; then the same ``generate`` again, and once more
    profiled. Returns (the ``ServeRun``, its figures)."""
    import torch

    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import serve

    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = serve(cfg, ws, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                strategy="stable", device="cuda")
    wall = time.perf_counter() - t0
    got = {**launch_counts(), "non_causal": fa.launches_non_causal}
    log(f"{cfg.name} static batch ran in {wall:.1f} s; launches {got}, expected {want}")
    if got != want:
        fail(f"{cfg.name}: kernel launches {got} != {want}")
    if tuple(run.tokens.shape) != (BATCH, NEW) or not (
            0 <= run.tokens.min() and run.tokens.max() < cfg.vocab_size):
        fail(f"{cfg.name}: bad tokens {run.tokens.shape}")
    engine = run.engine
    slots_equal(engine.params, host)
    split = load_split(engine.load_stats)
    log(f"{cfg.name}: device arena equals the host image in all {len(host.tensors)} "
        f"slots; load split {json.dumps(split)}")
    _, steady = engine.generate(run.prompts, NEW)

    def steady_generate():
        _, stats = engine.generate(run.prompts, NEW)
        return {"prefill_s": stats.prefill_s, "decode_s": stats.decode_s}

    profile = profiled(steady_generate, f"{cfg.name} generate")
    step_s = steady.decode_s / (NEW - 1)
    mean_rows = PROMPT + NEW / 2
    nbytes = decode_bytes(cfg, mean_rows)
    s = run.summary
    out = {"launches": got, "wall_s": wall, "load_strategy": s["load_strategy"],
           "load_s": s["load_s"], "load_split": split, "prefill_s": s["prefill_s"],
           "decode_s": s["decode_s"], "tok_per_s": s["tok_per_s"],
           "steady_prefill_s": steady.prefill_s, "steady_decode_s": steady.decode_s,
           "steady_tok_per_s": steady.tok_per_s, "decode_step_s": step_s,
           "decode_step_bytes": nbytes,
           "decode_step_bound_s": nbytes / HBM_BYTES_PER_S, "profile": profile,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{cfg.name} static batch: " + json.dumps({k: out[k] for k in (
        "load_s", "prefill_s", "steady_prefill_s", "steady_decode_s",
        "steady_tok_per_s", "decode_step_s", "decode_step_bytes",
        "decode_step_bound_s", "peak_mem_gb")}))
    return run, out


def prefill_logits_check(cfg, params, batch) -> dict:
    """Prefill logits of the kernel path: finite, and against a float32
    plain-attention run on the card no further off than 1.5x the bf16
    plain-attention run."""
    import torch

    from repro_torch import models

    with torch.inference_mode():
        kern, _ = models.prefill(cfg, params, batch, impl="kernel")
        plain, _ = models.prefill(cfg, params, batch, impl="naive")
        p32 = {n: t.float() for n, t in params.items()}
        ref, _ = models.prefill(cfg.replace(dtype="float32"), p32, batch, impl="naive")
        del p32
    if not bool(torch.isfinite(kern).all()):
        fail(f"{cfg.name}: prefill logits are not finite")
    err_k = (kern.float() - ref).abs().max().item()
    err_p = (plain.float() - ref).abs().max().item()
    log(f"{cfg.name} prefill logits vs f32 plain: kernel path {err_k:.5f}, bf16 plain "
        f"path {err_p:.5f}")
    if not err_k <= 1.5 * err_p:
        fail(f"{cfg.name}: kernel path error {err_k} > 1.5 x bf16 plain error {err_p}")
    del kern, plain, ref
    torch.cuda.empty_cache()
    return {"logits_err_kernel": err_k, "logits_err_bf16_plain": err_p}


def main_path(cfg, ws, host) -> dict:
    import torch

    from repro_torch import models

    want = {"flash_attention": FLASH_PER_PREFILL, "rmsnorm": RMS_PER_STEP * NEW,
            "rmsnorm_backward": 0, "paged_reloc_copy": 1, "non_causal": 0,
            "flash_routes": {"wgmma": FLASH_PER_PREFILL, "simt": 0}}
    run, result = static_batch(cfg, ws, host, want)
    result.update(prefill_logits_check(
        cfg, run.engine.params, {"tokens": torch.as_tensor(run.prompts, device="cuda")}))
    result["n_params"] = models.n_params(cfg)
    del run
    torch.cuda.empty_cache()
    return result


# --------------------------------------------------------------- phase 4
def small_input(arch: str) -> dict:
    """``arch``'s smoke config on the card and on the CPU: prefill logits
    within 1e-4, the same greedy tokens, and identical ``serve_loop``
    completions (mixed prompt lengths, 2 slots), greedy and sampled."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.serve import STOP, Request, ServeEngine
    from repro_torch.serve.scheduler import stub_frames

    cfg = get_config(arch, smoke=True)
    cpu = models.init_params(cfg, 0, "cpu")
    gpu = {n: t.to("cuda") for n, t in cpu.items()}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40), dtype=np.int32)
    outs = {}
    with torch.inference_mode():
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            if cfg.is_encdec:
                batch["frames"] = stub_frames(cfg, 2, 40, dev)
            logits, cache = models.prefill(cfg, params, batch, cache_len=48)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            seq = [tok]
            for _ in range(7):
                lg, cache = models.decode_step(cfg, params, cache, tok)
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                seq.append(tok)
            outs[dev] = (logits.float().cpu(), torch.cat(seq, 1).cpu())
    err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    same = torch.equal(outs["cpu"][1], outs["cuda"][1])
    log(f"{cfg.name} card vs CPU: logits err {err:.2e}, tokens equal {same}")
    if not (err <= 1e-4 and same):
        fail(f"card and CPU disagree on {cfg.name}")

    # the same serve_loop on both: mixed lengths around gemma3's window of 16
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
            fail(f"{cfg.name}: {mode} serve_loop differs between card and CPU")
    log(f"{cfg.name} serve_loop card vs CPU: identical completions, greedy and sampled")
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

    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.serve import STOP, Request, ServeEngine

    zero_launch_counts()
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
    got = launch_counts()
    want = {"flash_attention": FLASH_PER_PREFILL * report.admitted,
            "rmsnorm": RMS_PER_STEP * (report.admitted + report.steps),
            "rmsnorm_backward": 0, "paged_reloc_copy": 2,
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


# --------------------------------------------------------------- phase 6
def shm_free_check(need: int, what: str) -> float:
    """Free bytes of /dev/shm, printed; fails if ``need`` does not fit."""
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    log(f"/dev/shm: {free / 1e9:.1f} GB free; {what} needs {need / 1e9:.3f} GB")
    if free < need:
        fail(f"/dev/shm holds {free} bytes, too few for {what} ({need} bytes): "
             "the stable-shm arena is one POSIX segment of the whole arena")
    return free


def host_digest(ws, app) -> tuple[str, int]:
    """Digest of the current generation loaded on the host (the reference
    for every worker's digest), and its arena's size in bytes."""
    from repro_torch.core.shm_arena import tensors_digest

    img = ws.load(app, strategy="stable")
    return tensors_digest(img.tensors), int(img.arena.nbytes)


class MemorySampler:
    """The card's ``memory.used`` from nvidia-smi, once a second, on a
    thread, between ``start`` and ``stop``; ``peak_mib`` is the largest."""

    def __init__(self):
        import threading

        self.samples: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            res = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60)
            if res.returncode == 0 and res.stdout.strip():
                self.samples.append(int(res.stdout.split()[0]))
            self._stop.wait(1.0)

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> int | None:
        self._stop.set()
        self._thread.join(timeout=90)
        return max(self.samples) if self.samples else None


def worker_launches(stats: dict, flips: int) -> tuple[dict, dict]:
    """(counted, expected) launches of one traffic worker: the paged copy
    once at start and once per flip (``stable`` builds its arena on the
    card), 26 flash launches per admission (all wgmma) and 105 rmsnorm
    launches per admission and per step."""
    loop = stats["serve_loop"]
    adm, steps = loop["admitted"], loop["steps"]
    want = {"flash_attention": FLASH_PER_PREFILL * adm,
            "rmsnorm": RMS_PER_STEP * (adm + steps),
            "rmsnorm_backward": 0, "paged_reloc_copy": 1 + flips,
            "flash_routes": {"wgmma": FLASH_PER_PREFILL * adm, "simt": 0}}
    return stats["launches"], want


def check_streams(rep, n: int, vocab: int, what: str, *, dups_allowed: bool) -> None:
    """Every stream reassembled whole, equal to its completion row, with
    tokens inside the vocabulary. A re-routed request's replay may deliver
    spans twice (absorbed by seq), so only a drive without a kill must
    have no duplicates."""
    if (rep.stream_gaps or rep.stream_mismatches
            or (rep.stream_dup_frames and not dups_allowed)):
        fail(f"drive {what}: stream gaps {rep.stream_gaps}, mismatches "
             f"{rep.stream_mismatches}, duplicates {rep.stream_dup_frames}")
    if set(rep.stream_tokens) != set(range(n)):
        fail(f"drive {what}: streams of {sorted(rep.stream_tokens)} reassembled")
    for rid, toks in rep.stream_tokens.items():
        if len(toks) != NEW or not (0 <= toks.min() and toks.max() < vocab):
            fail(f"drive {what}: bad stream {rid}: {toks}")


def drive_summary(rep) -> dict:
    s = rep.summary()
    s.pop("worker_stats")
    s.update(steady_p99_latency_s=rep.steady_p99_s,
             rollover_p99_latency_s=rep.rollover_p99_s,
             kill_p99_latency_s=rep.kill_p99_s, ttft_p50_s=rep.ttft_p50_s,
             ttft_p99_s=rep.ttft_p99_s, p50_latency_s=rep.p50_s,
             p99_latency_s=rep.p99_s, req_per_s=rep.req_per_s,
             tok_per_s=rep.tok_per_s, wall_s=rep.wall_s)
    return s


def served_tokens_check(cfg, rep, prompts, gens: dict) -> dict:
    """Every served stream of a drive against an independent computation.
    ``gens`` maps each generation to (seed, digest of its host image). Each
    worker names the generation that served each rid (``served_gen`` in its
    statistics file); that generation's weights are made again here from
    its seed (their digest must equal the host image's), and one
    full-sequence forward of prompt + stream with plain attention, no cache
    and no slots, in this process, gives the logits at every served
    position, in float32 and in bf16. A served token must be the float32
    forward's argmax or fall below its max by at most 3x the bf16
    forward's logit error: a greedy token of the kernel path, whose logits
    lie within 1.5x that error (phase 3), can fall no further than twice
    its own error."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.core.shm_arena import tensors_digest

    served = {}
    for st in rep.worker_stats:
        served.update({int(r): g for r, g in st["served_gen"].items()
                       if int(r) in rep.stream_tokens})
    if set(served) != set(rep.stream_tokens) or not set(served.values()) <= set(gens):
        fail(f"served generations {served} do not cover the streams "
             f"{sorted(rep.stream_tokens)} on generations {sorted(gens)}")
    plen = prompts.shape[1]
    cfg32 = cfg.replace(dtype="float32")
    out = {"rids_by_gen": {}, "positions": 0, "argmax_equal": 0,
           "max_margin": 0.0, "max_margin_over_tol": 0.0, "tol": []}
    for gen, (seed, digest) in sorted(gens.items()):
        rids = sorted(r for r, g in served.items() if g == gen)
        out["rids_by_gen"][gen] = rids
        if not rids:
            continue
        params = models.init_params(cfg, seed, "cuda")
        if tensors_digest(params) != digest:
            fail(f"weights made again from seed {seed} differ from generation {gen}")
        p32 = {n: t.float() for n, t in params.items()}
        for i in range(0, len(rids), 4):
            chunk = rids[i:i + 4]
            streams = np.stack([rep.stream_tokens[r] for r in chunk])
            seqs = np.concatenate([prompts[chunk], streams[:, :-1]], axis=1)
            tokens = torch.as_tensor(seqs, device="cuda")
            with torch.inference_mode():
                l32 = models.forward(cfg32, p32, {"tokens": tokens},
                                     impl="naive")[0][:, plen - 1:]
                lbf = models.forward(cfg, params, {"tokens": tokens},
                                     impl="naive")[0][:, plen - 1:].float()
            err = (lbf - l32).abs().amax(dim=(1, 2))
            want = torch.as_tensor(streams, device="cuda").long()
            margin = l32.amax(-1) - l32.gather(-1, want[..., None])[..., 0]
            tol = 3 * err[:, None]
            out["positions"] += margin.numel()
            out["argmax_equal"] += int((l32.argmax(-1) == want).sum())
            out["max_margin"] = max(out["max_margin"], float(margin.max()))
            out["max_margin_over_tol"] = max(out["max_margin_over_tol"],
                                             float((margin / tol).max()))
            out["tol"] += tol[:, 0].tolist()
            bad = (margin > tol).nonzero().tolist()
            if bad:
                fail(f"generation {gen}: served tokens (rid, seq) "
                     f"{[(chunk[b], q) for b, q in bad]} fall below the "
                     f"float32 forward's max by more than {tol[:, 0].tolist()}")
            del l32, lbf
        del params, p32
    torch.cuda.empty_cache()
    return out


def traffic_plane(cfg, ws, app) -> dict:
    """Phase 6: a load-only stable-shm fleet, then Drive A (steady Poisson
    load into two workers across a v3 flip) and Drive B (a worker SIGKILLed
    mid-stream under supervision)."""
    import torch

    from repro_torch import models
    from repro_torch.ckpt import bundle_from_params
    from repro_torch.serve import ServeEngine, run_traffic
    from repro_torch.serve.traffic import draw_prompts

    torch.cuda.empty_cache()
    cores = len(os.sched_getaffinity(0))
    log(f"traffic plane: {cores} usable host cores")
    out = {"cores": cores}

    # ---- fleet load: one shm segment, filled at most once, same bytes
    want_v2, arena_bytes = host_digest(ws, app)
    out["shm_free_fleet"] = shm_free_check(arena_bytes, "the fleet's arena")
    fleet = ServeEngine.spawn_fleet(ws, app, processes=2, strategy="stable-shm",
                                    timeout=300)
    fs = fleet.summary()
    digests = {w.get("tensors_digest") for w in fleet.workers}
    log(f"fleet load: {json.dumps(fs)}; load_s "
        f"{[w.get('load_s') for w in fleet.workers]}")
    if fleet.failed or len(fleet.workers) != 2 or fleet.fills > 1:
        fail(f"fleet load: {fs}")
    if digests != {want_v2}:
        fail(f"fleet digests {digests} != host image's {want_v2}")
    out["fleet"] = {**fs, "load_s": [w.get("load_s") for w in fleet.workers],
                    "digest": want_v2}

    # ---- Drive A: steady load across a flip to v3 (prebuilt: the
    # rollover_fn runs only the management transaction)
    gen_v2 = ws.epoch_gen
    params = models.init_params(cfg, 2, "cuda")
    v3 = bundle_from_params(f"weights:{cfg.name}", "v3", params,
                            specs=models.param_specs(cfg))
    del params
    torch.cuda.empty_cache()
    commit = {}

    def rollover_fn():
        t = time.perf_counter()
        with ws.management() as tx:
            tx.publish(*v3)
        commit["s"] = time.perf_counter() - t
        log(f"drive A: v3 committed in {commit['s']:.3f} s")

    sampler = MemorySampler().start()
    rep = run_traffic(
        ws, app, arch=ARCH, workers=2, n_requests=TRAFFIC_REQUESTS,
        rate_hz=TRAFFIC_RATE_HZ, seed=0, prompt_len=PROMPT, max_new_tokens=NEW,
        max_batch=SERVE_SLOTS, strategy="stable", stream=True,
        warmup_per_worker=1, timeout=300, rollover_at=TRAFFIC_ROLL_AT,
        rollover_fn=rollover_fn, device="cuda", smoke=False)
    peak_mib = sampler.stop()
    a = drive_summary(rep)
    log(f"drive A: {json.dumps(a)}")
    if rep.sent != TRAFFIC_REQUESTS or rep.completed != TRAFFIC_REQUESTS or rep.failed:
        fail(f"drive A: sent {rep.sent}, completed {rep.completed}, "
             f"errors {rep.worker_errors}")
    want_v3, _ = host_digest(ws, app)
    adopted = {(x["epoch_gen"], x["digest"]) for x in rep.adoptions}
    if len(rep.adoptions) != 2 or adopted != {(ws.epoch_gen, want_v3)}:
        fail(f"drive A: adoptions {rep.adoptions}, want gen {ws.epoch_gen} "
             f"digest {want_v3}")
    if rep.partial_frames != TRAFFIC_REQUESTS * NEW:
        fail(f"drive A: {rep.partial_frames} partial frames")
    check_streams(rep, TRAFFIC_REQUESTS, cfg.vocab_size, "A", dups_allowed=False)
    if len(rep.worker_stats) != 2:
        fail(f"drive A: {len(rep.worker_stats)} worker statistics files")
    prompts, _ = draw_prompts(cfg.vocab_size, TRAFFIC_REQUESTS, PROMPT,
                              TRAFFIC_RATE_HZ, 0)
    t = time.perf_counter()
    tokens_check = served_tokens_check(
        cfg, rep, prompts, {gen_v2: (1, want_v2), ws.epoch_gen: (2, want_v3)})
    log(f"drive A: all {tokens_check['positions']} served tokens within tolerance "
        f"of an independent float32 forward on the generation that served them "
        f"({tokens_check['argmax_equal']} its argmax; rids by generation "
        f"{ {g: len(r) for g, r in tokens_check['rids_by_gen'].items()} }; largest "
        f"margin {tokens_check['max_margin']:.5f}, "
        f"{tokens_check['max_margin_over_tol']:.3f} of its tolerance; "
        f"{time.perf_counter() - t:.1f} s)")
    total = {"flash_attention": 0, "rmsnorm": 0, "rmsnorm_backward": 0,
             "paged_reloc_copy": 0, "flash_routes": {"wgmma": 0, "simt": 0}}
    per_worker = []
    for st in rep.worker_stats:
        got, want = worker_launches(st, flips=1)
        loop = st["serve_loop"]
        row = {"worker": st["worker"], "launches": got, "expected": want,
               "admitted": loop["admitted"], "steps": loop["steps"],
               "rollovers": loop["rollovers"], "ready_s": st["ready_s"],
               "flips": st["flips"], "serve_wall_s": loop["wall_s"],
               "serve_cpu_s": st["serve_cpu_s"],
               "max_memory_allocated_gb": st["max_memory_allocated"] / 1e9}
        per_worker.append(row)
        log(f"drive A worker {row['worker']}: admitted {row['admitted']}, steps "
            f"{row['steps']}, serve loop {row['serve_wall_s']:.3f} s wall and "
            f"{row['serve_cpu_s']:.3f} s CPU, flips {row['flips']}, ready "
            f"{row['ready_s']:.3f} s, "
            f"peak allocated {row['max_memory_allocated_gb']:.2f} GB; launches "
            f"{got}, expected {want}")
        if got != want or loop["rollovers"] != 1:
            fail(f"drive A worker {row['worker']}: launches {got} != {want} or "
                 f"rollovers {loop['rollovers']} != 1")
        for k in ("flash_attention", "rmsnorm", "rmsnorm_backward", "paged_reloc_copy"):
            total[k] += got[k]
        for r in total["flash_routes"]:
            total["flash_routes"][r] += got["flash_routes"][r]
    log(f"drive A: launches summed over workers {total}; peak device memory "
        f"{peak_mib} MiB (nvidia-smi, sampled each second)")
    log("drive A: " + json.dumps({k: a[k] for k in (
        "req_per_s", "tok_per_s", "p50_latency_s", "p99_latency_s",
        "steady_p99_latency_s", "rollover_p99_latency_s", "ttft_p50_s",
        "ttft_p99_s", "rollover_wall_s", "ready_s", "stalls", "ring_wait_p50_s",
        "ring_wait_max_s")}) +
        f", commit {commit['s']:.3f} s, {cores} cores")
    out["drive_a"] = {"report": a, "launches": total, "workers": per_worker,
                      "commit_s": commit["s"], "peak_memory_used_mib": peak_mib,
                      "digest_v3": want_v3, "tokens_check": tokens_check}
    del v3

    # ---- Drive B: worker 1 SIGKILLs itself mid-stream (its warmup takes
    # 31 steps, so step 40 falls inside its first measured request)
    gc = ws.gc(drain=True)
    log(f"gc(drain=True) before drive B: {len(gc.removed)} removed")
    out["shm_free_kill"] = shm_free_check(arena_bytes, "drive B's arena")
    rep = run_traffic(
        ws, app, arch=ARCH, workers=2, n_requests=KILL_REQUESTS,
        rate_hz=KILL_RATE_HZ, seed=0, prompt_len=KILL_PROMPT,
        max_new_tokens=NEW, max_batch=SERVE_SLOTS, strategy="stable-shm",
        stream=True, supervise=True, faults={"die_at_step": KILL_STEP, "worker": 1},
        timeout=300, device="cuda", smoke=False)
    b = drive_summary(rep)
    log(f"drive B: {json.dumps(b)}")
    if (rep.completed != KILL_REQUESTS or rep.restarts < 1
            or rep.rerouted_requests < 1 or rep.failed):
        fail(f"drive B: completed {rep.completed}, restarts {rep.restarts}, "
             f"rerouted {rep.rerouted_requests}, errors {rep.worker_errors}")
    check_streams(rep, KILL_REQUESTS, cfg.vocab_size, "B", dups_allowed=True)
    respawned = [w for w in rep.worker_stats if w["worker"] == 1]
    log(f"drive B: kill p99 {rep.kill_p99_s:.4f} s, restarts {rep.restarts}, "
        f"rerouted {rep.rerouted_requests}, ready_s {rep.ready_s} (the last is "
        f"the respawned worker's), statistics files "
        f"{[(w['worker'], w['serve_loop']['admitted']) for w in rep.worker_stats]}")
    out["drive_b"] = {"report": b, "respawned_ready_s": [w["ready_s"] for w in respawned],
                      "workers": [{"worker": w["worker"], "launches": w["launches"],
                                   "serve_loop": w["serve_loop"]}
                                  for w in rep.worker_stats]}
    return out


# ------------------------------------------------------------ phases 7-8
def moe_layer_check(args, kw, out) -> dict:
    """One MoE layer of a bf16 run held against an independent computation
    on the same inputs ``args = (x, router_w, w_gate, w_up, w_down)``.

    Routing: the port's ``moe.route`` against the host's, made from the
    same router probabilities with numpy: a stable descending argsort (the
    lower expert first among equal values), each slot's place counted slot
    by slot, token-major, per batch row, and kept below ``capacity`` from
    that row's length. Output: ``out`` (the layer's ``moe_block`` result)
    against a float32 FFN per expert over the tokens the host keeps,
    combined with renormalised probabilities; the error is within
    ``out_tol`` = MOE_OUT_TOL x the largest value of that FFN."""
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe

    x, router_w, w_gate, w_up, w_down = args
    k, cf = kw["k"], kw["capacity_factor"]
    r = moe.route(x, router_w, k=k, capacity_factor=cf)
    probs = r.probs.float().cpu().numpy()
    B, S, E = probs.shape
    order = np.argsort(-probs, axis=-1, kind="stable")
    top_e = order[..., :k]
    ranked = np.take_along_axis(probs, order[..., :k + 1], -1)
    cap = min(max(1, math.ceil(k * S / E * cf)), S * k)
    flat = top_e.reshape(B, S * k)
    pos = np.empty_like(flat)
    for b in range(B):
        seen = np.zeros(E, np.int64)
        for i, e in enumerate(flat[b]):
            pos[b, i] = seen[e]
            seen[e] += 1
    keep = pos < cap
    got_e = r.top_e.cpu().numpy()
    res = {
        "tokens": B * S,
        "tied_tokens": int((np.diff(ranked, axis=-1) == 0).any(-1).sum()),
        "dropped_slots": int((~keep).sum()),
        "capacity": cap,
        "routing_mismatches": int((got_e != top_e).any(-1).sum()) + (r.capacity != cap),
        "pos_mismatches": int((r.pos.cpu().numpy() != pos).sum()),
        "keep_mismatches": int((r.keep.cpu().numpy() != keep).sum()),
    }
    top_p = np.take_along_axis(probs, top_e, -1)
    top_p = (top_p / np.maximum(top_p.sum(-1, keepdims=True), 1e-9)).reshape(B, S * k)
    xf = x.float()
    ref = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        b_idx, slot = np.nonzero((flat == e) & keep)
        if not b_idx.size:
            continue
        bi = torch.as_tensor(b_idx, device=x.device)
        si = torch.as_tensor(slot // k, device=x.device)
        xs = xf[bi, si]
        h = F.silu(xs @ w_gate[e].float()) * (xs @ w_up[e].float())
        y = h @ w_down[e].float()
        w = torch.as_tensor(top_p[b_idx, slot], dtype=torch.float32, device=x.device)
        ref.index_put_((bi, si), y * w[:, None], accumulate=True)
    res["out_err"] = (out.float() - ref).abs().max().item()
    res["out_tol"] = MOE_OUT_TOL * ref.abs().max().item()
    return res


class MoeSpy:
    """Within ``with MoeSpy() as spy``, every ``moe.moe_block`` call of the
    models is recorded in ``spy.calls`` as (args, kwargs, output)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._orig = [], moe, moe.moe_block

        def spy(*args, **kw):
            out = self._orig(*args, **kw)
            self.calls.append((args, kw, out[0]))
            return out

        moe.moe_block = spy
        return self

    def __exit__(self, *exc):
        self._moe.moe_block = self._orig


def routing_changes(a: list, b: list) -> dict:
    """Tokens whose top-k expert set (and whose order) differs between two
    runs' MoE calls, layer by layer, over every layer."""
    from repro_torch.models import moe

    sets = order = total = 0
    for (args_a, kw, _), (args_b, _, _) in zip(a, b):
        ea = moe.route(*args_a[:2], **kw).top_e
        eb = moe.route(*args_b[:2], **kw).top_e
        order += int((ea != eb).any(-1).sum())
        sets += int((ea.sort(-1).values != eb.sort(-1).values).any(-1).sum())
        total += ea.shape[0] * ea.shape[1]
    return {"token_layers": total, "set_changed": sets, "order_changed": order}


def tokens_check(cfg, params, prompts: list, streams: list, frames=None) -> dict:
    """Greedy streams held against an independent computation: each prompt
    prefilled with plain attention, no slots, then decoded step by step fed
    its served stream (teacher forcing), in float32 and in bf16; requests
    whose prompts have one length run as one batch. An encoder-decoder's
    frames are ``frames[i]``, by default stubbed for the prompt alone, as a
    slot admission stubs them. (A forward of prompt + stream is no
    reference for an MoE model: capacity, and so which tokens drop,
    depends on the sequence's length.) A served token must be the float32
    argmax or fall below its max by at most 3x the bf16 run's largest logit
    error for that request."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.serve.scheduler import stub_frames

    cfg32 = cfg.replace(dtype="float32")
    p32 = {n: t.float() for n, t in params.items()}
    out = {"streams": len(streams), "positions": 0, "argmax_equal": 0,
           "max_margin_over_tol": 0.0, "tol": []}

    def teacher_forced(c, p, batch, fed):
        logits, cache = models.prefill(c, p, batch, impl="naive",
                                       cache_len=batch["tokens"].shape[1] + fed.shape[1])
        rows = [logits[:, -1]]
        for j in range(fed.shape[1] - 1):
            logits, cache = models.decode_step(c, p, cache, fed[:, j:j + 1])
            rows.append(logits[:, -1])
        return torch.stack(rows, 1).float()              # (B, new, V)

    groups: dict = {}
    for i, prompt in enumerate(prompts):
        groups.setdefault(len(prompt), []).append(i)
    for plen, idx in sorted(groups.items()):
        batch = {"tokens": torch.as_tensor(np.stack([prompts[i] for i in idx]),
                                           device="cuda")}
        if cfg.is_encdec:
            batch["frames"] = torch.cat(
                [stub_frames(cfg, 1, plen, "cuda") if frames is None else frames[i]
                 for i in idx])
        fed = torch.as_tensor(np.stack([streams[i] for i in idx]), device="cuda")
        with torch.inference_mode():
            l32 = teacher_forced(cfg32, p32, batch, fed.to(torch.int32))
            lbf = teacher_forced(cfg, params, batch, fed.to(torch.int32))
        tol = 3 * (lbf - l32).abs().amax(dim=(1, 2))         # per request
        margin = l32.amax(-1) - l32.gather(-1, fed.long()[..., None])[..., 0]
        out["positions"] += margin.numel()
        out["argmax_equal"] += int((l32.argmax(-1) == fed).sum())
        ratio = (margin / torch.clamp(tol, min=1e-30)[:, None]).max().item()
        out["max_margin_over_tol"] = max(out["max_margin_over_tol"], ratio)
        out["tol"] += tol.tolist()
        if bool((margin > tol[:, None]).any()):
            fail(f"{cfg.name}: served tokens of prompts of {plen} fall below the "
                 f"float32 run's max beyond 3x the bf16 error {tol.tolist()}")
        del l32, lbf
    del p32
    torch.cuda.empty_cache()
    return out


def mixed_requests(cfg) -> list:
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    lens = rng.choice(SERVE_LENS, MIX_REQUESTS)
    if len(set(lens)) < 2:
        fail(f"the mixed requests drew one prompt length: {lens}")
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(n),),
                                               dtype=np.int32),
                    max_new_tokens=NEW) for i, n in enumerate(lens)]


def serve_mixed(cfg, engine, per_admission: dict, per_step: dict) -> dict:
    """``serve_loop(max_batch=4)`` over MIX_REQUESTS greedy requests of
    mixed prompt lengths: all complete, launch counts exact, every stream
    within tolerance of a float32 run (``tokens_check``)."""
    import torch

    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.serve import STOP

    reqs = mixed_requests(cfg)
    feed = iter(reqs + [STOP])
    done = {}
    zero_launch_counts()
    t0 = time.perf_counter()
    rep = engine.serve_loop(lambda: next(feed, STOP), lambda c: done.setdefault(c.rid, c),
                            max_batch=SERVE_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {**launch_counts(), "non_causal": fa.launches_non_causal}
    want = {k: per_admission.get(k, 0) * rep.admitted + per_step.get(k, 0) * rep.steps
            for k in ("flash_attention", "rmsnorm", "rmsnorm_backward",
                      "paged_reloc_copy", "non_causal")}
    want["flash_routes"] = {"wgmma": want["flash_attention"], "simt": 0}
    s = rep.summary()
    log(f"{cfg.name} serve_loop: {json.dumps(s)}; launches {got}, expected {want}")
    if got != want:
        fail(f"{cfg.name} serve_loop launches {got} != {want}")
    if rep.completed != MIX_REQUESTS or set(done) != set(range(MIX_REQUESTS)):
        fail(f"{cfg.name} serve_loop completed {rep.completed} of {MIX_REQUESTS}")
    check = tokens_check(cfg, engine.params, [r.prompt for r in reqs],
                         [done[r.rid].tokens for r in reqs])
    log(f"{cfg.name} serve_loop: all {check['positions']} served tokens within "
        f"tolerance of a float32 run ({check['argmax_equal']} its argmax, "
        f"{check['max_margin_over_tol']:.3f} of the tolerance at most)")
    return {"report": s, "launches": got, "prompt_lens": [len(r.prompt) for r in reqs],
            "wall_s": wall, "req_per_s": rep.completed / wall,
            "tok_per_s": rep.tokens_out / wall, "tokens_check": check}


def fresh_workspace(cfg) -> tuple:
    """A new Workspace root holding ``cfg``'s app (seed 0, made on the
    card), the app loaded on the host, and the set-up times."""
    root = tempfile.mkdtemp(prefix="chip-smoke-ws-")
    free = shutil.disk_usage(root).free
    log(f"{cfg.name}: {free / 1e9:.1f} GB free on the workspace's disk")
    return (root,) + publish(cfg, root)


def moe_path() -> dict:
    """Phase 7: olmoe-1b-7b at its published widths."""
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    root, ws, app, host, setup = fresh_workspace(cfg)
    try:
        per_prefill = {"flash_attention": MOE_FLASH, "rmsnorm": MOE_RMS}
        want = {"flash_attention": MOE_FLASH, "rmsnorm": MOE_RMS * NEW,
                "rmsnorm_backward": 0, "paged_reloc_copy": 1, "non_causal": 0,
                "flash_routes": {"wgmma": MOE_FLASH, "simt": 0}}
        run, out = static_batch(cfg, ws, host, want)
        del host
        out.update(setup=setup, n_params=models.n_params(cfg),
                   n_active_params=models.n_active_params(cfg))
        engine = run.engine
        tokens = torch.as_tensor(run.prompts, device="cuda")
        runs = {}
        with torch.inference_mode():
            for name, c, params, impl in (
                    ("kernel", cfg, engine.params, "kernel"),
                    ("bf16 plain", cfg, engine.params, "naive"),
                    ("f32 plain", cfg.replace(dtype="float32"), None, "naive")):
                if params is None:
                    params = {n: t.float() for n, t in engine.params.items()}
                with MoeSpy() as spy:
                    logits, _ = models.forward(c, params, {"tokens": tokens}, impl=impl)
                runs[name] = (logits.float(), spy.calls)
                del params, logits
        layers = [moe_layer_check(a, kw, o) for a, kw, o in runs["kernel"][1]]
        if len(layers) != cfg.num_layers:
            fail(f"{cfg.name}: {len(layers)} MoE layers ran, not {cfg.num_layers}")
        totals = {k: sum(r[k] for r in layers) for k in (
            "tokens", "tied_tokens", "dropped_slots", "routing_mismatches",
            "pos_mismatches", "keep_mismatches")}
        worst = max(r["out_err"] / r["out_tol"] for r in layers)
        log(f"{cfg.name}: MoE layers against the host routing and a float32 FFN per "
            f"expert: {json.dumps(totals)}; largest output error "
            f"{worst:.3f} of its tolerance")
        if (totals["routing_mismatches"] or totals["pos_mismatches"]
                or totals["keep_mismatches"] or worst > 1.0):
            fail(f"{cfg.name}: MoE layer check failed: {totals}, worst {worst}")
        ref = runs["f32 plain"][0]
        kern, plain = runs["kernel"][0], runs["bf16 plain"][0]
        if not bool(torch.isfinite(kern).all()):
            fail(f"{cfg.name}: forward logits are not finite")
        logit = {"mean_err_kernel": (kern - ref).abs().mean().item(),
                 "mean_err_bf16_plain": (plain - ref).abs().mean().item(),
                 "max_err_kernel": (kern - ref).abs().max().item(),
                 "max_err_bf16_plain": (plain - ref).abs().max().item(),
                 "max_err_kernel_vs_plain": (kern - plain).abs().max().item(),
                 "last_max_err_kernel": (kern[:, -1] - ref[:, -1]).abs().max().item(),
                 "last_max_err_bf16_plain": (plain[:, -1] - ref[:, -1]).abs().max().item(),
                 "routed_differently_kernel_vs_plain": routing_changes(
                     runs["kernel"][1], runs["bf16 plain"][1]),
                 "routed_differently_bf16_vs_f32": routing_changes(
                     runs["kernel"][1], runs["f32 plain"][1])}
        log(f"{cfg.name} forward logits over all {BATCH} x {PROMPT} positions: "
            f"{json.dumps(logit)}")
        if not logit["mean_err_kernel"] <= MOE_LOGIT_RATIO * logit["mean_err_bf16_plain"]:
            fail(f"{cfg.name}: kernel path's mean logit error {logit['mean_err_kernel']} "
                 f"> {MOE_LOGIT_RATIO} x the bf16 plain run's "
                 f"{logit['mean_err_bf16_plain']}")
        del runs, kern, plain, ref
        torch.cuda.empty_cache()
        out["static_tokens_check"] = tokens_check(
            cfg, engine.params, list(run.prompts), list(run.tokens))
        log(f"{cfg.name} static batch: all {out['static_tokens_check']['positions']} "
            "tokens within tolerance of a float32 run")
        out.update(moe_layers=totals, moe_worst_out_err_over_tol=worst,
                   moe_layer_rows=layers, logits=logit)
        out["serve_loop"] = serve_mixed(cfg, engine, per_prefill,
                                        {"rmsnorm": MOE_RMS})
        del run, engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def encdec_path() -> dict:
    """Phase 8: seamless-m4t-large-v2 at its published widths."""
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.serve.scheduler import stub_frames

    cfg = get_config(ENCDEC_ARCH)
    root, ws, app, host, setup = fresh_workspace(cfg)
    try:
        per_prefill = {"flash_attention": ENCDEC_FLASH, "non_causal": ENCDEC_CROSS}
        want = {"flash_attention": ENCDEC_FLASH, "rmsnorm": 0, "rmsnorm_backward": 0,
                "paged_reloc_copy": 1, "non_causal": ENCDEC_CROSS,
                "flash_routes": {"wgmma": ENCDEC_FLASH, "simt": 0}}
        run, out = static_batch(cfg, ws, host, want)
        del host
        out.update(setup=setup, n_params=models.n_params(cfg))
        engine = run.engine
        batch = {"tokens": torch.as_tensor(run.prompts, device="cuda"),
                 "frames": stub_frames(cfg, BATCH, PROMPT, "cuda")}
        out.update(prefill_logits_check(cfg, engine.params, batch))
        frames = batch["frames"]
        out["static_tokens_check"] = tokens_check(
            cfg, engine.params, list(run.prompts), list(run.tokens),
            frames=[frames[b:b + 1] for b in range(BATCH)])
        log(f"{cfg.name} static batch: all {out['static_tokens_check']['positions']} "
            "tokens within tolerance of a float32 run")
        del batch, frames
        out["serve_loop"] = serve_mixed(cfg, engine, per_prefill, {})
        del run, engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def ssm_path(arch: str, flash: int, rms: int) -> dict:
    """Phases 9 and 10: mamba2-370m (``flash`` 0) and zamba2-7b (``flash``
    14, all at hd 224 on the wgmma route) at their published widths, in a
    fresh Workspace: the static batch with exact launches and byte-equal
    slots, prefill logits against a float32 run, every token against a
    teacher-forced float32 run, then the mixed-length ``serve_loop``."""
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    root, ws, app, host, setup = fresh_workspace(cfg)
    try:
        per_prefill = {"flash_attention": flash, "rmsnorm": rms}
        want = {"flash_attention": flash, "rmsnorm": rms * NEW, "rmsnorm_backward": 0,
                "paged_reloc_copy": 1, "non_causal": 0,
                "flash_routes": {"wgmma": flash, "simt": 0}}
        run, out = static_batch(cfg, ws, host, want)
        del host
        out.update(setup=setup, n_params=models.n_params(cfg))
        engine = run.engine
        out.update(prefill_logits_check(
            cfg, engine.params, {"tokens": torch.as_tensor(run.prompts, device="cuda")}))
        out["static_tokens_check"] = tokens_check(
            cfg, engine.params, list(run.prompts), list(run.tokens))
        log(f"{cfg.name} static batch: all {out['static_tokens_check']['positions']} "
            f"tokens within tolerance of a float32 run "
            f"({out['static_tokens_check']['argmax_equal']} its argmax)")
        out["serve_loop"] = serve_mixed(cfg, engine, per_prefill, {"rmsnorm": rms})
        del run, engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 11
def train_rms_launches(cfg) -> dict:
    """rmsnorm launches of one training step (one microbatch) of a decoder
    transformer with RMSNorm: each norm (attn and mlp, q and k with
    qk_norm, a layer; the final norm) once forward and once backward, and
    every norm inside a layer body (the remat unit) once more in the
    recompute, unless the policy is "none"."""
    inside = cfg.num_layers * (2 + 2 * bool(cfg.qk_norm))
    recompute = 0 if cfg.remat_policy == "none" else inside
    return {"forward": inside + 1 + recompute, "backward": inside + 1}


def attention_pairs(seq: int, window: int) -> int:
    """Visible (q, k) pairs of one causal sequence, a window of ``window``
    keys (0: all earlier keys)."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model flops of one training step of a decoder-only transformer: 6 x
    parameters x tokens (forward and backward of every weight product; the
    tied embedding counted once, as the output layer), plus attention's
    4 x hd flops per visible (q, k) pair and head, x 3 for forward and
    backward. The remat recompute is not counted."""
    from repro_torch import models
    from repro_torch.models import transformer

    flops = 6.0 * models.n_params(cfg) * batch * seq
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    for w in transformer._layer_windows(cfg):
        flops += 3 * 4.0 * hd * H * batch * attention_pairs(seq, w)
    return flops


@contextlib.contextmanager
def plain_norms():
    """Every model's ``rms_norm`` runs the plain version (autograd through
    plain torch) inside the block."""
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.models import hybrid, mamba2, transformer

    saved = [(m, m.rms_norm) for m in (transformer, mamba2, hybrid)]
    for m, _ in saved:
        m.rms_norm = lambda x, scale, eps=1e-6: rmsnorm_plain(x, scale, eps=eps)
    try:
        yield
    finally:
        for m, fn in saved:
            m.rms_norm = fn


def train_grad_check(cfg, params, batch) -> dict:
    """Step 0's loss and every parameter's gradient on the kernel path
    (rmsnorm forward and backward kernels), against a float32 plain-norm
    run on the card: the kernel path's error (the loss's absolute error;
    each gradient's L2 error over the float32 gradient's L2 norm) at most
    GRAD_RATIO x the bf16 plain-norm run's. A gradient cut at a norm would
    be far off, and a norm scale would get none. The kernel path runs
    twice: the gradients that differ between the two runs are reported
    (ops of the step that are not deterministic)."""
    import torch

    from repro_torch import models

    def run(c, p, plain: bool):
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        with plain_norms() if plain else contextlib.nullcontext():
            loss = models.loss_fn(c, leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach().item(), dict(zip(leaves, grads))

    t0 = time.perf_counter()
    p32 = {n: t.float() for n, t in params.items()}
    l32, g32 = run(cfg.replace(dtype="float32"), p32, True)
    del p32
    out = {"loss_f32": l32, "grads": {}}
    kernel_grads = None
    for name, plain in (("kernel", False), ("bf16 plain", True)):
        loss, grads = run(cfg, params, plain)
        out[f"loss_{name}"] = loss
        out[f"loss_err_{name}"] = abs(loss - l32)
        for n, g in grads.items():
            diff = g.float() - g32[n]
            out["grads"].setdefault(n, {})[name] = {
                "rel_l2": (diff.norm() / g32[n].norm()).item(),
                "max_abs": diff.abs().max().item()}
        if name == "kernel":
            kernel_grads = grads
        del grads
    del g32
    _, again = run(cfg, params, False)
    out["nondeterministic_grads"] = sorted(
        n for n, g in again.items() if not torch.equal(g, kernel_grads[n]))
    del again, kernel_grads
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    def ratio(r):      # an exact bf16 plain gradient asks the kernel path's to be exact
        k, p = r["kernel"]["rel_l2"], r["bf16 plain"]["rel_l2"]
        return k / p if p else (0.0 if not k else float("inf"))

    worst = max(ratio(r) for r in out["grads"].values())
    out["worst_grad_ratio"] = worst
    log(f"{cfg.name} step-0 gradients vs a float32 plain-norm run: loss error kernel "
        f"{out['loss_err_kernel']:.3e}, bf16 plain {out['loss_err_bf16 plain']:.3e}; "
        f"largest gradient error ratio (kernel / bf16 plain, L2) {worst:.4f} over "
        f"{len(out['grads'])} parameters; gradients that differ between two kernel-path "
        f"runs: {out['nondeterministic_grads']}")
    for n, r in sorted(out["grads"].items()):
        log(f"  {n}: L2 error kernel {r['kernel']['rel_l2']:.3e}, bf16 plain "
            f"{r['bf16 plain']['rel_l2']:.3e}")
    if not out["loss_err_kernel"] <= GRAD_RATIO * out["loss_err_bf16 plain"]:
        fail(f"{cfg.name}: kernel path's loss error {out['loss_err_kernel']} > "
             f"{GRAD_RATIO} x the bf16 plain run's {out['loss_err_bf16 plain']}")
    if not worst <= GRAD_RATIO:
        fail(f"{cfg.name}: a gradient's error on the kernel path is {worst} x the bf16 "
             f"plain run's (limit {GRAD_RATIO})")
    return out


def train_path() -> dict:
    """Phase 11: gemma3-1b trained at its published widths through the
    port's Trainer: publish, an epoch-path start (opt/* INIT), steps, the
    step-3 checkpoint, a failure at step 4, a restart on the table-driven
    path from opt/step, the rest of the steps; then the checks and the
    profile of one more step."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import RelocType
    from repro_torch.data import make_batch, to_device
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer

    class CheckedTrainer(Trainer):
        """At each start: the opt/* symbols' relocation types, and at a
        restart a host copy of the arena as loaded (outside ``total_s``)."""

        def _startup(self):
            out = super()._startup()
            t = time.perf_counter()
            table = self.image.table
            types = sorted({int(r["type"]) for r in table.rows
                            if table.name_at(r["symbol_name"]).startswith("opt/")})
            arena = self.image.arena.to("cpu", copy=True) if self.starts else None
            self.starts.append({"opt_types": types, "arena": arena,
                                "check_s": time.perf_counter() - t})
            return out

    cfg = get_config(ARCH)
    shape = ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
                       fail_at_step=TRAIN_FAIL_AT, opt=OptConfig(**TRAIN_OPT))
    root = tempfile.mkdtemp(prefix="chip-smoke-train-")
    log(f"{cfg.name} training: {shutil.disk_usage(root).free / 1e9:.1f} GB free on "
        "the workspace's disk")
    try:
        tr = CheckedTrainer(root, cfg, shape, tcfg, device="cuda")
        tr.starts = []
        tr.ckpt.keep_last = True
        t0 = time.perf_counter()
        params = models.init_params(cfg, tcfg.seed, "cuda")
        tr.publish(params)
        publish_s = time.perf_counter() - t0
        log(f"{cfg.name} training: published {tr.app_name} in {publish_s:.1f} s")
        batch0 = to_device(make_batch(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ, step=0, seed=tcfg.seed), "cuda")
        grads = train_grad_check(cfg, params, batch0)
        del params, batch0
        torch.cuda.empty_cache()

        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = {**launch_counts(), "non_causal": fa.launches_non_causal}
        per_step, steps_run = train_rms_launches(cfg), len(res.losses)
        want = {"flash_attention": 0, "rmsnorm": per_step["forward"] * steps_run,
                "rmsnorm_backward": per_step["backward"] * steps_run,
                "paged_reloc_copy": 2, "non_causal": 0,
                "flash_routes": {"wgmma": 0, "simt": 0}}
        log(f"{cfg.name} training ran in {wall:.1f} s: losses {res.losses}, restarts "
            f"{res.restarts}, starts {res.startup_stats}")
        log(f"{cfg.name} training launches {got}, expected {want} (rmsnorm {per_step} a "
            f"step, remat policy {cfg.remat_policy!r}, x {steps_run} steps run)")
        if got != want:
            fail(f"{cfg.name} training: kernel launches {got} != {want}")
        if not all(np.isfinite(res.losses)):
            fail(f"{cfg.name} training: a loss is not finite: {res.losses}")
        resumed = [st["resume_step"] for st in res.startup_stats]
        if (res.restarts, res.steps_done, resumed) != (1, TRAIN_STEPS, [0, TRAIN_CKPT_EVERY]):
            fail(f"{cfg.name} training: restarts {res.restarts}, steps {res.steps_done}, "
                 f"resume steps {resumed}")
        opt_types = [st["opt_types"] for st in tr.starts]
        if opt_types != [[int(RelocType.INIT)], [int(RelocType.DIRECT)]]:
            fail(f"{cfg.name} training: opt/* relocation types by start {opt_types}, "
                 "not INIT then DIRECT")
        # step 3 ran before the failure and again after the restart
        before, after = res.losses[TRAIN_CKPT_EVERY], res.losses[TRAIN_CKPT_EVERY + 1]
        if before != after:
            fail(f"{cfg.name} training: step-3 loss {before!r} before the failure, "
                 f"{after!r} after the restart")
        log(f"{cfg.name} training: restarted once from opt/step = {resumed[1]}; opt/* "
            f"INIT at the first start, DIRECT after the checkpoint; step-3 loss "
            f"{before!r} before and after the restart")

        t1 = time.perf_counter()
        host = tr.ws.load(tr.app_name, strategy="stable")
        host_load_s = time.perf_counter() - t1
        snap = {**tr.ckpt.last_snapshot[0], **tr.ckpt.last_snapshot[1]}
        if set(snap) != set(host.tensors):
            fail(f"{cfg.name} training: snapshot names differ from the host image's")
        host_bytes = {n: torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
                      for n, a in host.tensors.items()}
        for n, t in snap.items():
            if not torch.equal(t.contiguous().reshape(-1).view(torch.uint8), host_bytes[n]):
                fail(f"{cfg.name} training: checkpoint symbol {n!r} differs from the "
                     "trainer's snapshot")
        arena = tr.starts[1]["arena"]
        for n, slot in tr.image.table.slots().items():
            if not torch.equal(arena[slot.offset:slot.offset + slot.nbytes], host_bytes[n]):
                fail(f"{cfg.name} training: restart arena slot {n!r} differs from the "
                     "host image")
        log(f"{cfg.name} training: the step-3 checkpoint's {len(snap)} symbols, loaded "
            f"back on the host ({host_load_s:.1f} s), equal the trainer's snapshot, and "
            "every slot of the restart's arena equals the host image")
        del host, host_bytes, snap, arena
        tr.starts[1]["arena"] = None
        tr.ckpt.last_snapshot = None

        step_fn = make_train_fn(cfg, tcfg.opt, impl=tcfg.impl)
        batch = to_device(make_batch(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, step=TRAIN_STEPS, seed=tcfg.seed),
                          "cuda")
        profile = profiled(
            lambda: {"loss": float(step_fn(tr.params, tr.opt_state, batch)[2]["loss"])},
            f"{cfg.name} train step")

        # steady: every step but the process's first and step 3 of the first
        # start, which ran while the step-3 checkpoint published
        overlapped = res.step_s[TRAIN_CKPT_EVERY]
        step_s = statistics.median(s for i, s in enumerate(res.step_s)
                                   if i not in (0, TRAIN_CKPT_EVERY))
        flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
        restart = res.startup_stats[1]
        out = {
            "launches": got, "launches_per_step": per_step, "steps_run": steps_run,
            "losses": res.losses, "step_s": res.step_s, "steady_step_s": step_s,
            "step_during_checkpoint_publish_s": overlapped,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "model_flops_per_step": flops,
            "model_tflop_s": flops / step_s / 1e12,
            "bf16_peak_share": flops / step_s / BF16_FLOPS,
            "publish_s": publish_s, "starts": res.startup_stats,
            "checkpoint_save_s": tr.ckpt.save_seconds,
            "checkpoint_snapshot_s": tr.ckpt.snapshot_seconds,
            "restart_to_first_step_s": (restart["ckpt_wait_s"] + restart["total_s"]
                                        + res.step_s[TRAIN_CKPT_EVERY + 1]),
            "peak_allocated_gb": peak / 1e9, "wall_s": wall,
            "host_load_s": host_load_s, "grad_check": grads, "profile": profile,
            "n_params": models.n_params(cfg),
        }
        log(f"{cfg.name} training: " + json.dumps({k: out[k] for k in (
            "steady_step_s", "step_during_checkpoint_publish_s", "tokens_per_s",
            "model_tflop_s", "bf16_peak_share",
            "publish_s", "checkpoint_save_s", "checkpoint_snapshot_s",
            "restart_to_first_step_s", "peak_allocated_gb")}))
        if peak > 70e9:
            log(f"{cfg.name} training: peak allocation {peak / 1e9:.1f} GB is above 70 GB")
        del tr, step_fn, batch
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 12
def _timed_cuda(fn):
    """(fn's result, its wall seconds up to a synchronised card)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def mesh_serve(cfg, mesh, params) -> dict:
    """Phase 12's serving half: ``build_step``'s prefill (impl="kernel")
    and MESH_DECODE decode steps on ``mesh``, against the meshless
    ``models.prefill`` and ``decode_step`` on the same arena params: the
    same logits bits, the same tokens, exact launch counts; each timed."""
    import torch

    from repro_torch import models
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.steps import build_step, place_tree

    g = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                           device="cuda", dtype=torch.int32)
    bundle = build_step(cfg, ShapeConfig("chip-p", PROMPT, BATCH, "prefill"), mesh,
                        impl="kernel")
    prefill = bundle.jitted
    decode = build_step(cfg, ShapeConfig("chip-d", PROMPT, BATCH, "decode"), mesh).jitted
    placed = place_tree(params, mesh, bundle.shardings["params"])   # once, no copy

    def mesh_run():
        logits, cache = prefill(placed, {"tokens": tokens})
        tok, toks, steps = torch.argmax(logits.to_local()[:, -1:], -1).to(torch.int32), [], []
        for _ in range(MESH_DECODE):
            (tok, cache), dt = _timed_cuda(lambda: decode(placed, cache, tok))
            steps.append(dt)
            toks.append(tok.to_local())
        return logits.to_local(), torch.cat(toks, 1), steps

    def plain_run():
        logits, cache = models.prefill(cfg, params, {"tokens": tokens}, impl="kernel")
        tok, toks, steps = torch.argmax(logits[:, -1:], -1).to(torch.int32), [], []
        for _ in range(MESH_DECODE):
            def step():
                lg, c = models.decode_step(cfg, params, cache, tok)
                return torch.argmax(lg[:, -1:], -1).to(torch.int32), c
            (tok, cache), dt = _timed_cuda(step)
            steps.append(dt)
            toks.append(tok)
        return logits, torch.cat(toks, 1), steps

    with torch.no_grad():
        zero_launch_counts()
        (m_logits, m_toks, m_steps), mesh_s = _timed_cuda(mesh_run)
        got = {**launch_counts(), "non_causal": fa.launches_non_causal}
        (p_logits, p_toks, p_steps), plain_s = _timed_cuda(plain_run)
        # prefill alone, timed again now that both paths ran once
        _, mesh_prefill_s = _timed_cuda(lambda: prefill(placed, {"tokens": tokens}))
        _, plain_prefill_s = _timed_cuda(
            lambda: models.prefill(cfg, params, {"tokens": tokens}, impl="kernel"))
    want = {"flash_attention": FLASH_PER_PREFILL,
            "rmsnorm": RMS_PER_STEP * (1 + MESH_DECODE), "rmsnorm_backward": 0,
            "paged_reloc_copy": 0, "non_causal": 0,
            "flash_routes": {"wgmma": FLASH_PER_PREFILL, "simt": 0}}
    log(f"{cfg.name} mesh serving: launches {got}, expected {want}")
    if got != want:
        fail(f"{cfg.name} mesh serving: kernel launches {got} != {want}")
    if not bool(torch.isfinite(m_logits).all()):
        fail(f"{cfg.name} mesh serving: prefill logits are not finite")
    if not torch.equal(m_logits, p_logits):
        fail(f"{cfg.name} mesh serving: prefill logits differ from the meshless run's "
             f"(max {(m_logits.float() - p_logits.float()).abs().max().item()})")
    if not torch.equal(m_toks, p_toks):
        fail(f"{cfg.name} mesh serving: decode tokens differ from the meshless run's")
    step_s, plain_step_s = statistics.median(m_steps), statistics.median(p_steps)
    out = {"launches": got, "decode_steps": MESH_DECODE, "prefill_s": mesh_prefill_s,
           "plain_prefill_s": plain_prefill_s, "decode_step_s": step_s,
           "plain_decode_step_s": plain_step_s,
           "prefill_overhead_s": mesh_prefill_s - plain_prefill_s,
           "decode_step_overhead_s": step_s - plain_step_s,
           "run_s": mesh_s, "plain_run_s": plain_s}
    log(f"{cfg.name} mesh serving: logits the same bits and {MESH_DECODE} x {BATCH} "
        "tokens equal to the meshless run's; " + json.dumps(
            {k: v for k, v in out.items() if k != "launches"}))
    return out


def mesh_train(cfg, mesh, root) -> dict:
    """Phase 12's training half: a meshless ``Trainer`` and one on ``mesh``
    over the same published world, MESH_TRAIN_STEPS steps each and no
    checkpoint: the same loss bits; the mesh run's launches exact and its
    params DTensors over views of its arena, trained in place."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer

    shape = ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(steps=MESH_TRAIN_STEPS, checkpoint_every=10**9,
                       opt=OptConfig(**TRAIN_OPT))
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        tr = Trainer(root, cfg, shape, tcfg, device="cuda", mesh=m)
        zero_launch_counts()
        res, wall = _timed_cuda(tr.run)
        got = {**launch_counts(), "non_causal": fa.launches_non_causal}
        runs[name] = {"losses": res.losses, "step_s": res.step_s, "wall_s": wall,
                      "launches": got, "start": res.startup_stats[0]}
        if m is not None:
            arena = tr.image.arena
            lo, hi = arena.data_ptr(), arena.data_ptr() + arena.numel()
            outside = [n for n, p in tr.params.items()
                       if not lo <= p.to_local().data_ptr() < hi]
            if outside:
                fail(f"{cfg.name} mesh training: params {outside[:3]} are not views of "
                     "the arena")
            slot = tr.image.table.slots()["final_norm/scale"]
            view = arena[slot.offset:slot.offset + slot.nbytes]
            local = tr.params["final_norm/scale"].to_local()
            if not torch.equal(view, local.detach().reshape(-1).view(torch.uint8)):
                fail(f"{cfg.name} mesh training: the arena does not hold the trained params")
        del tr
        torch.cuda.empty_cache()
    per_step = train_rms_launches(cfg)
    want = {"flash_attention": 0, "rmsnorm": per_step["forward"] * MESH_TRAIN_STEPS,
            "rmsnorm_backward": per_step["backward"] * MESH_TRAIN_STEPS,
            "paged_reloc_copy": 1, "non_causal": 0, "flash_routes": {"wgmma": 0, "simt": 0}}
    got = runs["mesh"]["launches"]
    log(f"{cfg.name} mesh training: losses {runs['mesh']['losses']} (meshless "
        f"{runs['meshless']['losses']}); launches {got}, expected {want}")
    if got != want:
        fail(f"{cfg.name} mesh training: kernel launches {got} != {want}")
    if runs["mesh"]["losses"] != runs["meshless"]["losses"]:
        fail(f"{cfg.name} mesh training: losses differ from the meshless trainer's")
    if not all(map(math.isfinite, runs["mesh"]["losses"])):
        fail(f"{cfg.name} mesh training: a loss is not finite")
    steady = {k: statistics.median(r["step_s"][1:]) for k, r in runs.items()}
    out = {"launches": got, "launches_per_step": per_step, "runs": runs,
           "step_s": steady["mesh"], "plain_step_s": steady["meshless"],
           "step_overhead_s": steady["mesh"] - steady["meshless"],
           "first_step_s": runs["mesh"]["step_s"][0],
           "plain_first_step_s": runs["meshless"]["step_s"][0]}
    log(f"{cfg.name} mesh training: the same loss bits as the meshless trainer; params "
        "are views of the arena, trained in place; " + json.dumps(
            {k: out[k] for k in ("step_s", "plain_step_s", "step_overhead_s",
                                 "first_step_s", "plain_first_step_s")}))
    return out


def mesh_int8() -> dict:
    """``int8_allreduce_mean`` over the one-rank NCCL group equals
    ``dequantize_int8(quantize_int8(x))`` on the card, bit for bit."""
    import torch

    from repro_torch.dist.compression import (dequantize_int8, int8_allreduce_mean,
                                              quantize_int8)

    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((1024, 1152), generator=g, device="cuda")
    got = int8_allreduce_mean(x)
    want = dequantize_int8(*quantize_int8(x))
    if not torch.equal(got, want):
        fail(f"int8_allreduce_mean differs from dequantize(quantize(x)) by "
             f"{(got - want).abs().max().item()}")
    log("int8_allreduce_mean over the one-rank NCCL group equals "
        "dequantize_int8(quantize_int8(x)) bit for bit")
    return {"shape": list(x.shape), "equal": True}


def mesh_path() -> dict:
    """Phase 12: gemma3-1b at its published widths through the multi-device
    layer on ``make_local_mesh()`` (a one-rank NCCL group) in a fresh
    Workspace: one publish; the serving check on the arena of a stable
    load; the meshless and the mesh ``Trainer``; the int8 all-reduce."""
    import torch
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import ensure_process_group, make_local_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(ARCH)
    ensure_process_group("local", "cuda")
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        mesh = make_local_mesh()
        tr = Trainer(root, cfg, ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                     TrainConfig(opt=OptConfig(**TRAIN_OPT)), device="cuda")
        t0 = time.perf_counter()
        tr.publish(models.init_params(cfg, 0, "cuda"))
        publish_s = time.perf_counter() - t0
        image = tr.ws.load(tr.app_name, strategy="stable", device="cuda")
        params = {n: image.tensors[n] for n in models.param_specs(cfg)}
        log(f"{cfg.name} mesh: published {tr.app_name} in {publish_s:.1f} s; mesh "
            f"{tuple(mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}")
        del tr
        serve = mesh_serve(cfg, mesh, params)
        del params, image
        torch.cuda.empty_cache()
        train = mesh_train(cfg, mesh, root)
        int8 = mesh_int8()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"publish_s": publish_s, "serve": serve, "train": train, "int8": int8,
            "launches": {k: serve["launches"][k] + train["launches"][k]
                         for k in ("flash_attention", "rmsnorm", "rmsnorm_backward",
                                   "paged_reloc_copy", "non_causal")}
            | {"flash_routes": serve["launches"]["flash_routes"]}}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run, e.g. 2,7 (development: "
                         "the build always runs, and the result lines are printed "
                         "only by a run of every phase)")
    args = ap.parse_args()
    only = {int(p) for p in args.phases.split(",") if p}
    if not (SRC / "repro_torch").is_dir():
        fail(f"no {SRC / 'repro_torch'}: run chip_smoke.py from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import shm_arena

    def phase(n: int) -> bool:
        return not only or n in only

    resolve_device("cuda")                   # TF32 off for f32 products
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    detail = {"card": card, "build": build_kernels(), "phase_s": {}}
    kernels = []

    def timed(n: int, key: str, fn, *args):
        t = time.perf_counter()
        detail[key] = fn(*args)
        detail["phase_s"][n] = detail["phase_s"].get(n, 0.0) + time.perf_counter() - t
        log(f"phase {n} ({key}): {time.perf_counter() - t:.1f} s")

    if any(phase(n) for n in range(2, 7)):
        root = tempfile.mkdtemp(prefix="chip-smoke-ws-")
        ws = None
        try:
            ws, app, host, detail["setup"] = publish(cfg, root)
            if phase(2):
                t = time.perf_counter()
                kernels = [check_flash(cfg),
                           check_rmsnorm(cfg, [get_config(a) for a in (
                               MOE_ARCH, SSM_ARCH, HYBRID_ARCH)]),
                           check_paged(host.table),
                           check_rmsnorm_backward()]
                kernels[0]["_new_paths"] = check_flash_paths()
                kernels[0]["_hd224_cases"] = check_flash_hd224()
                detail["phase_s"][2] = time.perf_counter() - t
            if phase(3):
                timed(3, "main_path", main_path, cfg, ws, host)
            del host
            if phase(4):
                for arch in (ARCH, MOE_ARCH, "qwen2-moe-a2.7b", ENCDEC_ARCH, SSM_ARCH,
                             HYBRID_ARCH):
                    timed(4, f"small_input {arch}", small_input, arch)
            if phase(5):
                timed(5, "serve_epoch", serve_epoch, cfg, ws, app)
            if phase(6):
                timed(6, "traffic", traffic_plane, cfg, ws, app)
        finally:
            if ws is not None:
                shm_arena.unlink_root_segments(ws.registry)
            shutil.rmtree(root, ignore_errors=True)
    if phase(7):
        timed(7, "moe", moe_path)
    if phase(8):
        timed(8, "encdec", encdec_path)
    if phase(9):
        timed(9, "ssm", ssm_path, SSM_ARCH, SSM_FLASH, SSM_RMS)
    if phase(10):
        timed(10, "hybrid", ssm_path, HYBRID_ARCH, HYBRID_FLASH, HYBRID_RMS)
    if phase(11):
        timed(11, "train", train_path)
    if phase(12):
        timed(12, "mesh", mesh_path)
    detail["empty_profiles"] = EMPTY_PROFILES
    detail["total_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if only:
        detail["kernels"] = kernels
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
        log(f"phases {sorted(only)} passed in {detail['total_s']:.1f} s (a partial run "
            "prints no result)")
        return
    paths = {"main_path": detail["main_path"]["launches"],
             "serve_epoch": detail["serve_epoch"]["launches"],
             "traffic": detail["traffic"]["drive_a"]["launches"],
             MOE_ARCH: detail["moe"]["launches"],
             f"{MOE_ARCH} serve_loop": detail["moe"]["serve_loop"]["launches"],
             ENCDEC_ARCH: detail["encdec"]["launches"],
             f"{ENCDEC_ARCH} serve_loop": detail["encdec"]["serve_loop"]["launches"],
             SSM_ARCH: detail["ssm"]["launches"],
             f"{SSM_ARCH} serve_loop": detail["ssm"]["serve_loop"]["launches"],
             HYBRID_ARCH: detail["hybrid"]["launches"],
             f"{HYBRID_ARCH} serve_loop": detail["hybrid"]["serve_loop"]["launches"],
             "train": detail["train"]["launches"],
             "mesh serve": detail["mesh"]["serve"]["launches"],
             "mesh train": detail["mesh"]["train"]["launches"]}
    kernels[0]["launches_by_route"] = {p: c["flash_routes"] for p, c in paths.items()}
    kernels[0]["non_causal_by_path"] = {p: c.get("non_causal", 0) for p, c in paths.items()}
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if not k["launches"]:
            fail(f"{k['name']} was not launched on the main path")
    detail["kernels"] = kernels
    log(f"device_ms: {len(EMPTY_PROFILES)} profiles recorded no device time "
        "and were taken again")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    # device_ms: the profiler's device time a launch, beside "ms" (CUDA
    # events over back-to-back calls, the host's rate where it is slower);
    # null for the page copy, whose event time is its device time
    keys = ("name", "route", "source", "replaces", "replaces_what", "launches",
            "launches_by_path",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"done in {detail['total_s']:.1f} s; phases {json.dumps(detail['phase_s'])}")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys
                                   if k in kern or k != "replaces_what"}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
