"""Serving launcher: batched greedy generation through the stable linker.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

The CLI serves the arch's smoke config (as the reference launcher does);
``serve(cfg, ...)`` is the same path for any config, which is how
``chip_smoke.py`` drives gemma3-1b at its published size. Steps:

1. make weights (``models.init_params``, on the device);
2. pack them into a bundle (``ckpt.bundle_from_params``);
3. publish the bundle and an app importing ``models.manifest_refs(cfg)`` in
   one management transaction of a ``Workspace``;
4. spin up a ``ServeEngine`` through ``ws.load(app, strategy=...)`` (the
   stable linker by default, which builds the arena on the device with the
   ``paged_reloc_copy`` kernel; host-only strategies copy it there);
5. prefill a batch of random prompts and decode greedily.

``--fleet N`` additionally spawns N worker processes that load the same
app with the ``stable-shm`` strategy: the machine holds one physical arena
copy (at most one worker fills the shm segment, the rest attach); the
fleet summary joins the output JSON.

``--traffic N`` spawns N serving workers on ``--device``, wired to the
dispatcher by shm request/response rings, and drives a Poisson load
(``--rate-hz``, ``--requests``) through ``engine.serve_loop``, reporting
sustained req/s, tok/s, p50/p99 end-to-end latency and each worker's
kernel launches. ``--stream`` sends every generated token back as its own
PARTIAL frame (the report gains time-to-first-token quantiles);
``--temperature``/``--top-k``/``--sampling-seed`` switch greedy decode to
sampling (token i of request r depends only on the seed, r and i);
``--mpmc`` runs the request rings in multi-producer mode.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from dataclasses import dataclass

import numpy as np

from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import ObjectKind, make_object
from repro_torch.link import Workspace, available_strategies
from repro_torch.serve import ServeEngine, run_traffic


@dataclass
class ServeRun:
    """What one ``serve`` call did: the engine it built, the prompts it
    sent, the tokens that came back, and the JSON-ready summary."""

    engine: ServeEngine
    prompts: np.ndarray
    tokens: np.ndarray
    summary: dict


def publish_model(ws: Workspace, cfg, *, seed: int = 0, device="cuda") -> str:
    """Publish ``cfg``'s weights and its serving app unless the workspace
    already has them; returns the app's name."""
    app_name = f"serve:{cfg.name}"
    if app_name not in ws.world():
        specs = models.param_specs(cfg)
        params = models.init_params(cfg, seed, device)
        bundle, payload = bundle_from_params(
            f"weights:{cfg.name}", "v1", params, specs=specs
        )
        del params
        app, _ = make_object(
            name=app_name,
            version="1",
            kind=ObjectKind.APPLICATION,
            refs=models.manifest_refs(cfg),
            needed=[bundle.name],
        )
        with ws.management() as tx:
            tx.publish(bundle, payload)
            tx.publish(app)
    return app_name


def config_source(cfg) -> tuple[str, bool]:
    """``(arch, smoke)`` with ``get_config(arch, smoke=smoke) == cfg``: how
    worker processes rebuild ``cfg`` by name. Raises for any other config."""
    for arch in ARCHS:
        for smoke in (False, True):
            if get_config(arch, smoke=smoke) == cfg:
                return arch, smoke
    raise ValueError(
        f"{cfg.name}: fleet and traffic workers rebuild their config with "
        "get_config(arch, smoke=...); pass one of those configs"
    )


def serve(cfg, ws: Workspace, *, batch: int = 4, prompt_len: int = 32,
          max_new: int = 16, seed: int = 0, strategy: str = "stable",
          device="cuda", fleet: int = 0, traffic: int = 0,
          rate_hz: float = 100.0, requests: int = 32, stream: bool = False,
          temperature: float = 0.0, top_k: int = 0, sampling_seed: int = 0,
          mpmc: bool = False) -> ServeRun:
    """Publish (if needed), load through ``strategy``, generate; then, as
    asked, a load-only ``stable-shm`` fleet of ``fleet`` processes and a
    ``traffic`` drive of ``requests`` requests into that many workers
    (batch ``batch`` each) on ``device``."""
    if fleet or traffic:
        arch, smoke = config_source(cfg)
    app_name = publish_model(ws, cfg, seed=seed, device=device)
    engine = ServeEngine.from_workspace(
        cfg, ws, app_name, strategy=strategy,
        cache_len=prompt_len + max_new, device=device,
    )
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    out, stats = engine.generate(prompts, max_new)
    summary = {
        "arch": cfg.name,
        "device": str(engine.device),
        "epoch": ws.epoch,
        "load_strategy": engine.load_stats.strategy,
        "load_s": engine.load_stats.startup_s,
        "load_cache_hit": engine.load_stats.cache_hit,
        "out_shape": list(out.shape),
        "prefill_s": stats.prefill_s,
        "decode_s": stats.decode_s,
        "tok_per_s": stats.tok_per_s,
        "sample": out[0, :8].tolist(),
    }
    if fleet:
        report = ServeEngine.spawn_fleet(
            ws, app_name, processes=fleet, strategy="stable-shm",
            device=device, smoke=smoke,
        )
        summary["fleet"] = report.summary()
    if traffic:
        rep = run_traffic(
            ws, app_name, arch=arch, workers=traffic, n_requests=requests,
            rate_hz=rate_hz, prompt_len=prompt_len, max_new_tokens=max_new,
            max_batch=batch, seed=seed, stream=stream,
            temperature=temperature, top_k=top_k,
            sampling_seed=sampling_seed, mpmc=mpmc, device=device,
            smoke=smoke,
        )
        summary["traffic"] = rep.summary()
    return ServeRun(engine=engine, prompts=prompts, tokens=out, summary=summary)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="stable", choices=available_strategies())
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--fleet", type=int, default=0, metavar="N",
        help="also spawn N worker processes sharing one shm arena "
             "(stable-shm) and report fills/attaches",
    )
    ap.add_argument(
        "--traffic", type=int, default=0, metavar="N",
        help="drive a Poisson request load through N serving workers "
             "connected by shm rings (continuous batching via "
             "engine.serve_loop); reports sustained req/s and p50/p99",
    )
    ap.add_argument("--rate-hz", type=float, default=100.0,
                    help="Poisson arrival rate for --traffic")
    ap.add_argument("--requests", type=int, default=32,
                    help="number of requests --traffic sends")
    ap.add_argument(
        "--stream", action="store_true",
        help="with --traffic: stream every token as a PARTIAL frame and "
             "report TTFT p50/p99 alongside completion latency",
    )
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="with --traffic: sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="with --traffic: sample from the k most likely "
                         "tokens (0 = full vocabulary)")
    ap.add_argument("--sampling-seed", type=int, default=0,
                    help="with --traffic: seed of sampled decode; tokens are "
                         "a pure function of (seed, request id, position)")
    ap.add_argument("--mpmc", action="store_true",
                    help="with --traffic: run request rings in "
                         "multi-producer mode")
    ap.add_argument("--registry", default=None)
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    registry = args.registry or tempfile.mkdtemp(prefix="repro-torch-serve-")
    ws = Workspace.open(registry)
    run = serve(cfg, ws, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, seed=args.seed, strategy=args.strategy,
                device=args.device, fleet=args.fleet, traffic=args.traffic,
                rate_hz=args.rate_hz, requests=args.requests,
                stream=args.stream, temperature=args.temperature,
                top_k=args.top_k, sampling_seed=args.sampling_seed,
                mpmc=args.mpmc)
    if args.registry is None:
        # throwaway registry: any stable-shm load (single engine, fleet or
        # traffic workers) published machine-wide segments nothing will
        # ever reattach
        from repro_torch.core import shm_arena

        shm_arena.unlink_root_segments(ws.registry)
    print(json.dumps(run.summary, indent=1))


if __name__ == "__main__":
    main()
