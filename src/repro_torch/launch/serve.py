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
   stable linker by default) and copy the weights to the device;
5. prefill a batch of random prompts and decode greedily.

Not ported yet (ROADMAP Queue A item 7): ``--fleet`` and ``--traffic``.
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
from repro_torch.serve import ServeEngine


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


def serve(cfg, ws: Workspace, *, batch: int = 4, prompt_len: int = 32,
          max_new: int = 16, seed: int = 0, strategy: str = "stable",
          device="cuda") -> ServeRun:
    """Publish (if needed), load through ``strategy``, generate."""
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
    ap.add_argument("--registry", default=None)
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    registry = args.registry or tempfile.mkdtemp(prefix="repro-torch-serve-")
    ws = Workspace.open(registry)
    run = serve(cfg, ws, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, seed=args.seed, strategy=args.strategy,
                device=args.device)
    if args.registry is None:
        # throwaway registry: a stable-shm load published machine-wide
        # segments nothing will ever reattach
        from repro_torch.core import shm_arena

        shm_arena.unlink_root_segments(ws.registry)
    print(json.dumps(run.summary, indent=1))


if __name__ == "__main__":
    main()
