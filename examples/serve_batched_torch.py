"""Batched serving of a small model on the PyTorch port — the paper's kind
of win (startup).

    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu   # the CPU
    PYTHONPATH=src python examples/serve_batched_torch.py                # the card

The port of ``examples/serve_batched.py``. Publishes a model world once,
then simulates a fleet of short-lived server processes: each "process
start" loads weights dynamically (baseline) vs via the materialized table
(stable), then serves a batch of greedy-decode requests on ``--device``
(``cuda`` unless the caller asks for the CPU; without a card it raises).
The aggregate-startup-cost argument of the paper, live. ``run()`` returns
the facts as a dict (the served tokens included).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import models, resolve_device
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core import ObjectKind, make_object
from repro_torch.link import Workspace
from repro_torch.serve import ServeEngine

N_PROCS = 8
STRATEGIES = ("dynamic", "stable", "stable-mmap-cached")


def config():
    return get_config("mamba2-370m", smoke=True).replace(num_layers=48)  # real depth


def run(device="cuda", *, params=None) -> dict:
    """The story on ``device``; ``params`` (the model's tensors, default
    ``models.init_params(cfg, 0)``) lets a caller share weights."""
    dev = resolve_device(device)
    cfg = config()
    specs = models.param_specs(cfg)
    if params is None:
        params = models.init_params(cfg, 0, dev)
    ws = Workspace.ephemeral(prefix="repro-serve-")
    facts = {"startups_s": {}}
    try:
        bundle, payload = bundle_from_params(
            "weights:mamba", "v1", params, specs=specs, fragment_layers=True
        )
        app, _ = make_object(
            name="serve:mamba", version="1", kind=ObjectKind.APPLICATION,
            refs=models.manifest_refs(cfg, fragment=True), needed=["weights:mamba"],
        )
        with ws.management() as tx:
            tx.publish(bundle, payload)
            tx.publish(app)

        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (4, 24), dtype=np.int32)

        for strategy in STRATEGIES:
            t0 = time.perf_counter()
            startups = 0.0
            for _ in range(N_PROCS):
                img = ws.load("serve:mamba", strategy=strategy)
                startups += img.stats.startup_s
            load_wall = time.perf_counter() - t0
            facts["startups_s"][strategy] = startups
            print(
                f"{strategy:18s}: {N_PROCS} process starts, "
                f"aggregate weight-resolution+load {startups*1e3:7.1f}ms "
                f"(wall {load_wall*1e3:7.1f}ms)"
            )

        # one-call fleet warm-start: after this, every replica load is a cache hit
        rep = ws.warmup(workers=4)
        print(
            f"warmup: {len(rep.names)} app(s) in {rep.wall_s*1e3:.1f}ms "
            f"(hits={rep.cache_hits}, fills={rep.cache_fills})"
        )
        facts["warmup"] = {"names": rep.names, "hits": rep.cache_hits,
                           "fills": rep.cache_fills}

        # serve one batch to show the loaded image is the real thing: a
        # replica's epoch load is a hit on ONE host-side arena mapping, and
        # the replica stacks its per-layer fragments onto the device
        img = ws.load("serve:mamba", strategy="stable-mmap-cached")
        live = {}
        for name, spec in specs.items():
            arr = (np.stack([img[f"{name}[{l}]"] for l in range(cfg.num_layers)])
                   if name.startswith("blocks/") else np.array(img[name]))
            assert arr.dtype.name == spec.dtype and arr.shape == spec.shape, name
            live[name] = torch.from_numpy(arr).to(dev)
        engine = ServeEngine(cfg, live, cache_len=48, device=dev)
        engine.load_stats = img.stats
        print(f"replica load: {engine.load_stats.strategy} "
              f"cache_hit={engine.load_stats.cache_hit}")
        out, stats = engine.generate(prompts, 8)
        print(
            f"served batch={prompts.shape[0]}: prefill {stats.prefill_s*1e3:.0f}ms, "
            f"decode {stats.tok_per_s:.0f} tok/s, sample row: {out[0].tolist()}"
        )
        facts.update(cache_hit=engine.load_stats.cache_hit, prompts=prompts, tokens=out,
                     tok_per_s=stats.tok_per_s)
    finally:
        ws.close()
    return facts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
