"""End-to-end training run with fault tolerance, on the PyTorch port.

    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu   # smoke
    PYTHONPATH=src python examples/train_e2e_torch.py                # the card
    PYTHONPATH=src python examples/train_e2e_torch.py --full         # ~100M params

The port of ``examples/train_e2e.py``: the full stable-linked lifecycle —
publish -> epoch startup (a table-driven load into one device arena, the
step built by ``build_step`` on ``make_local_mesh()``) -> train with async
checkpoints -> an injected node failure -> an automatic restart that
resumes from the newest checkpoint through the fast epoch path. The mesh
is one device with the production axis names (``data``, ``model``), over a
one-rank process group this script starts (NCCL on the card, gloo on the
CPU). The step runs eagerly: ``compile_source`` reads ``"eager"``.

The default runs a reduced gemma3 for 40 steps; ``--full`` switches to a
~100M-param config (sized for a card). ``--device`` is ``cuda`` unless
the caller asks for the CPU; without a card it raises.
"""

import argparse
import json
import tempfile

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import ensure_process_group, make_local_mesh
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M-param model, 200 steps (device-sized)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--registry", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    if args.full:
        cfg = get_config("gemma3-1b").replace(
            name="gemma3-100m", num_layers=8, d_model=768, num_heads=4,
            head_dim=192, d_ff=3072, vocab_size=32768, global_every=4,
            dtype="float32",
        )  # ~100M params
        shape = ShapeConfig("e2e", 512, 8, "train")
        steps = args.steps or 200
    else:
        cfg = get_config("gemma3-1b", smoke=True)
        shape = ShapeConfig("e2e", 64, 8, "train")
        steps = args.steps or 40

    registry = args.registry or tempfile.mkdtemp(prefix="repro-e2e-")
    tcfg = TrainConfig(
        steps=steps,
        checkpoint_every=max(5, steps // 8),
        microbatches=2,
        fail_at_step=steps // 2,          # injected failure mid-run
        step_deadline_s=30.0,
        opt=OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=steps),
    )
    ensure_process_group("local", args.device)
    tr = Trainer(registry, cfg, shape, tcfg, device=args.device,
                 mesh=make_local_mesh(args.device))
    if tr.app_name not in tr.ws.world():
        tr.publish()
    res = tr.run()
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "steps": res.steps_done,
                "restarts (injected failure)": res.restarts,
                "stragglers": res.stragglers,
                "checkpoint_saves": res.checkpoint_saves,
                "loss_first": round(res.losses[0], 4),
                "loss_last": round(res.losses[-1], 4),
                "startups": res.startup_stats,
                "registry": registry,
            },
            indent=1,
        )
    )
    assert res.losses[-1] < res.losses[0], "loss should decrease"
    print("OK: loss decreased across an injected failure + restart.")


if __name__ == "__main__":
    main()
