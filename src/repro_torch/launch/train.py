"""Training launcher, the port of the reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 20 --checkpoint-every 10 [--device cpu]

``--smoke`` (the default) selects the reduced config; ``--no-smoke`` the
published one. The registry directory is the stable linker's store;
rerunning with the same ``--registry`` resumes from the newest checkpoint
through the epoch (table-driven) path. The step runs on ``--device``
(``cuda`` unless the caller asks for the CPU; without a card it raises).
The reference's ``--mesh`` waits for the multi-device slice.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs import ARCHS, ShapeConfig, get_config
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--registry", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    registry = args.registry or tempfile.mkdtemp(prefix="repro-registry-")
    tcfg = TrainConfig(
        steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        microbatches=args.microbatches,
        fail_at_step=args.fail_at_step,
        opt=OptConfig(peak_lr=args.lr, warmup_steps=5, decay_steps=args.steps),
    )
    tr = Trainer(registry, cfg, shape, tcfg, device=args.device)
    if tr.app_name not in tr.ws.world():
        tr.publish()
    res = tr.run()
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "registry": registry,
                "steps": res.steps_done,
                "restarts": res.restarts,
                "checkpoint_saves": res.checkpoint_saves,
                "first_loss": res.losses[0] if res.losses else None,
                "last_loss": res.losses[-1] if res.losses else None,
                "startups": res.startup_stats,
            },
            indent=1,
        )
    )


if __name__ == "__main__":
    main()
