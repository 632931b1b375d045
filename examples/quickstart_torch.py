"""Quickstart on the PyTorch port: the whole stable-linking story through
one session object.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # the CPU
    PYTHONPATH=src python examples/quickstart_torch.py                # the card

The port of ``examples/quickstart.py``:

1. management time  — one transaction publishes a weight bundle + an app
2. commit           — relocation tables materialize; a new epoch begins
3. epoch            — table-driven (resolution-free) loading straight into
                      one arena on the device; run the model on its views
4. explain          — the mapping is observable (summary / SQL) mid-epoch
5. rollback         — a failed management transaction leaves the epoch,
                      the committed world, and every load untouched
6. update           — a clean transaction upgrades one bundle; tables
                      re-materialize; the next load sees the new world

The only entry point is ``repro_torch.link.Workspace``. ``--device`` is
``cuda`` unless the caller asks for the CPU; without a card it raises.
``main()`` returns the story's facts as a dict.
"""

import argparse

import numpy as np
import torch

from repro_torch import convert, models, resolve_device
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core import ImmutableEpochError, ObjectKind, make_object
from repro_torch.link import Workspace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    facts = {}
    ws = Workspace.ephemeral(prefix="repro-quickstart-")
    try:
        # -- 1. management time: one transaction -----------------------------
        cfg = get_config("gemma3-1b", smoke=True)
        specs = models.param_specs(cfg)
        params = models.init_params(cfg, 0, device)
        bundle, payload = bundle_from_params("weights:gemma", "v1", params, specs=specs)
        app, _ = make_object(
            name="serve:gemma",
            version="1",
            kind=ObjectKind.APPLICATION,
            refs=models.manifest_refs(cfg),     # the app's relocation instructions
            needed=["weights:gemma"],           # DT_NEEDED
        )
        with ws.management() as tx:
            tx.publish(bundle, payload)
            tx.publish(app)

        # -- 2. commit materialized relocation tables ------------------------
        print(f"epoch {ws.epoch} begins; mode={ws.mode.value}")

        # -- 3. epoch: stable (table-driven) load onto the device ------------
        image = ws.load("serve:gemma", strategy="stable", device=device)
        print(
            f"loaded {image.stats.relocations} relocations via {image.stats.strategy} "
            f"onto {device.type} in {image.stats.startup_s*1e3:.1f}ms "
            f"(table {image.stats.table_load_s*1e3:.1f}ms, io {image.stats.io_s*1e3:.1f}ms)"
        )
        live = convert.params_from_device_image(image, specs, device)
        tokens = torch.arange(16, dtype=torch.int32, device=device)[None, :] % cfg.vocab_size
        with torch.inference_mode():
            logits, _ = models.forward(cfg, live, {"tokens": tokens})
        print("forward OK:", tuple(logits.shape))
        facts.update(epoch=ws.epoch, relocations=image.stats.relocations,
                     strategy=image.stats.strategy, logits_shape=tuple(logits.shape),
                     logits_finite=bool(torch.isfinite(logits).all()))

        # the registry is immutable during the epoch
        try:
            ws.manager.update_obj(bundle, payload)
        except ImmutableEpochError as e:
            print("epoch immutability enforced:", type(e).__name__)
            facts["immutable"] = True

        # -- 4. the relocation mapping is observable -------------------------
        report = ws.explain("serve:gemma")
        print(
            f"explain: epoch={report.epoch} source={report.source} "
            f"by_type={report.by_type} providers={list(report.providers)}"
        )
        conn = report.to_sqlite(abi_objects=[bundle])
        n = conn.execute("SELECT COUNT(*) FROM relocations").fetchone()[0]
        some = conn.execute(
            "SELECT symbol_name, provides_so_name, st_value FROM relocations LIMIT 3"
        ).fetchall()
        print(f"SQL: {n} relocations;", some)
        facts["sql_relocations"] = n

        # -- 5. a failed transaction rolls the staged world back -------------
        world_before = ws.world().bindings
        try:
            with ws.management() as tx:
                tx.remove("weights:gemma")      # staged...
                raise RuntimeError("operator aborts the maintenance window")
        except RuntimeError:
            pass
        assert ws.epoch == 1 and ws.world().bindings == world_before
        image_again = ws.load("serve:gemma", strategy="stable", device=device)
        assert torch.equal(image_again["final_norm/scale"], image["final_norm/scale"])
        print("rollback OK: epoch, world and loads unchanged after the abort")
        facts["rollback_epoch"] = ws.epoch

        # -- 6. a clean transaction upgrades the world -----------------------
        params2 = dict(params)
        params2["final_norm/scale"] = params["final_norm/scale"] * 2
        bundle2, payload2 = bundle_from_params("weights:gemma", "v2", params2, specs=specs)
        with ws.management() as tx:
            tx.publish(bundle2, payload2)

        image2 = ws.load("serve:gemma", strategy="stable", device=device)
        assert torch.equal(image2["final_norm/scale"], params2["final_norm/scale"])
        print("epoch", ws.epoch, "sees the upgraded bundle — done.")
        facts["upgraded_epoch"] = ws.epoch
    finally:
        ws.close()
    return facts


if __name__ == "__main__":
    main()
