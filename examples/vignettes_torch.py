"""The paper's dependency-management vignettes (§5.3) and seven more, on a
model zoo, through the PyTorch port.

    PYTHONPATH=src python examples/vignettes_torch.py --device cpu   # the CPU
    PYTHONPATH=src python examples/vignettes_torch.py                # the card

The port of ``examples/vignettes.py``; the story of each vignette is told
there and in its function here. Vignettes 1-5 and 9 are the host-side
linker and the arena store; 6, 7 and 10 spawn worker processes that serve
on ``--device`` (``cuda`` unless the caller asks for the CPU; without a
card it raises), and 8 flips an engine on it.

1. ABI compatibility           6. a Poisson load over the shm fleet
2. CVE audit                   7. roll a library under load (blue/green)
3. fine-grained interposition  8. survive a bad roll (adopt deadline)
4. preflight a risky roll      9. survive a flaky artifact store
5. warm-start a fleet         10. stream a sampled response

Each ``vignette_N(zoo)`` prints what the reference's script prints and
returns that vignette's facts as a dict; they run in order on one
``Zoo`` (``build_zoo``), as the story does.
"""

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch import models, resolve_device
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core import (
    EpochCache,
    ObjectKind,
    inspector,
    interpose,
    make_object,
    shm_arena,
)
from repro_torch.core.arena_store import FetchPolicy
from repro_torch.core.errors import AdoptDeadlineError
from repro_torch.core.executor import LoadStats
from repro_torch.launch.store import StoreServer
from repro_torch.link import Workspace
from repro_torch.serve import FaultPlan, ServeEngine, faults, run_traffic
from repro_torch.serve.faults import StoreFaultPlan

TRAFFIC_ARCH = "mamba2-370m"


@dataclass
class Zoo:
    """The world the vignettes share, and what one hands the next."""

    ws: Workspace
    device: object
    params_for: object            # (cfg, seed) -> {name: tensor}
    moe_params: dict
    moe_bundle: object
    t_moe: object
    t_dense: object
    tr_cfg: object
    state: dict = field(default_factory=dict)


def build_zoo(device="cuda", *, params_for=None) -> Zoo:
    """An MoE model (fragmented per-expert symbols) + a dense model,
    published in one transaction. ``params_for(cfg, seed)`` makes each
    model's tensors (default ``models.init_params`` on ``device``), so a
    caller can share weights with another implementation."""
    dev = resolve_device(device)
    if params_for is None:
        def params_for(cfg, seed):
            return models.init_params(cfg, seed, dev)

    ws = Workspace.ephemeral(prefix="repro-vignettes-")
    moe_cfg = get_config("olmoe-1b-7b", smoke=True)
    dense_cfg = get_config("starcoder2-3b", smoke=True)
    moe_params = params_for(moe_cfg, 0)
    dense_params = params_for(dense_cfg, 1)

    moe_bundle, moe_pl = bundle_from_params(
        "weights:olmoe", "v1", moe_params,
        fragment_layers=True, fragment_experts=True,
    )
    dense_bundle, dense_pl = bundle_from_params(
        "weights:starcoder", "v1", dense_params, fragment_layers=True
    )
    moe_app, _ = make_object(
        name="serve:olmoe", version="1", kind=ObjectKind.APPLICATION,
        refs=models.manifest_refs(moe_cfg, fragment=True), needed=["weights:olmoe"],
    )
    dense_app, _ = make_object(
        name="serve:starcoder", version="1", kind=ObjectKind.APPLICATION,
        refs=models.manifest_refs(dense_cfg, fragment=True),
        needed=["weights:starcoder"],
    )
    with ws.management() as tx:
        for o, p in [(moe_bundle, moe_pl), (dense_bundle, dense_pl),
                     (moe_app, b""), (dense_app, b"")]:
            tx.publish(o, p)

    return Zoo(
        ws=ws, device=dev, params_for=params_for,
        moe_params=moe_params, moe_bundle=moe_bundle,
        t_moe=ws.load("serve:olmoe").table, t_dense=ws.load("serve:starcoder").table,
        tr_cfg=get_config(TRAFFIC_ARCH, smoke=True),
    )


def _arena_bytes(ws, app_name: str) -> bytes:
    world = ws.world()
    app = world.resolve(app_name)
    key = ws.executor.closure_key(app, world)
    return ws.registry.arena_path(app.content_hash, key).read_bytes()


def _mamba_traffic(zoo, **kw):
    return run_traffic(zoo.ws, "serve:mamba", arch=TRAFFIC_ARCH, prompt_len=8,
                       max_new_tokens=6, device=zoo.device, **kw)


# ---------------------------------------------------------------- vignette 1
def vignette_1(zoo) -> dict:
    print("=== Vignette 1: ABI compatibility (Alice) ===")
    # the proposed v2 bundle drops layer 0's mlp_norm and reshapes a router
    v2_params = {
        k: v for k, v in zoo.moe_params.items() if k != "blocks/mlp_norm/scale"
    }
    v2_params["blocks/router/w"] = zoo.moe_params["blocks/router/w"][:, :, : -1]
    zoo.state["v2_params"] = v2_params
    v2_bundle, _ = bundle_from_params(
        "weights:olmoe-v2", "v2", v2_params,
        fragment_layers=True, fragment_experts=True,
    )
    conn = inspector.to_sqlite(
        [zoo.t_moe, zoo.t_dense], abi_objects=[zoo.moe_bundle, v2_bundle]
    )
    zoo.state["conn"] = conn
    missing = inspector.abi_incompatibilities(
        conn, app="serve:olmoe", old_bundle="weights:olmoe",
        new_bundle="weights:olmoe-v2",
    )
    print(f"  upgrading to v2 would break {len(missing)} relocations, e.g.:")
    for sym, req in missing[:4]:
        print(f"    {sym}  (required by {req})")
    return {"broken": sorted(tuple(m) for m in missing)}


# ---------------------------------------------------------------- vignette 2
def vignette_2(zoo) -> dict:
    print("=== Vignette 2: CVE audit (Bob) ===")
    conn = zoo.state["conn"]
    bad_symbol = "blocks/experts/w_down[1][3]"   # layer 1, expert 3
    hits = inspector.cve_audit(conn, bundle="weights:olmoe", symbol=bad_symbol)
    print(f"  apps binding {bad_symbol!r}: {hits}")
    hits2 = inspector.cve_audit(conn, bundle="weights:olmoe", symbol="nonexistent")
    print(f"  apps binding a clean symbol: {hits2} (quarantine nothing)")
    return {"symbol": bad_symbol, "apps": sorted(hits), "clean_apps": sorted(hits2)}


# ---------------------------------------------------------------- vignette 3
def vignette_3(zoo) -> dict:
    print("=== Vignette 3: fine-grained interposition (Charlie) ===")
    ws = zoo.ws
    slot = "blocks/attn_norm/scale[1]"
    dbg = {slot: zoo.moe_params["blocks/attn_norm/scale"][1] * 100}
    dbg_bundle, dbg_pl = bundle_from_params("debug:norms", "1", dbg)
    with ws.management() as tx:
        tx.publish(dbg_bundle, dbg_pl)
    before = ws.load("serve:olmoe", strategy="stable")
    n = interpose.rebind(zoo.t_moe, symbol_glob=slot, new_provider=dbg_bundle)
    img = ws.executor._apply_table(
        ws.world().resolve("serve:olmoe"), zoo.t_moe, LoadStats()
    )
    print(f"  rebound {n} relocation(s); layer-1 norm now instrumented:")
    print(
        "    layer0 scale[:3] =", np.asarray(img["blocks/attn_norm/scale[0]"])[:3],
        "\n    layer1 scale[:3] =", np.asarray(img[slot])[:3],
    )
    edited = [r for r in inspector.table_records(zoo.t_moe) if r["flags"]]
    print(f"  inspector shows {len(edited)} edited row(s) -> fully auditable")
    untouched = [k for k in img.tensors if k != slot
                 and np.array_equal(np.asarray(img[k]), np.asarray(before[k]))]
    return {"rebound": n, "slot": slot,
            "slot_bytes": np.ascontiguousarray(img[slot]).tobytes(),
            "untouched": len(untouched), "symbols": len(img.tensors),
            "edited_rows": len(edited)}


# ---------------------------------------------------------------- vignette 4
class AbortRoll(Exception):
    pass


def vignette_4(zoo) -> dict:
    print("=== Vignette 4: preflight a risky library roll (Dana) ===")
    # Dana wants to roll weights:olmoe to the v2 params from vignette 1 (which
    # drop a norm scale and reshape the router). Stage it, preview, decide.
    ws = zoo.ws
    roll_bundle, roll_pl = bundle_from_params(
        "weights:olmoe", "v2", zoo.state["v2_params"],
        fragment_layers=True, fragment_experts=True,
    )
    facts = {"epoch_before": ws.epoch}
    try:
        with ws.management() as tx:
            tx.publish(roll_bundle, roll_pl)
            diff = tx.diff()
            print(f"  staged diff: upgraded={sorted(diff.upgraded)}")
            preview = tx.preview()
            d = preview.delta_for("serve:olmoe")
            print(
                f"  preview for serve:olmoe: {len(d.changed)} changed, "
                f"{len(d.unresolved)} unresolved, "
                f"tables to rebuild: {preview.tables_to_rebuild}"
            )
            for u in d.unresolved[:3]:
                print(f"    would break: {u['symbol']}")
            facts.update(upgraded=sorted(diff.upgraded), changed=len(d.changed),
                         broken=len(d.unresolved),
                         tables_to_rebuild=sorted(preview.tables_to_rebuild))
            # the same delta is visible through the one-call surface:
            rep = ws.explain("serve:olmoe", pending=True)
            assert rep.pending and rep.delta is not None
            if d.unresolved:
                raise AbortRoll  # commit would strand these relocations
    except AbortRoll:
        print(
            f"  roll aborted pre-commit; epoch still {ws.epoch} "
            f"(was {facts['epoch_before']}), journal truncated "
            f"({len(ws.journal.entries())} entries)"
        )
    assert ws.epoch == facts["epoch_before"]
    np.testing.assert_array_equal(
        np.asarray(ws.load("serve:olmoe")["blocks/router/w[0]"]),
        zoo.moe_params["blocks/router/w"][0].cpu().numpy(),
    )
    print("  committed world unchanged -> jobs keep loading the v1 mapping")
    facts.update(epoch_after=ws.epoch, journal_entries=len(ws.journal.entries()))
    return facts


# ---------------------------------------------------------------- vignette 5
def vignette_5(zoo, replicas: int = 4) -> dict:
    print("=== Vignette 5: warm-start a serving fleet inside an epoch (Eve) ===")
    # Every replica start is an epoch load: the relocation work already
    # happened at end_mgmt (the table was materialized AND pre-applied into
    # a baked arena), so each warm start is one copy-on-write mmap + views.
    ws = zoo.ws

    def journal_bytes() -> int:
        p = ws.registry.journal_path
        return p.stat().st_size if p.exists() else 0

    journal_bytes0 = journal_bytes()
    # one-call fleet warmup through the process-wide EpochCache
    warm = ws.warmup(workers=replicas)
    print(
        f"  warmup: {len(warm.names)} app(s) preloaded in "
        f"{warm.wall_s * 1e3:.1f}ms (fills={warm.cache_fills})"
    )
    t0 = time.perf_counter()
    fleet = [ws.load("serve:starcoder", strategy="stable-mmap")
             for _ in range(replicas)]
    mmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shared = [ws.load("serve:starcoder", strategy="stable-mmap-cached")
              for _ in range(replicas)]
    cached_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(replicas):
        copied = ws.load("serve:starcoder", strategy="stable")
    copy_s = time.perf_counter() - t0
    assert all(r.arena is shared[0].arena for r in shared)  # ONE shared mapping
    print(
        f"  {replicas} replicas: epoch-resident {cached_s * 1e3:.1f}ms vs "
        f"stable-mmap {mmap_s * 1e3:.1f}ms vs "
        f"table-driven copy {copy_s * 1e3:.1f}ms "
        f"({copy_s / max(cached_s, 1e-9):.0f}x); all cached replicas share "
        f"one read-only mapping"
    )
    digests = {shm_arena.tensors_digest(r.tensors) for r in fleet + shared + [copied]}
    # CoW isolation: one replica scribbling on its weights cannot leak into
    # the baked arena or its siblings
    fleet[0]["final_norm/scale"][:] = 0
    assert np.any(np.asarray(fleet[1]["final_norm/scale"]))
    written = journal_bytes() - journal_bytes0
    assert written == 0  # epoch path: zero journal bytes
    print("  epoch-path journal bytes written by the fleet: 0 (asserted)")
    # A publish that does not touch the fleet's closure reuses every
    # materialized table and arena across the epoch bump.
    with ws.management() as tx:
        tx.publish(*bundle_from_params(
            "debug:norms", "2",
            {"blocks/attn_norm/scale[1]": zoo.moe_params["blocks/attn_norm/scale"][1]},
        ))
    mat = tx.materialization
    print(
        f"  unrelated publish: re-materialized={sorted(mat.materialized)}, "
        f"tables reused={mat.tables_reused}"
    )
    assert "serve:starcoder" in mat.reused
    ws.load("serve:starcoder", strategy="stable-mmap")  # still one mmap away
    print("  fleet keeps warm-starting across the epoch bump")
    return {"warmed": sorted(warm.names), "fills": warm.cache_fills,
            "replica_digests": sorted(digests), "shared_mapping": True,
            "journal_bytes": written, "rematerialized": sorted(mat.materialized),
            "tables_reused": mat.tables_reused,
            "starcoder_reused": "serve:starcoder" in mat.reused}


# ---------------------------------------------------------------- vignette 6
def vignette_6(zoo) -> dict:
    print("=== Vignette 6: serve a Poisson load over the shm fleet ===")
    # Real worker processes, each loading the app through ONE machine-shared
    # shm arena, wired to this dispatcher by shm rings, running the
    # continuous-batching engine.serve_loop on the device. Workers lift
    # params 1:1 from the image: the app uses whole-tensor symbols.
    ws = zoo.ws
    tr_params = zoo.params_for(zoo.tr_cfg, 2)
    tr_bundle, tr_pl = bundle_from_params(
        "weights:mamba", "v1", tr_params, specs=models.param_specs(zoo.tr_cfg))
    tr_app, _ = make_object(
        name="serve:mamba", version="1", kind=ObjectKind.APPLICATION,
        refs=models.manifest_refs(zoo.tr_cfg), needed=["weights:mamba"],
    )
    zoo.state["tr_app"] = tr_app
    with ws.management() as tx:
        tx.publish(tr_bundle, tr_pl)
        tx.publish(tr_app)
    rep = _mamba_traffic(zoo, workers=2, n_requests=8, rate_hz=50.0, max_batch=2)
    assert rep.failed == 0 and rep.completed == 8
    print(
        f"  {rep.workers} workers ready in {max(rep.ready_s):.1f}s; "
        f"{rep.completed}/{rep.sent} requests completed"
    )
    print(
        f"  sustained {rep.req_per_s:.1f} req/s, {rep.tok_per_s:.1f} tok/s; "
        f"p50 {rep.p50_s * 1e3:.1f}ms, p99 {rep.p99_s * 1e3:.1f}ms"
    )
    print("  ring segments reclaimed; fleet shm arena survives for reuse")
    return {"workers": rep.workers, "sent": rep.sent, "completed": rep.completed,
            "failed": rep.failed}


# ---------------------------------------------------------------- vignette 7
def vignette_7(zoo) -> dict:
    print("=== Vignette 7: roll a library under load (Frank) ===")
    # bake, preview, flip, drain, gc — while the fleet keeps serving
    ws = zoo.ws
    v2_mamba = zoo.params_for(zoo.tr_cfg, 3)
    zoo.state["v2_mamba"] = v2_mamba
    gen_before = ws.epoch_gen
    pre_roll: list = []
    previews: list = []

    def commit_v2():
        # snapshot generation N's segments, then bake + preview + commit
        pre_roll.extend(
            r["name"] for r in shm_arena.list_segments(ws.registry)
            if r.get("kind") != "ring"
        )
        b2, p2 = bundle_from_params("weights:mamba", "v2", v2_mamba,
                                    specs=models.param_specs(zoo.tr_cfg))
        with ws.management() as tx:
            tx.publish(b2, p2)
            pv = tx.preview()
            d = pv.delta_for("serve:mamba")
            assert d is not None and pv.is_clean
            previews.append((len(d.changed), len(d.unresolved)))
            print(
                f"  preview: {len(d.changed)} relocation(s) change, "
                f"{len(d.unresolved)} break -> safe to flip"
            )
        # clean exit = end_mgmt: generation N+1 now lives ALONGSIDE N

    rep2 = _mamba_traffic(zoo, workers=2, n_requests=9, rate_hz=50.0, max_batch=2,
                          rollover_at=3, rollover_fn=commit_v2)
    assert rep2.failed == 0 and rep2.completed == 9   # zero dropped
    assert ws.epoch_gen == gen_before + 1
    # every worker now serves bytes identical to a fresh load of gen N+1
    img = ws.load("serve:mamba", strategy="stable-mmap-cached")
    digest = shm_arena.tensors_digest(img.tensors)
    zoo.state["v2_digest"] = digest
    assert {a["digest"] for a in rep2.adoptions} == {digest}
    print(
        f"  flip: {len(rep2.adoptions)} worker(s) adopted gen "
        f"{ws.epoch_gen} at a request boundary in "
        f"{rep2.rollover_wall_s * 1e3:.0f}ms; weights byte-identical"
    )
    print(
        f"  rollover p99 {rep2.rollover_p99_s * 1e3:.1f}ms vs steady p99 "
        f"{rep2.steady_p99_s * 1e3:.1f}ms; {rep2.completed}/{rep2.sent} "
        f"requests completed across the roll"
    )
    g = ws.gc(drain=True)
    assert all(nm in g.removed for nm in pre_roll)
    print(
        f"  drain: gc reclaimed {g.segments_removed} old-generation "
        f"segment(s); the v2 world keeps serving"
    )
    ws.load("serve:mamba", strategy="stable-mmap-cached")
    return {"sent": rep2.sent, "completed": rep2.completed, "dropped": rep2.failed,
            "adoptions": len(rep2.adoptions), "generations": ws.epoch_gen - gen_before,
            "preview": previews, "adopted_v2": True,
            "old_segments_reclaimed": all(nm in g.removed for nm in pre_roll)}


# ---------------------------------------------------------------- vignette 8
def vignette_8(zoo) -> dict:
    print("=== Vignette 8: survive a bad roll (Grace) ===")
    # a v3 whose reload wedges: the adopt deadline fires, abort_adopt rolls
    # the store FORWARD to a generation that re-adopts the v2 world
    ws = zoo.ws
    engine = ServeEngine.from_workspace(zoo.tr_cfg, ws, "serve:mamba",
                                        cache_len=16, device=zoo.device)
    good = zoo.state["v2_digest"]      # the v2 digest vignette 7 verified
    gen_good = ws.epoch_gen

    v3_mamba = zoo.params_for(zoo.tr_cfg, 4)
    b3, p3 = bundle_from_params("weights:mamba", "v3", v3_mamba,
                                specs=models.param_specs(zoo.tr_cfg))
    with ws.management() as tx:
        tx.publish(b3, p3)
    aborted = ws.epoch_gen
    print(f"  committed v3 as generation {aborted} — but its reload wedges")

    faults.install(FaultPlan(wedge_adopt_s=30.0))
    try:
        t0 = time.perf_counter()
        try:
            engine.adopt_epoch(ws, "serve:mamba", deadline_s=0.3)
            raise AssertionError("wedged adopt did not deadline")
        except AdoptDeadlineError as err:
            wall = time.perf_counter() - t0
            rolled_back_to = err.rolled_back_to
    finally:
        faults.clear()

    assert rolled_back_to == gen_good + 2 == ws.epoch_gen
    img3 = ws.load("serve:mamba", strategy="stable-mmap-cached")
    digest = shm_arena.tensors_digest(img3.tensors)
    assert digest == good  # byte-identical to pre-roll v2
    print(
        f"  deadline fired at 0.3s; rolled back to generation "
        f"{ws.epoch_gen} in {wall:.2f}s total — weights byte-identical "
        f"to v2"
    )
    ws.gc(drain=True)             # the aborted v3 generation is reclaimed
    ws.load("serve:mamba", strategy="stable-mmap-cached")
    print("  drain: aborted generation reclaimed; v2 keeps serving")
    print("  failure mode          detection                recovery")
    print("  -------------------   ----------------------   ---------------------------")
    print("  wedged/slow reload    adopt_epoch deadline     auto-rollback (forward gen)")
    print("  bad weights shipped   operator / digest        ws.rollback_epoch()")
    print("  SIGKILLed worker      dead rsp-ring owner      supervisor re-route + respawn")
    print("  stuck request         per-request deadline     DEADLINE frame, slot freed")
    return {"aborted_generation": aborted - gen_good,
            "rolled_back_to": rolled_back_to - gen_good,
            "readopted_digest": digest, "digest_is_v2": digest == good}


# ---------------------------------------------------------------- vignette 9
def vignette_9(zoo) -> dict:
    print("=== Vignette 9: survive a flaky artifact store (Heidi) ===")
    # Bake ONCE, export content-addressed zlib-framed blobs, serve them with
    # the store launcher; fresh machines warm through `stable-remote` while
    # the wire truncates, flips bytes, and finally dies.
    ws = zoo.ws
    export = ws.export_store()
    print(
        f"  baker exported {export['entries']} arena blob(s): "
        f"{export['raw_bytes']} raw -> {export['blob_bytes']} encoded "
        f"({export['codec']})"
    )
    policy = FetchPolicy(connect_timeout_s=1.0, read_timeout_s=1.0,
                         retry_budget=6, backoff_base_s=0.02,
                         backoff_max_s=0.25)
    truth = _arena_bytes(ws, "serve:mamba")
    specs = models.param_specs(zoo.tr_cfg)

    def fresh_machine():
        # objects replicated, never baked: identical hashes, empty tables/
        m = Workspace.ephemeral(prefix="repro-vignette9-", epoch_cache=EpochCache())
        b2, p2 = bundle_from_params("weights:mamba", "v2", zoo.state["v2_mamba"],
                                    specs=specs)
        with m.management() as tx:
            tx.publish(b2, p2)
            tx.publish(zoo.state["tr_app"])
        for p in Path(m.root).glob("tables/*"):
            p.unlink()
        return m

    facts = {"export_entries": export["entries"], "codec": export["codec"]}
    blob_len = export["blob_bytes"] // max(export["entries"], 1)
    # -- a mid-stream truncation: the fetch must RESUME, not restart
    with StoreServer(
        Path(ws.root) / "store",
        faults=StoreFaultPlan(truncate_at=blob_len // 2, truncate_n=1),
    ) as srv:
        m1 = fresh_machine()
        m1.attach_store(srv.url, policy=policy)
        m1.load("serve:mamba", strategy="stable-remote")
        r1 = m1.store_report()
        assert r1.fetch_resumed >= 1 and not r1.degraded
        same1 = _arena_bytes(m1, "serve:mamba") == truth
        assert same1
        print(
            f"  truncated at byte {blob_len // 2}: resumed via range read "
            f"(retries={r1.fetch_retries}, resumed={r1.fetch_resumed}); "
            f"arena byte-identical to the baker's"
        )
        m1.close()
    facts["truncated"] = {"resumed": r1.fetch_resumed, "quarantined": r1.quarantined,
                          "blobs_fetched": r1.blobs_fetched, "degraded": r1.degraded,
                          "identical": same1}

    # -- a flipped byte: the content-hash check quarantines the transfer
    with StoreServer(
        Path(ws.root) / "store",
        faults=StoreFaultPlan(flip_at=blob_len // 3, flip_n=1),
    ) as srv:
        m2 = fresh_machine()
        m2.attach_store(srv.url, policy=policy)
        m2.load("serve:mamba", strategy="stable-remote")
        r2 = m2.store_report()
        assert r2.quarantined == 1 and not r2.degraded
        same2 = _arena_bytes(m2, "serve:mamba") == truth
        assert same2
        qdir = Path(m2.root) / "store" / "quarantine"
        n_bad = len(list(qdir.glob("*.bad")))
        print(
            f"  flipped byte caught by blake2b before admission: "
            f"{n_bad} quarantined transfer(s) with "
            f"structured records; clean retry landed identical bytes"
        )
        g9 = m2.gc()
        assert g9.store_files_removed >= 2
        print(
            f"  ws.gc() reclaimed {g9.store_files_removed} quarantine file(s) "
            f"(never retried from quarantine — corrupt bytes leave the machine)"
        )
        m2.close()
    facts["flipped"] = {"quarantined": r2.quarantined, "bad_files": n_bad,
                        "blobs_fetched": r2.blobs_fetched, "degraded": r2.degraded,
                        "identical": same2, "gc_removed": g9.store_files_removed}

    # -- the store drops dead mid-rollout: degrade, don't wedge
    m3 = fresh_machine()
    warm9 = m3.warmup(["serve:mamba"], store="http://127.0.0.1:9", policy=policy)
    assert warm9.degraded and warm9.store["fallback_bakes"] == 1
    same3 = _arena_bytes(m3, "serve:mamba") == truth
    assert same3
    print(
        f"  dead store: warmup completed DEGRADED "
        f"(fallback_bakes={warm9.store['fallback_bakes']}) — local bake, "
        f"same bytes, fleet still comes up"
    )
    m3.close()
    facts["dead"] = {"degraded": warm9.degraded,
                     "fallback_bakes": warm9.store["fallback_bakes"], "identical": same3}

    print("  failure mode          detection                recovery")
    print("  -------------------   ----------------------   ---------------------------")
    print("  refused connect       socket error             capped backoff + jitter, budgeted")
    print("  truncated stream      short read vs length     range-read RESUME of the partial")
    print("  flipped/corrupt bytes blake2b vs index digest  quarantine (+record), clean re-fetch")
    print("  slow-loris stall      per-read timeout         cut the cord, resume")
    print("  dead store            retry budget exhausted   degrade: local bake, degraded=True")
    return facts


# ---------------------------------------------------------------- vignette 10
def vignette_10(zoo) -> dict:
    print("=== Vignette 10: stream a sampled response through a shared ring ===")
    # every decode step a worker pushes a PARTIAL frame; the dispatcher
    # reassembles each stream in seq order and verifies it against the
    # completion frame. Token i of request r is a pure function of
    # (sampling_seed, r, i), whatever shared the batch.
    sampled = {"stream": True, "temperature": 0.7, "top_k": 8, "sampling_seed": 42}
    rep10 = _mamba_traffic(zoo, workers=2, n_requests=6, rate_hz=50.0, max_batch=2,
                           mpmc=True, **sampled)
    assert rep10.failed == 0 and rep10.completed == 6
    assert rep10.partial_frames == 6 * 6       # every token was streamed
    assert rep10.stream_gaps == 0              # in-order, no holes
    assert rep10.stream_mismatches == 0        # reassembly == completion
    assert len(rep10.stream_tokens) == 6
    assert all(len(t) == 6 for t in rep10.stream_tokens.values())
    print(
        f"  {rep10.partial_frames} PARTIAL frames streamed for "
        f"{rep10.completed} requests; {rep10.stream_gaps} gaps, "
        f"{rep10.stream_mismatches} reassembly mismatches (asserted 0)"
    )
    assert 0.0 < rep10.ttft_p50_s <= rep10.ttft_p99_s <= rep10.p99_s
    print(
        f"  TTFT p50 {rep10.ttft_p50_s * 1e3:.1f}ms / p99 "
        f"{rep10.ttft_p99_s * 1e3:.1f}ms vs completion p99 "
        f"{rep10.p99_s * 1e3:.1f}ms — the first token lands well before "
        f"the last"
    )
    # determinism across runs: same (seed, rid, position) -> same stream
    rep10b = _mamba_traffic(zoo, workers=1, n_requests=6, rate_hz=200.0, max_batch=3,
                            **sampled)
    identical = set(rep10b.stream_tokens) == set(rep10.stream_tokens) and all(
        np.array_equal(rep10b.stream_tokens[r], rep10.stream_tokens[r])
        for r in rep10.stream_tokens
    )
    assert identical
    print(
        "  re-served with different workers/batching/arrivals: every "
        "stream byte-identical (per-request PRNG keys)"
    )
    return {"completed": rep10.completed, "failed": rep10.failed,
            "partial_frames": rep10.partial_frames, "gaps": rep10.stream_gaps,
            "mismatches": rep10.stream_mismatches, "streams": len(rep10.stream_tokens),
            "identical_on_reserve": identical}


VIGNETTES = (vignette_1, vignette_2, vignette_3, vignette_4, vignette_5,
             vignette_6, vignette_7, vignette_8, vignette_9, vignette_10)


def main(argv=None) -> dict:
    # Everything runs under main(): vignettes 6, 7 and 10 spawn worker
    # processes (the spawn context re-imports this module in each child).
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    zoo = build_zoo(args.device)
    facts = {}
    try:
        for i, vignette in enumerate(VIGNETTES, 1):
            t0 = time.perf_counter()
            facts[i] = vignette(zoo)
            print(f"  (vignette {i}: {time.perf_counter() - t0:.1f} s)")
    finally:
        zoo.ws.close()
    return facts


if __name__ == "__main__":
    main()
