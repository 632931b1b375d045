"""The port's examples against the reference's library on the same worlds.

``examples/vignettes_torch.py`` runs each vignette on a zoo whose weights
are the reference's ``init_params`` draws (the same seeds); the reference's
facts come from the reference's own library API on a world published from
those same arrays, vignette by vignette, as ``examples/vignettes.py`` runs
them. Both stories run once per module, lazily: each test case asks for
the vignettes up to its own, so a case runs alone as well as in order.
"""

from __future__ import annotations

import hashlib
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("_posixshmem")  # the fleet vignettes use POSIX shm

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_params(cfg_name: str, seed: int, cfg=None) -> dict:
    """The reference's ``init_params`` draw as numpy arrays."""
    from repro import models as ref_models
    from repro.configs import get_config as ref_config

    cfg = cfg or ref_config(cfg_name, smoke=True)
    return {n: np.asarray(v) for n, v in ref_models.init_params(cfg, seed).items()}


def _shared_params_for(cfg, seed):
    """``params_for`` of the port's zoo: the reference's draw for the smoke
    config ``cfg`` names, as tensors."""
    arrays = _ref_params(cfg.name.removesuffix("-smoke"), seed)
    return {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}


def _digest(tensors) -> str:
    h = hashlib.blake2b(digest_size=16)
    for nm in sorted(tensors):
        h.update(np.ascontiguousarray(tensors[nm]).view(np.uint8).tobytes())
    return h.hexdigest()


# ------------------------------------------------ the reference, vignette by vignette
class RefStory:
    """``examples/vignettes.py`` on the reference's library, returning the
    facts ``vignettes_torch`` returns."""

    def __init__(self):
        from repro import models
        from repro.ckpt import bundle_from_params
        from repro.configs import get_config
        from repro.core import ObjectKind, make_object
        from repro.link import Workspace

        self.models, self.bundle_from_params = models, bundle_from_params
        self.ObjectKind, self.make_object = ObjectKind, make_object
        self.ws = Workspace.ephemeral(prefix="repro-vignettes-ref-")
        self.moe_cfg = get_config("olmoe-1b-7b", smoke=True)
        dense_cfg = get_config("starcoder2-3b", smoke=True)
        self.tr_cfg = get_config("mamba2-370m", smoke=True)
        self.moe_params = _ref_params("olmoe-1b-7b", 0)
        dense_params = _ref_params("starcoder2-3b", 1)
        self.moe_bundle, moe_pl = bundle_from_params(
            "weights:olmoe", "v1", self.moe_params,
            fragment_layers=True, fragment_experts=True)
        self.dense_bundle, dense_pl = bundle_from_params(
            "weights:starcoder", "v1", dense_params, fragment_layers=True)
        moe_app, _ = make_object(
            name="serve:olmoe", version="1", kind=ObjectKind.APPLICATION,
            refs=models.manifest_refs(self.moe_cfg, fragment=True),
            needed=["weights:olmoe"])
        dense_app, _ = make_object(
            name="serve:starcoder", version="1", kind=ObjectKind.APPLICATION,
            refs=models.manifest_refs(dense_cfg, fragment=True),
            needed=["weights:starcoder"])
        with self.ws.management() as tx:
            for o, p in [(self.moe_bundle, moe_pl), (self.dense_bundle, dense_pl),
                         (moe_app, b""), (dense_app, b"")]:
                tx.publish(o, p)
        self.t_moe = self.ws.load("serve:olmoe").table
        self.t_dense = self.ws.load("serve:starcoder").table

    def _arena(self, ws, name):
        world = ws.world()
        app = world.resolve(name)
        key = ws.executor.closure_key(app, world)
        return ws.registry.arena_path(app.content_hash, key).read_bytes()

    def _traffic(self, **kw):
        from repro.serve import run_traffic

        return run_traffic(self.ws, "serve:mamba", arch="mamba2-370m", prompt_len=8,
                           max_new_tokens=6, **kw)

    def v1(self):
        from repro.core import inspector

        v2 = {k: v for k, v in self.moe_params.items() if k != "blocks/mlp_norm/scale"}
        v2["blocks/router/w"] = self.moe_params["blocks/router/w"][:, :, :-1]
        self.v2_params = v2
        v2_bundle, _ = self.bundle_from_params(
            "weights:olmoe-v2", "v2", v2, fragment_layers=True, fragment_experts=True)
        self.conn = inspector.to_sqlite([self.t_moe, self.t_dense],
                                        abi_objects=[self.moe_bundle, v2_bundle])
        missing = inspector.abi_incompatibilities(
            self.conn, app="serve:olmoe", old_bundle="weights:olmoe",
            new_bundle="weights:olmoe-v2")
        return {"broken": sorted(tuple(m) for m in missing)}

    def v2(self):
        from repro.core import inspector

        sym = "blocks/experts/w_down[1][3]"
        return {"symbol": sym,
                "apps": sorted(inspector.cve_audit(self.conn, bundle="weights:olmoe",
                                                   symbol=sym)),
                "clean_apps": sorted(inspector.cve_audit(
                    self.conn, bundle="weights:olmoe", symbol="nonexistent"))}

    def v3(self):
        from repro.core import inspector, interpose
        from repro.core.executor import LoadStats

        ws, slot = self.ws, "blocks/attn_norm/scale[1]"
        dbg_bundle, dbg_pl = self.bundle_from_params(
            "debug:norms", "1", {slot: self.moe_params["blocks/attn_norm/scale"][1] * 100})
        with ws.management() as tx:
            tx.publish(dbg_bundle, dbg_pl)
        before = ws.load("serve:olmoe", strategy="stable")
        n = interpose.rebind(self.t_moe, symbol_glob=slot, new_provider=dbg_bundle)
        img = ws.executor._apply_table(ws.world().resolve("serve:olmoe"), self.t_moe,
                                       LoadStats())
        untouched = [k for k in img.tensors if k != slot
                     and np.array_equal(np.asarray(img[k]), np.asarray(before[k]))]
        return {"rebound": n, "slot": slot,
                "slot_bytes": np.ascontiguousarray(img[slot]).tobytes(),
                "untouched": len(untouched), "symbols": len(img.tensors),
                "edited_rows": len([r for r in inspector.table_records(self.t_moe)
                                    if r["flags"]])}

    def v4(self):
        ws = self.ws
        roll_bundle, roll_pl = self.bundle_from_params(
            "weights:olmoe", "v2", self.v2_params, fragment_layers=True,
            fragment_experts=True)
        facts = {"epoch_before": ws.epoch}

        class Abort(Exception):
            pass

        try:
            with ws.management() as tx:
                tx.publish(roll_bundle, roll_pl)
                preview = tx.preview()
                d = preview.delta_for("serve:olmoe")
                facts.update(upgraded=sorted(tx.diff().upgraded), changed=len(d.changed),
                             broken=len(d.unresolved),
                             tables_to_rebuild=sorted(preview.tables_to_rebuild))
                raise Abort
        except Abort:
            pass
        facts.update(epoch_after=ws.epoch, journal_entries=len(ws.journal.entries()))
        return facts

    def v5(self):
        ws = self.ws
        p = ws.registry.journal_path
        size = (lambda: p.stat().st_size if p.exists() else 0)
        j0 = size()
        warm = ws.warmup(workers=4)
        loads = ([ws.load("serve:starcoder", strategy="stable-mmap") for _ in range(4)]
                 + [ws.load("serve:starcoder", strategy="stable-mmap-cached")
                    for _ in range(4)]
                 + [ws.load("serve:starcoder", strategy="stable")])
        digests = {_digest(r.tensors) for r in loads}
        written = size() - j0
        with ws.management() as tx:
            tx.publish(*self.bundle_from_params(
                "debug:norms", "2",
                {"blocks/attn_norm/scale[1]": self.moe_params["blocks/attn_norm/scale"][1]}))
        mat = tx.materialization
        return {"warmed": sorted(warm.names), "fills": warm.cache_fills,
                "replica_digests": sorted(digests), "shared_mapping": True,
                "journal_bytes": written, "rematerialized": sorted(mat.materialized),
                "tables_reused": mat.tables_reused,
                "starcoder_reused": "serve:starcoder" in mat.reused}

    def v6(self):
        bundle, pl = self.bundle_from_params("weights:mamba", "v1", _ref_params(
            "mamba2-370m", 2))
        self.tr_app, _ = self.make_object(
            name="serve:mamba", version="1", kind=self.ObjectKind.APPLICATION,
            refs=self.models.manifest_refs(self.tr_cfg), needed=["weights:mamba"])
        with self.ws.management() as tx:
            tx.publish(bundle, pl)
            tx.publish(self.tr_app)
        rep = self._traffic(workers=2, n_requests=8, rate_hz=50.0, max_batch=2)
        return {"workers": rep.workers, "sent": rep.sent, "completed": rep.completed,
                "failed": rep.failed}

    def v7(self):
        from repro.core import shm_arena

        ws = self.ws
        self.v2_mamba = _ref_params("mamba2-370m", 3)
        gen_before, pre_roll, previews = ws.epoch_gen, [], []

        def commit_v2():
            pre_roll.extend(r["name"] for r in shm_arena.list_segments(ws.registry)
                            if r.get("kind") != "ring")
            with ws.management() as tx:
                tx.publish(*self.bundle_from_params("weights:mamba", "v2", self.v2_mamba))
                d = tx.preview().delta_for("serve:mamba")
                previews.append((len(d.changed), len(d.unresolved)))

        rep = self._traffic(workers=2, n_requests=9, rate_hz=50.0, max_batch=2,
                            rollover_at=3, rollover_fn=commit_v2)
        self.v2_digest = _digest(ws.load("serve:mamba",
                                         strategy="stable-mmap-cached").tensors)
        g = ws.gc(drain=True)
        return {"sent": rep.sent, "completed": rep.completed, "dropped": rep.failed,
                "adoptions": len(rep.adoptions), "generations": ws.epoch_gen - gen_before,
                "preview": previews,
                "adopted_v2": {a["digest"] for a in rep.adoptions} == {self.v2_digest},
                "old_segments_reclaimed": all(nm in g.removed for nm in pre_roll)}

    def v8(self):
        from repro.core.errors import AdoptDeadlineError
        from repro.serve import FaultPlan, ServeEngine
        from repro.serve import faults

        ws = self.ws
        engine = ServeEngine.from_workspace(self.tr_cfg, ws, "serve:mamba", cache_len=16)
        gen_good = ws.epoch_gen
        with ws.management() as tx:
            tx.publish(*self.bundle_from_params("weights:mamba", "v3",
                                                _ref_params("mamba2-370m", 4)))
        aborted = ws.epoch_gen
        faults.install(FaultPlan(wedge_adopt_s=30.0))
        try:
            with pytest.raises(AdoptDeadlineError) as err:
                engine.adopt_epoch(ws, "serve:mamba", deadline_s=0.3)
        finally:
            faults.clear()
        digest = _digest(ws.load("serve:mamba", strategy="stable-mmap-cached").tensors)
        ws.gc(drain=True)
        return {"aborted_generation": aborted - gen_good,
                "rolled_back_to": err.value.rolled_back_to - gen_good,
                "readopted_digest": digest, "digest_is_v2": digest == self.v2_digest}

    def v9(self):
        from repro.core import EpochCache
        from repro.core.arena_store import FetchPolicy
        from repro.launch.store import StoreServer
        from repro.link import Workspace
        from repro.serve.faults import StoreFaultPlan

        ws = self.ws
        export = ws.export_store()
        policy = FetchPolicy(connect_timeout_s=1.0, read_timeout_s=1.0, retry_budget=6,
                             backoff_base_s=0.02, backoff_max_s=0.25)
        truth = self._arena(ws, "serve:mamba")
        sdir = Path(ws.root) / "store"

        def fresh():
            m = Workspace.ephemeral(prefix="repro-vignette9-ref-", epoch_cache=EpochCache())
            with m.management() as tx:
                tx.publish(*self.bundle_from_params("weights:mamba", "v2", self.v2_mamba))
                tx.publish(self.tr_app)
            for p in Path(m.root).glob("tables/*"):
                p.unlink()
            return m

        facts = {"export_entries": export["entries"], "codec": export["codec"]}
        blob_len = export["blob_bytes"] // max(export["entries"], 1)
        with StoreServer(sdir, faults=StoreFaultPlan(truncate_at=blob_len // 2,
                                                     truncate_n=1)) as srv:
            m1 = fresh()
            m1.attach_store(srv.url, policy=policy)
            m1.load("serve:mamba", strategy="stable-remote")
            r1 = m1.store_report()
            facts["truncated"] = {
                "resumed": r1.fetch_resumed, "quarantined": r1.quarantined,
                "blobs_fetched": r1.blobs_fetched, "degraded": r1.degraded,
                "identical": self._arena(m1, "serve:mamba") == truth}
            m1.close()
        with StoreServer(sdir, faults=StoreFaultPlan(flip_at=blob_len // 3,
                                                     flip_n=1)) as srv:
            m2 = fresh()
            m2.attach_store(srv.url, policy=policy)
            m2.load("serve:mamba", strategy="stable-remote")
            r2 = m2.store_report()
            n_bad = len(list((Path(m2.root) / "store" / "quarantine").glob("*.bad")))
            same = self._arena(m2, "serve:mamba") == truth
            facts["flipped"] = {
                "quarantined": r2.quarantined, "bad_files": n_bad,
                "blobs_fetched": r2.blobs_fetched, "degraded": r2.degraded,
                "identical": same, "gc_removed": m2.gc().store_files_removed}
            m2.close()
        m3 = fresh()
        warm = m3.warmup(["serve:mamba"], store="http://127.0.0.1:9", policy=policy)
        facts["dead"] = {"degraded": warm.degraded,
                         "fallback_bakes": warm.store["fallback_bakes"],
                         "identical": self._arena(m3, "serve:mamba") == truth}
        m3.close()
        return facts

    def v10(self):
        sampled = {"stream": True, "temperature": 0.7, "top_k": 8, "sampling_seed": 42}
        rep = self._traffic(workers=2, n_requests=6, rate_hz=50.0, max_batch=2,
                            mpmc=True, **sampled)
        again = self._traffic(workers=1, n_requests=6, rate_hz=200.0, max_batch=3,
                              **sampled)
        identical = set(again.stream_tokens) == set(rep.stream_tokens) and all(
            np.array_equal(again.stream_tokens[r], rep.stream_tokens[r])
            for r in rep.stream_tokens)
        return {"completed": rep.completed, "failed": rep.failed,
                "partial_frames": rep.partial_frames, "gaps": rep.stream_gaps,
                "mismatches": rep.stream_mismatches, "streams": len(rep.stream_tokens),
                "identical_on_reserve": identical}


class Stories:
    """The port's vignettes and the reference's, run in order up to a
    number on demand."""

    def __init__(self):
        self.mod = _example("vignettes_torch")
        self.zoo = self.mod.build_zoo("cpu", params_for=_shared_params_for)
        self.ref = RefStory()
        self.port_facts, self.ref_facts = {}, {}

    def upto(self, n: int):
        for i in range(len(self.port_facts) + 1, n + 1):
            self.port_facts[i] = self.mod.VIGNETTES[i - 1](self.zoo)
            self.ref_facts[i] = getattr(self.ref, f"v{i}")()
        return self.port_facts[n], self.ref_facts[n]

    def close(self):
        self.zoo.ws.close()
        self.ref.ws.close()


@pytest.fixture(scope="module")
def stories():
    s = Stories()
    try:
        yield s
    finally:
        s.close()


# What each vignette's facts must show on their own, beyond equality with
# the reference's.
EXPECT = {
    1: lambda f: len(f["broken"]) == 2,
    2: lambda f: f["apps"] == ["serve:olmoe"] and f["clean_apps"] == [],
    3: lambda f: f["rebound"] == 1 and f["untouched"] == f["symbols"] - 1
    and f["edited_rows"] == 1,
    4: lambda f: f["broken"] > 0 and f["epoch_after"] == f["epoch_before"]
    and f["journal_entries"] == 0,
    5: lambda f: len(f["replica_digests"]) == 1 and f["journal_bytes"] == 0
    and f["starcoder_reused"],
    6: lambda f: f["completed"] == f["sent"] == 8 and f["failed"] == 0,
    7: lambda f: f["completed"] == 9 and f["dropped"] == 0 and f["adoptions"] == 2
    and f["adopted_v2"] and f["old_segments_reclaimed"],
    8: lambda f: f["aborted_generation"] == 1 and f["rolled_back_to"] == 2
    and f["digest_is_v2"],
    9: lambda f: f["truncated"]["resumed"] >= 1 and f["flipped"]["quarantined"] == 1
    and f["dead"]["degraded"] and all(f[k]["identical"] for k in ("truncated", "flipped",
                                                                  "dead")),
    10: lambda f: f["partial_frames"] == 36 and f["gaps"] == f["mismatches"] == 0
    and f["identical_on_reserve"],
}


@pytest.mark.parametrize("n", range(1, 11))
def test_vignette_facts_equal_the_reference(stories, n):
    port, ref = stories.upto(n)
    assert port == ref
    assert EXPECT[n](port), port


# ------------------------------------------------------------ the other examples
def test_quickstart_runs_to_the_end(capsys):
    facts = _example("quickstart_torch").main(["--device", "cpu"])
    assert facts["logits_shape"] == (1, 16, 256) and facts["logits_finite"]
    assert facts["immutable"] and facts["rollback_epoch"] == 1
    assert facts["upgraded_epoch"] == 2
    assert facts["sql_relocations"] == facts["relocations"] > 0
    assert "sees the upgraded bundle — done." in capsys.readouterr().out


def test_serve_batched_tokens_equal_the_reference_engine():
    """serve_batched on the reference's weights for the same seed: its
    greedy tokens are the reference ``ServeEngine``'s on the same world."""
    import jax.numpy as jnp

    from repro import models as ref_models
    from repro.ckpt import bundle_from_params as ref_bundle
    from repro.configs import get_config as ref_config
    from repro.core import ObjectKind, make_object
    from repro.link import Workspace as RefWorkspace
    from repro.serve import ServeEngine as RefServeEngine

    mod = _example("serve_batched_torch")
    cfg = ref_config("mamba2-370m", smoke=True).replace(num_layers=48)
    params = _ref_params(cfg.name, 0, cfg)
    t0 = time.perf_counter()
    facts = mod.run("cpu", params={n: torch.from_numpy(a.copy()) for n, a in params.items()})
    assert time.perf_counter() - t0 < 120
    assert set(facts["startups_s"]) == set(mod.STRATEGIES)
    assert facts["cache_hit"] and facts["warmup"]["hits"] == 1

    ws = RefWorkspace.ephemeral(prefix="repro-serve-ref-")
    try:
        bundle, payload = ref_bundle("weights:mamba", "v1", params, fragment_layers=True)
        app, _ = make_object(
            name="serve:mamba", version="1", kind=ObjectKind.APPLICATION,
            refs=ref_models.manifest_refs(cfg, fragment=True), needed=["weights:mamba"])
        with ws.management() as tx:
            tx.publish(bundle, payload)
            tx.publish(app)

        def stack_params(img):
            return {name: jnp.asarray(
                np.stack([img[f"{name}[{l}]"] for l in range(cfg.num_layers)])
                if name.startswith("blocks/") else img[name])
                for name in ref_models.param_specs(cfg)}

        engine = RefServeEngine.from_workspace(cfg, ws, "serve:mamba", cache_len=48,
                                               param_builder=stack_params)
        want, _ = engine.generate(facts["prompts"], 8)
    finally:
        ws.close()
    np.testing.assert_array_equal(facts["tokens"], np.asarray(want))
