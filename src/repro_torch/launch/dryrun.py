"""Multi-pod dry-run, the port of the reference's ``launch/dryrun.py``.

For every (architecture x input shape x mesh) cell: build the step
(``build_step``) on a mesh of the cell's size, run it once on abstract
values, and record what one device would hold and do. Nothing is
computed and nothing is timed:

* the mesh is real (``init_device_mesh`` on the CPU) over a FAKE process
  group of the mesh's size (``torch.testing``'s ``FakeStore``, backend
  ``"fake"``): this process is rank 0, and a collective returns at once;
* every argument is a DTensor at its sharding whose local shard is a fake
  tensor (``FakeTensorMode``: a shape and a dtype, no storage);
* ``dist.hlo_analysis.StepTrace`` counts what rank 0 runs: FLOPs, HBM
  bytes, collectives and the peak bytes its tensors hold.

The record keeps the reference's fields: ``memory_analysis``
(``argument_size_in_bytes`` and ``output_size_in_bytes``, exact from the
local shard shapes; ``alias_size_in_bytes``, outputs updated in place;
``temp_size_in_bytes``, the peak bytes of the tensors the step allocates,
its outputs among them), ``roofline`` (``dist.hlo_analysis.Roofline``,
H100 SXM peaks) and ``collectives``; and one more, ``fits_h100_80gb``
(arguments plus that peak within an H100's 80 GB). The cost probe
(``run_cost_probe``) traces small-depth configs and extrapolates affinely
in layer-type counts, as the reference's does; in the port every layer
runs as a Python loop, so a full-depth trace counts every layer too (the
probe stays for its records and its lower cost).

Results append to a JSONL cache keyed by cell id (``build/dryrun_torch
.jsonl`` by default), so sweeps resume after interruption:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod

The fake process group is global to the process: a cell whose mesh has
another size starts a new one.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
import traceback
from pathlib import Path

import numpy as np

from repro_torch import models
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.dist.hlo_analysis import (
    Roofline,
    StepTrace,
    collective_stats,
    cost_analysis_terms,
)
from repro_torch.dist.sharding import RULESETS, ShardingRules
from repro_torch.launch.mesh import mesh_from_spec, mesh_shape
from repro_torch.launch.steps import build_step
from repro_torch.models.runtime import unroll_scans

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build"
H100_HBM_BYTES = 80e9           # H100 SXM: 80 GB of HBM3 (data sheet)
_INT32_BYTES = 4                # the cache's ``pos``: a 0-d int32 in the reference


def default_microbatches(shape) -> int:
    return max(1, shape.global_batch // 64) if shape.kind == "train" else 1


def model_flops_per_chip(cfg, shape, n_devices: int) -> float:
    """6*N*D train (fwd+bwd), 2*N*D inference; N = active params."""
    n_active = models.n_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def cell_id(arch: str, shape: str, mesh: str, variant: str = "base") -> str:
    return f"{arch}|{shape}|{mesh}|{variant}"


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return (
            "pure full-attention arch: 524k-token context requires a "
            "quadratic prefill it does not claim (DESIGN.md §4)"
        )
    return None


# ------------------------------------------------------------ abstract run
def fake_group(n: int) -> None:
    """A fake process group of ``n`` ranks (this process rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def dryrun_mesh(spec: str):
    """The cell's mesh on the CPU, over a fake group of its size."""
    shape, _ = mesh_shape(spec)
    fake_group(int(np.prod(shape)))
    return mesh_from_spec(spec, "cpu")


@contextlib.contextmanager
def _offsets_off_fake():
    """DTensor computes a shard's offsets (a strided shard's, and the global
    index an argmax over a sharded axis returns) with small index tensors;
    under ``FakeTensorMode`` those would be fake and their values
    unreadable, so those computations run on real tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor.placement_types import _StridedShard

    def real(fn):
        def wrapped(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        return wrapped

    targets = [(o, n) for o, n in ((_StridedShard, "local_shard_size_and_offset"),
                                   (_utils, "_compute_local_shape_and_global_offset"))
               if hasattr(o, n)]
    saved = [(o, n, getattr(o, n)) for o, n in targets]
    for o, n, fn in saved:
        setattr(o, n, real(fn))
    try:
        yield
    finally:
        for o, n, fn in saved:
            setattr(o, n, fn)


def _local_shape(shape, placements, mesh) -> list[int]:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return out


def _abstract(meta, placements, mesh):
    """A DTensor at ``placements`` whose local shard is a fake tensor (call
    under FakeTensorMode)."""
    import torch
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(meta.shape, placements, mesh), dtype=meta.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _tree(args, shardings, mesh, ints: bool):
    out = {}
    for k, v in args.items():
        if isinstance(v, dict):
            out[k] = _tree(v, shardings[k], mesh, ints)
        elif ints and v.dim() == 0 and k == "pos":
            out[k] = 0                       # the port's cache holds pos as an int
        else:
            out[k] = _abstract(v, shardings[k], mesh)
    return out


def _local_bytes(x) -> int:
    """Bytes one device holds of ``x`` (a tree of DTensors, tensors, and
    the int ``pos``, the reference's 0-d int32)."""
    import torch

    if isinstance(x, dict):
        return sum(_local_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_local_bytes(v) for v in x)
    if isinstance(x, int):
        return _INT32_BYTES
    if isinstance(x, torch.Tensor):
        t = x.to_local() if hasattr(x, "to_local") else x
        return t.numel() * t.element_size()
    return 0


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def abstract_args(bundle, mesh) -> tuple:
    """The step's arguments as abstract DTensors (under FakeTensorMode)."""
    sh = bundle.shardings
    if bundle.kind == "train":          # trainable leaves, as a trainer's
        params = {n: t.requires_grad_()
                  for n, t in _tree(bundle.args[0], sh["params"], mesh, False).items()}
        return (params,
                _tree(bundle.args[1], sh["opt"], mesh, False),
                _tree(bundle.args[2], sh["inputs"], mesh, False))
    if bundle.kind == "prefill":
        return (_tree(bundle.args[0], sh["params"], mesh, False),
                _tree(bundle.args[1], sh["inputs"], mesh, False))
    return (_tree(bundle.args[0], sh["params"], mesh, False),
            _tree(bundle.args[1], sh["inputs"]["cache"], mesh, True),
            _abstract(bundle.args[2], sh["inputs"]["tokens"], mesh))


def trace_step(bundle, mesh) -> tuple[StepTrace, dict]:
    """Run ``bundle.jitted`` once on abstract arguments under a
    ``StepTrace``; returns the trace and the memory analysis."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake, _offsets_off_fake():
        args = abstract_args(bundle, mesh)
        arg_bytes = _local_bytes(args)
        if bundle.kind != "train":
            grad = torch.no_grad()
        else:
            grad = contextlib.nullcontext()
        with grad, StepTrace() as trace:
            out = bundle.jitted(*args)
        ins = {id(t) for t in _leaves(args) if isinstance(t, torch.Tensor)}
        alias = sum(_local_bytes(t) for t in _leaves(out)
                    if isinstance(t, torch.Tensor) and id(t) in ins)
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": _local_bytes(out),
               "alias_size_in_bytes": alias,
               "temp_size_in_bytes": trace.peak_bytes}
        del out, args
    return trace, mem


# ------------------------------------------------------------------ cells
def run_cell(
    arch: str,
    shape_name: str,
    mesh_spec: str,
    *,
    num_microbatches: int | None = None,
    impl: str = "chunked",
    variant: str = "base",
    rules: ShardingRules | None = None,
    overrides: dict | None = None,
) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = get_shape(shape_name)
    rec: dict = {
        "cell": cell_id(arch, shape_name, mesh_spec, variant),
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_spec,
        "variant": variant,
        "kind": shape.kind,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec

    mesh = dryrun_mesh(mesh_spec)
    n_dev = mesh.size()
    nm = num_microbatches or default_microbatches(shape)
    rec["num_microbatches"] = nm
    t0 = time.perf_counter()
    try:
        bundle = build_step(cfg, shape, mesh, num_microbatches=nm, impl=impl, rules=rules)
        trace, mem = trace_step(bundle, mesh)
        t_trace = time.perf_counter() - t0
        print(f"[memory_analysis] {rec['cell']}: {mem}")
        flops, hbm = cost_analysis_terms(trace)
        coll = collective_stats(trace)
        roof = Roofline(
            flops=flops,
            hbm_bytes=hbm,
            coll_bytes=coll.total_bytes,
            model_flops=model_flops_per_chip(cfg, shape, n_dev),
        )
        print(
            f"[cost_analysis] {rec['cell']}: flops/chip={flops:.3e} "
            f"bytes/chip={hbm:.3e} coll_bytes/chip={coll.total_bytes:.3e}"
        )
        rec.update(
            status="ok",
            n_devices=n_dev,
            trace_s=round(t_trace, 2),
            memory_analysis=mem,
            fits_h100_80gb=(mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                            <= H100_HBM_BYTES),
            roofline=roof.to_json(),
            collectives={
                "count": coll.count,
                "by_op": coll.by_op,
                "schedule_head": coll.schedule[:16],
            },
            traced_ops=trace.ops,
        )
        del trace, bundle
    except Exception as e:  # a failing cell is a bug — record loudly
        rec.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-2000:],
        )
    gc.collect()
    return rec


def cost_samples(cfg):
    """Sample configs + layer-type count vectors for affine extrapolation,
    the reference's: each family's costs are affine in its per-layer-type
    counts, so small-depth traces solve for the coefficients."""
    if cfg.family == "audio" and cfg.is_encdec:
        mk = lambda e, d: cfg.replace(encoder_layers=e, num_layers=d)
        samples = [
            (mk(1, 1), (1, 1)),
            (mk(2, 1), (2, 1)),
            (mk(1, 2), (1, 2)),
        ]
        full = (cfg.encoder_layers, cfg.num_layers)
    elif cfg.family == "hybrid":
        mk = lambda L: cfg.replace(num_layers=L)
        inv = lambda L: (L + cfg.attn_every - 1) // cfg.attn_every
        Ls = [1, 2, cfg.attn_every + 1]
        samples = [(mk(L), (L, inv(L))) for L in Ls]
        full = (cfg.num_layers, inv(cfg.num_layers))
    elif cfg.sliding_window and cfg.global_every:
        from repro_torch.models.transformer import _layer_windows

        mk = lambda L: cfg.replace(num_layers=L)
        counts = lambda c: (
            sum(1 for w in _layer_windows(c) if w > 0),
            sum(1 for w in _layer_windows(c) if w == 0),
        )
        Ls = [1, 2, cfg.global_every]
        samples = [(mk(L), counts(mk(L))) for L in Ls]
        full = counts(cfg)
    else:
        mk = lambda L: cfg.replace(num_layers=L)
        samples = [(mk(1), (1,)), (mk(2), (2,))]
        full = (cfg.num_layers,)
    return samples, full


def probe_impl(shape) -> str:
    """The attention the probes trace: naive for train and prefill, as the
    reference's probes lower."""
    return "naive" if shape.kind in ("train", "prefill") else "chunked"


def run_cost_probe(
    arch: str,
    shape_name: str,
    mesh_spec: str,
    *,
    rules: ShardingRules | None = None,
    overrides: dict | None = None,
) -> dict:
    """Roofline terms via small-depth traces + an affine solve."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = get_shape(shape_name)
    mesh = dryrun_mesh(mesh_spec)
    n_dev = mesh.size()
    samples, full = cost_samples(cfg)
    impl = probe_impl(shape)

    rows, ys = [], []
    probe_info = []
    for cfg_s, counts in samples:
        t0 = time.perf_counter()
        bundle = build_step(cfg_s, shape, mesh, num_microbatches=1, impl=impl,
                            rules=rules)
        with unroll_scans():
            trace, _ = trace_step(bundle, mesh)
        flops, hbm = cost_analysis_terms(trace)
        coll = collective_stats(trace).total_bytes
        rows.append([1.0, *[float(c) for c in counts]])
        ys.append([flops, hbm, float(coll)])
        probe_info.append(
            {"counts": list(counts), "flops": flops, "hbm": hbm,
             "coll": coll, "s": round(time.perf_counter() - t0, 1)}
        )
        del trace, bundle
        gc.collect()

    A = np.asarray(rows)
    Y = np.asarray(ys)
    coef, *_ = np.linalg.lstsq(A, Y, rcond=None)
    full_row = np.asarray([1.0, *[float(c) for c in full]])
    est = np.maximum(full_row @ coef, 0.0)
    roof = Roofline(
        flops=float(est[0]),
        hbm_bytes=float(est[1]),
        coll_bytes=float(est[2]),
        model_flops=model_flops_per_chip(cfg, shape, n_dev),
    )
    return {"roofline": roof.to_json(), "probes": probe_info,
            "full_counts": list(full)}


def load_cache(path: Path) -> dict[str, dict]:
    cache = {}
    if path.exists():
        for line in path.read_text().splitlines():
            if line.strip():
                r = json.loads(line)
                cache[r["cell"]] = r
    return cache


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", default="pod", help="pod | multipod | AxB[xC]")
    ap.add_argument("--all", action="store_true", help="sweep all 40 cells")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=None, help="JSONL cache (resume-safe)")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    ap.add_argument(
        "--probe",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="run small-depth cost probes (default: on for --mesh pod)",
    )
    ap.add_argument(
        "--rules", default="default",
        help="sharding rule set: default | long | decode_seq | decode_tp | decode_2d_tp",
    )
    ap.add_argument(
        "--override", action="append", default=[],
        help="config override key=value (int/float), e.g. ssm_chunk=64",
    )
    args = ap.parse_args(argv)
    do_probe = args.probe if args.probe is not None else (args.mesh == "pod")

    rules = RULESETS[args.rules]()
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                overrides[k] = v
    if (args.rules != "default" or overrides) and args.variant == "base":
        args.variant = args.rules + (
            "+" + ",".join(f"{k}{v}" for k, v in overrides.items())
            if overrides
            else ""
        )

    out = Path(args.out) if args.out else RESULTS_DIR / "dryrun_torch.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    cache = {} if args.force else load_cache(out)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        cid = cell_id(arch, shape, args.mesh, args.variant)
        cached = cache.get(cid)
        need_probe = do_probe and not (cached or {}).get("cost_probe")
        if cached and cached["status"] == "ok" and not need_probe:
            rec = cached
            print(f"[cached] {cid}: {rec['status']}")
        elif cached and cached["status"] == "skipped":
            rec = cached
            print(f"[cached] {cid}: skipped")
        else:
            if cached and cached["status"] == "ok":
                rec = cached  # base ok; only the probe is missing
            else:
                rec = run_cell(
                    arch, shape, args.mesh,
                    num_microbatches=args.microbatches, impl=args.impl,
                    variant=args.variant, rules=rules, overrides=overrides,
                )
            if do_probe and rec["status"] == "ok":
                try:
                    rec["cost_probe"] = run_cost_probe(
                        arch, shape, args.mesh, rules=rules, overrides=overrides,
                    )
                    r = rec["cost_probe"]["roofline"]
                    print(
                        f"[probe] {cid}: flops/chip={r['flops']:.3e} "
                        f"dominant={r['dominant']} "
                        f"useful={r['useful_flops_frac']:.2f}"
                    )
                except Exception as e:
                    rec["cost_probe"] = {"error": f"{type(e).__name__}: {e}"}
                    print(f"[probe ERROR] {cid}: {e}")
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        if rec["status"] == "ok":
            n_ok += 1
            r = rec["roofline"]
            print(
                f"[ok] {cid}: dominant={r['dominant']} "
                f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                f"collective={r['collective_s']:.4f}s "
                f"useful={r['useful_flops_frac']:.2f} "
                f"fits_h100_80gb={rec['fits_h100_80gb']} (trace {rec['trace_s']}s)"
            )
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[skip] {cid}: {rec['reason']}")
        else:
            n_err += 1
            print(f"[ERROR] {cid}: {rec['error']}")
    print(f"\ndry-run summary: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
