"""One rank of a multi-process check of the port's multi-device layer, on
the CPU over gloo. ``tests/test_torch_dist.py`` starts ``WORLD_SIZE`` of
these with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
set, reads what rank 0 writes, and holds it against the reference.
It imports torch and the port only (no JAX):

    python tests/torch_dist_worker.py CASE INPUTS.pt OUT.pt [ARG ...]

Cases: ``steps`` (``build_step``'s train, prefill and decode steps on a
mesh of the smoke config, changed by ``inputs["overrides"]`` where given,
with each loss's local logits shape where it took the vocabulary-parallel
path and each MoE expert product's local buffer shape; on a one-device
mesh also the meshless steps in this process),
``greedy`` (a prefill and a greedy decode step at batch 1 on a mesh that
shards the vocabulary, for several weight sets), ``trainer`` (the
``Trainer`` on a mesh), ``trainer_local`` (a meshless ``Trainer`` and one
on a 1x1 mesh over one world), ``int8`` (``int8_allreduce_mean``),
``norm`` (``adamw_update``'s global norm over sharded gradients).
"""

from __future__ import annotations

import logging
import os
import sys
import warnings

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.launch.steps import build_step, make_decode_fn, make_prefill_fn, make_train_fn
from repro_torch.models import common, moe
from repro_torch.optim import OptConfig, adamw_update, init_opt_state

DECODE_STEPS = 4


def _opt(kw: dict) -> OptConfig:
    return OptConfig(**kw)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _prompt(batch: dict) -> dict:
    """A prefill's inputs from a train batch: the tokens, and an
    encoder-decoder's frames."""
    return {k: v for k, v in batch.items() if k in ("tokens", "frames")}


def _meshless(cfg, inp):
    """The port's meshless train, prefill and decode on the same inputs."""
    specs = models.param_specs(cfg)
    params = {n: t.requires_grad_() for n, t in
              params_from_numpy(inp["params"], specs, device="cpu").items()}
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    p, _, metrics = make_train_fn(cfg, _opt(inp["opt"]))(params, init_opt_state(params), batch)
    out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
           "params": {n: t.detach() for n, t in p.items()}}
    plain = params_from_numpy(inp["params"], specs, device="cpu")
    with torch.no_grad():
        logits, cache = make_prefill_fn(cfg, impl="kernel")(plain, _prompt(batch))
        out["logits"] = logits
        tok, toks = torch.argmax(logits[:, -1:], -1).to(torch.int32), []
        dec = make_decode_fn(cfg)
        for _ in range(DECODE_STEPS):
            tok, cache = dec(plain, cache, tok)
            toks.append(tok)
    out["tokens"] = torch.cat(toks, 1)
    return out


def case_steps(inp, arch, spec):
    cfg = get_config(arch, smoke=True).replace(**inp.get("overrides", {}))
    mesh = mesh_from_spec(spec, "cpu")
    specs = models.param_specs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    B, S = batch["tokens"].shape
    train = build_step(cfg, ShapeConfig("t", S, B, "train"), mesh, opt_cfg=_opt(inp["opt"]))
    params = params_from_numpy(inp["params"], specs, device="cpu")
    vocab_parallel = common.vocab_parallel_nll
    calls = []

    def spy(logits, labels):
        calls.append(tuple(logits.to_local().shape))
        return vocab_parallel(logits, labels)

    experts, buffers = moe.experts, []

    def expert_spy(buf, *w):
        buffers.append(tuple(buf.to_local().shape))
        return experts(buf, *w)

    common.vocab_parallel_nll, moe.experts = spy, expert_spy
    try:
        p, _, metrics = train.jitted(params, init_opt_state(params), batch)
    finally:
        common.vocab_parallel_nll, moe.experts = vocab_parallel, experts
    out = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
           "params": {n: _full(t).detach() for n, t in p.items()},
           "placements": {n: [str(x) for x in t.placements] for n, t in p.items()},
           "vocab_parallel_shards": calls, "expert_shards": buffers}
    plain = params_from_numpy(inp["params"], specs, device="cpu")
    with torch.no_grad():
        prefill = build_step(cfg, ShapeConfig("p", S, B, "prefill"), mesh, impl="kernel")
        logits, cache = prefill.jitted(plain, _prompt(batch))
        out["logits"] = _full(logits)
        out["cache_placements"] = {n: [str(x) for x in t.placements]
                                   for n, t in cache.items() if hasattr(t, "placements")}
        decode = build_step(cfg, ShapeConfig("d", S, B, "decode"), mesh)
        tok, toks = torch.argmax(out["logits"][:, -1:], -1).to(torch.int32), []
        for _ in range(DECODE_STEPS):
            tok, cache = decode.jitted(plain, cache, tok)
            toks.append(_full(tok))
    out["tokens"] = torch.cat(toks, 1)
    if mesh.size() == 1:
        out["meshless"] = _meshless(cfg, inp)
    return out


def case_greedy(inp, arch, spec):
    """For each weight set in ``inp["params"]``: ``build_step``'s prefill of
    the prompt at batch 1, its greedy token from the gathered logits, then
    one decode step, whose token is the argmax over logits the mesh's
    "model" axis shards. Returns the decode tokens and the placements of
    the decode's logits."""
    cfg = get_config(arch, smoke=True)
    mesh = mesh_from_spec(spec, "cpu")
    specs = models.param_specs(cfg)
    prompt = torch.from_numpy(inp["tokens"])
    B, S = prompt.shape
    prefill = build_step(cfg, ShapeConfig("p", S, B, "prefill"), mesh, impl="kernel")
    decode = build_step(cfg, ShapeConfig("d", S, B, "decode"), mesh)
    seen = []
    models_decode = models.decode_step

    def spy(*a, **k):                    # the placements argmax reduces over
        logits, cache = models_decode(*a, **k)
        seen.append([str(x) for x in logits.placements])
        return logits, cache

    toks = []
    with torch.no_grad():
        for weights in inp["params"]:
            plain = params_from_numpy(weights, specs, device="cpu")
            logits, cache = prefill.jitted(plain, {"tokens": prompt})
            tok = torch.argmax(_full(logits)[:, -1:], -1).to(torch.int32)
            models.decode_step = spy
            try:
                tok, _ = decode.jitted(plain, cache, tok)
            finally:
                models.decode_step = models_decode
            toks.append(_full(tok))
    return {"tokens": torch.cat(toks, 0), "logit_placements": seen}


def case_trainer(inp, arch, spec, registry, fail_at):
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(arch, smoke=True)
    B, S = inp["shape"]
    tcfg = TrainConfig(steps=inp["steps"], checkpoint_every=inp["checkpoint_every"],
                       fail_at_step=int(fail_at), opt=_opt(inp["opt"]))
    class Recording(Trainer):
        """Each start's local state addresses (the compiled step's shards)."""

        def _startup(self):
            out = super()._startup()
            self.ptrs.append([p.to_local().data_ptr() for p in out[0].values()])
            return out

    tr = Recording(registry, cfg, ShapeConfig("t", S, B, "train"), tcfg, device="cpu",
                   mesh=mesh_from_spec(spec, "cpu"))
    tr.ptrs = []
    tr.publish(inp["params"])
    res = tr.run()
    return {"losses": res.losses, "steps_done": res.steps_done, "restarts": res.restarts,
            "checkpoint_saves": res.checkpoint_saves,
            "resume_steps": [s["resume_step"] for s in res.startup_stats],
            "compile_sources": [s["compile_source"] for s in res.startup_stats],
            "compiled_as": sorted({s["compiled_as"] for s in res.startup_stats}),
            "same_state": all(p == tr.ptrs[0] for p in tr.ptrs)}


def case_trainer_local(inp, arch, registry):
    """A meshless ``Trainer`` and one on a 1x1 mesh over one published
    world: both losses, and whether the mesh run's params are DTensors
    over views of its arena that hold the trained values."""
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(arch, smoke=True)
    B, S = inp["shape"]
    tcfg = TrainConfig(steps=inp["steps"], checkpoint_every=10**9, opt=_opt(inp["opt"]))
    shape = ShapeConfig("t", S, B, "train")
    out = {}
    for name, mesh in (("meshless", None), ("mesh", mesh_from_spec("1x1", "cpu"))):
        tr = Trainer(registry, cfg, shape, tcfg, device="cpu", mesh=mesh)
        if mesh is None:
            tr.publish(inp["params"])
        out[name] = tr.run().losses
    arena = tr.image.arena
    lo, hi = arena.data_ptr(), arena.data_ptr() + arena.numel()
    out["views"] = all(lo <= p.to_local().data_ptr() < hi for p in tr.params.values())
    slot = tr.image.table.slots()["final_norm/scale"]
    out["in_place"] = torch.equal(
        arena[slot.offset:slot.offset + slot.nbytes],
        tr.params["final_norm/scale"].to_local().detach().reshape(-1).view(torch.uint8))
    return out


def case_int8(inp):
    from repro_torch.dist.compression import int8_allreduce_mean

    x = torch.from_numpy(inp["x"][dist.get_rank()])
    return {"mean": int8_allreduce_mean(x)}


def case_norm(inp, spec):
    """Gradients of several placements (sharded on either mesh axis, on
    both, replicated): ``adamw_update``'s global norm and updated params."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_from_spec(spec, "cpu")
    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    layouts = [(S0, S1), (S1, R), (R, S0), (R, R)]
    params, grads = {}, {}
    for i, pl in enumerate(layouts):
        params[f"p{i}"] = distribute_tensor(torch.from_numpy(inp["p"][i]), mesh, pl,
                                            src_data_rank=None)
        grads[f"p{i}"] = distribute_tensor(torch.from_numpy(inp["g"][i]), mesh, pl,
                                           src_data_rank=None)
    state = {"m": {n: torch.zeros_like(p) for n, p in params.items()},
             "v": {n: torch.zeros_like(p) for n, p in params.items()},
             "step": distribute_tensor(torch.zeros((), dtype=torch.int32), mesh, [R, R])}
    with torch.no_grad():
        p, _, metrics = adamw_update(params, grads, state, _opt(inp["opt"]))
    return {"grad_norm": _full(metrics["grad_norm"]),
            "params": {n: _full(t) for n, t in p.items()}}


CASES = {"steps": case_steps, "greedy": case_greedy, "trainer": case_trainer,
         "trainer_local": case_trainer_local, "int8": case_int8, "norm": case_norm}


def main() -> None:
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    case, inputs, out_path, *args = sys.argv[1:]
    dist.init_process_group("gloo", init_method="env://")
    try:
        out = CASES[case](torch.load(inputs, weights_only=False), *args)
        if dist.get_rank() == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
