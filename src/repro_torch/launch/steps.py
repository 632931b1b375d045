"""Step functions shared by the trainer, the server and the dry-run, the
port of the reference's ``launch/steps.py``.

Everything a cell (arch x shape x mesh) needs to run:

    build_step(cfg, shape, mesh, ...) -> StepBundle with
        fn          — the step (python callable) under the mesh's sharding
                      context (``_with_ctx``)
        jitted      — ``fn`` with its inputs placed: each tensor becomes a
                      DTensor at its sharding (``distribute_tensor``, or a
                      ``redistribute`` of a DTensor placed otherwise), and
                      the outputs are placed as the reference's
                      ``out_shardings`` place them
        args        — meta tensors of every input, the reference's
                      ``ShapeDtypeStruct`` pytree
        shardings   — DTensor placements (one per mesh dimension) for the
                      params, the optimizer state and the inputs

The training step (``make_train_fn``) takes the loss and its gradients
with autograd's backward where the reference takes ``jax.value_and_grad``,
accumulates microbatches in float32 and divides by their count, then runs
``adamw_update``. The step runs eagerly (there is no ``jax.jit``): the
name ``jitted`` is kept so a reader finds the reference's counterpart,
and the trainer compiles it by capturing it in a CUDA graph
(``train/program.py``). ``place_state`` places a train step's state at
its shardings once, so the step places nothing and trains it in place.
Inside ``fn`` a plain tensor meeting a DTensor (a mask, a position) is
taken as replicated (``implicit_replication``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import models
from repro_torch.dist.context import is_dtensor, mesh_rules
from repro_torch.dist.sharding import ShardingRules, placements_for, spec_for
from repro_torch.optim import OptConfig, adamw_update


# ----------------------------------------------------------------- shardings
def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def param_shardings(cfg, mesh, rules: Optional[ShardingRules] = None) -> dict:
    """{param name: placements} from its logical axes."""
    specs = models.param_specs(cfg)
    return {
        n: placements_for(spec_for(s.axes, s.shape, mesh, rules), mesh)
        for n, s in specs.items()
    }


def opt_shardings(cfg, mesh, rules: Optional[ShardingRules] = None) -> dict:
    """Each moment beside its parameter's shard; the step replicated."""
    ps = param_shardings(cfg, mesh, rules)
    return {"m": ps, "v": ps, "step": _replicated(mesh)}


def input_shardings(cfg, shape, mesh, rules: Optional[ShardingRules] = None) -> dict:
    specs = models.input_specs(cfg, shape)
    axes = models.input_axes(cfg, shape)

    def resolve(spec_leaf, ax_leaf):
        return placements_for(spec_for(ax_leaf, spec_leaf.shape, mesh, rules), mesh)

    out: dict = {}
    for k, v in specs.items():
        if isinstance(v, dict):  # cache
            out[k] = {n: resolve(v[n], axes[k][n]) for n in v}
        else:
            out[k] = resolve(v, axes[k])
    return out


def cache_shardings(cfg, batch: int, seq_len: int, mesh,
                    rules: Optional[ShardingRules] = None) -> dict:
    shapes, axes = models.cache_spec(cfg, batch, seq_len)
    return {n: placements_for(spec_for(axes[n], shapes[n][0], mesh, rules), mesh)
            for n in axes}


def abstract_opt(cfg) -> dict:
    specs = models.param_specs(cfg)
    m = {n: torch.empty(s.shape, dtype=torch.float32, device="meta")
         for n, s in specs.items()}
    return {"m": m, "v": dict(m),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


# --------------------------------------------------------------- placement
def place(x, mesh, placements):
    """``x`` as a DTensor at ``placements``: a plain tensor (the same
    global value on every rank, as a device_put of a host array is) is
    cut to this rank's shard without communication, a DTensor is
    redistributed where it is placed otherwise; anything else (a Python
    int ``pos``) passes through."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(mesh, placements)
    if isinstance(x, torch.Tensor):
        return distribute_tensor(x, mesh, placements, src_data_rank=None)
    return x


def place_tree(tree, mesh, shardings):
    """``place`` over a dict (nested one level, as a cache in inputs)."""
    out = {}
    for k, v in tree.items():
        sh = shardings.get(k)
        if isinstance(v, dict):
            out[k] = place_tree(v, mesh, sh or {})
        elif sh is None:
            out[k] = v
        else:
            out[k] = place(v, mesh, sh)
    return out


def place_state(params: dict, opt_state: dict, shardings: dict, mesh):
    """A train step's state (whole tensors, the same on every rank) as
    DTensors at the step's shardings (``StepBundle.shardings``): on a mesh
    of one device the tensors themselves, wrapped (``DTensor.from_local``,
    no copy: a view of a device arena stays one); otherwise each rank's
    shard, copied (``distribute_tensor``). Params become leaves that
    require grad. The placements are the step's own, so ``jitted`` places
    nothing and trains the state in place."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if mesh.size() == 1:
        wrap = lambda t, pl: DTensor.from_local(t.detach(), mesh, pl, run_check=False)
    else:
        wrap = lambda t, pl: distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    p_sh, o_sh = shardings["params"], shardings["opt"]
    params = {n: wrap(t, p_sh[n]).requires_grad_() for n, t in params.items()}
    opt_state = {
        "m": {n: wrap(t, o_sh["m"][n]) for n, t in opt_state["m"].items()},
        "v": {n: wrap(t, o_sh["v"][n]) for n, t in opt_state["v"].items()},
        "step": wrap(opt_state["step"], o_sh["step"]),
    }
    return params, opt_state


# -------------------------------------------------------------------- steps
@dataclass
class StepBundle:
    kind: str
    fn: Any
    jitted: Any
    args: tuple
    shardings: dict


def _grads(loss, params: dict) -> dict:
    """d loss / d each param; a param the loss never reads gets zeros, as
    under ``jax.grad``."""
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                            materialize_grads=True)
    return dict(zip(params, g))


def make_train_fn(cfg, opt_cfg: OptConfig, *, num_microbatches: int = 1,
                  impl: str = "chunked"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``. ``params`` are tensors that require
    grad; they, the moments and the step are updated in place
    (``adamw_update``). Microbatch i is rows [i*mb, (i+1)*mb) of the batch,
    as the reference's reshape gives it. The metrics are 0-d tensors on the
    params' device."""

    def loss_on(params, batch):
        return models.loss_fn(cfg, params, batch, impl=impl)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            mb = batch["tokens"].shape[0] // num_microbatches
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            losses = []
            for i in range(num_microbatches):
                b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss = loss_on(params, b)
                for n, g in _grads(loss, params).items():
                    grads[n].add_(g.float())
                losses.append(loss.detach())
            grads = {n: g / num_microbatches for n, g in grads.items()}
            loss = torch.stack(losses).mean()
        else:
            loss = loss_on(params, batch)
            grads = _grads(loss, params)
            loss = loss.detach()
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_fn(cfg, *, impl: str = "chunked"):
    def prefill_step(params, batch):
        logits, cache = models.prefill(cfg, params, batch, impl=impl)
        return logits, cache

    return prefill_step


def greedy_token(logits):
    """The argmax over the last axis, the lowest index among ties, as
    ``jnp.argmax``. On a DTensor it is a max and then a min over the
    vocabulary, each reduced as a partial max / min over the mesh axes
    that shard it. (DTensor's own argmax all-gathers each shard's winner
    and fails at batch 1: its gathered result does not fit the view it
    takes.)"""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    vocab = logits.shape[-1]
    top = logits.amax(dim=-1, keepdim=True)
    ids = torch.arange(vocab, device=logits.device)
    return torch.where(logits == top, ids, vocab).amin(dim=-1)


def make_decode_fn(cfg):
    def serve_step(params, cache, tokens):
        logits, cache = models.decode_step(cfg, params, cache, tokens)
        next_tok = greedy_token(logits[:, -1:]).to(torch.int32)
        return next_tok, cache

    return serve_step


def _with_ctx(fn, mesh, rules):
    """Install the logical-sharding context for the duration of the step
    (the models' ``constrain`` calls resolve against this mesh+rules); a
    plain tensor that meets a DTensor inside it is taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with mesh_rules(mesh, rules), implicit_replication():
            return fn(*a, **k)

    return wrapped


def _trainable(params: dict) -> dict:
    """Leaves that require grad: a DTensor the caller placed (a trainer's,
    trained in place) keeps its identity."""
    return {n: (p if p.requires_grad else p.detach().requires_grad_())
            for n, p in params.items()}


def default_rules(cfg, shape) -> Optional[ShardingRules]:
    """The reference's default rule choice: ``long`` for long_500k, the
    flash-decode cache sharding (``decode_seq``: the cache sequence axis
    over "data") for GQA decode shapes, else the default rules (None)."""
    if shape.name == "long_500k":
        return ShardingRules.long_context()
    if shape.kind == "decode" and 0 < cfg.num_kv_heads < cfg.num_heads:
        return ShardingRules.decode_seq()
    return None


def build_step(
    cfg,
    shape,
    mesh,
    *,
    rules: Optional[ShardingRules] = None,
    opt_cfg: Optional[OptConfig] = None,
    num_microbatches: int = 1,
    impl: str = "chunked",
) -> StepBundle:
    """Build the placed step for one (arch x shape) cell on ``mesh``."""
    if rules is None:
        rules = default_rules(cfg, shape)
    p_sh = param_shardings(cfg, mesh, rules)
    in_sh = input_shardings(cfg, shape, mesh, rules)
    p_abs = models.abstract(cfg)
    in_abs = models.input_specs(cfg, shape)
    repl = _replicated(mesh)

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig()
        fn = _with_ctx(
            make_train_fn(cfg, opt_cfg, num_microbatches=num_microbatches, impl=impl),
            mesh, rules,
        )
        o_sh = opt_shardings(cfg, mesh, rules)

        def jitted(params, opt_state, batch):
            # state placed by ``place_state`` passes through unchanged, so
            # the step can be captured in a CUDA graph (train/program.py):
            # each op here is host-side or a kernel, none reads a value back
            params = _trainable(place_tree(params, mesh, p_sh))
            opt_state = place_tree(opt_state, mesh, o_sh)
            batch = place_tree(batch, mesh, in_sh)
            params, opt_state, metrics = fn(params, opt_state, batch)
            # replicated metrics, as plain tensors: the same on every rank
            return params, opt_state, {k: v.full_tensor() if is_dtensor(v) else v
                                       for k, v in metrics.items()}

        args = (p_abs, abstract_opt(cfg), in_abs)
        return StepBundle("train", fn, jitted, args,
                          {"params": p_sh, "opt": o_sh, "inputs": in_sh})

    if shape.kind == "prefill":
        fn = _with_ctx(make_prefill_fn(cfg, impl=impl), mesh, rules)
        cache_sh = cache_shardings(cfg, shape.global_batch, shape.seq_len, mesh, rules)

        def jitted(params, batch):
            logits, cache = fn(place_tree(params, mesh, p_sh),
                               place_tree(batch, mesh, in_sh))
            return place(logits, mesh, repl), place_tree(cache, mesh, cache_sh)

        args = (p_abs, in_abs)
        return StepBundle("prefill", fn, jitted, args,
                          {"params": p_sh, "inputs": in_sh, "cache": cache_sh})

    # decode
    fn = _with_ctx(make_decode_fn(cfg), mesh, rules)
    cache_sh = in_sh["cache"]
    tok_sh = in_sh["tokens"]

    def jitted(params, cache, tokens):
        next_tok, cache = fn(place_tree(params, mesh, p_sh),
                             place_tree(cache, mesh, cache_sh),
                             place(tokens, mesh, tok_sh))
        return place(next_tok, mesh, repl), place_tree(cache, mesh, cache_sh)

    args = (p_abs, in_abs["cache"], in_abs["tokens"])
    return StepBundle("decode", fn, jitted, args,
                      {"params": p_sh, "inputs": in_sh})
