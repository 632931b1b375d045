"""Mamba2 — SSD (state-space duality) blocks [arXiv:2405.21060], the port of
the reference's ``models/mamba2.py`` on torch tensors, in the same layouts.

Prefill runs the chunked SSD algorithm (quadratic within ``ssm_chunk``-sized
chunks, recurrent across chunks); decode is the O(1)-per-token recurrence.

Layer layout (per block, stacked on L):
    norm -> in_proj -> [z | x | B | C | dt] -> causal depthwise conv (x,B,C)
         -> SSD -> +D*x -> gated RMSNorm(silu(z)) -> out_proj

``ssd``, the conv and the projections are plain torch (the reference leaves
them to XLA too); both norms of a block go through ``kernels.rmsnorm``.
Where the reference multiplies bf16 operands with
``preferred_element_type=f32``, the port upcasts the operands to float32
(exact for bf16 values) and multiplies in float32; the decay chains are
float32 throughout.

Departures from the reference that do not change results:

* the layer stack is a plain Python loop (the reference's ``lax.scan``),
  each layer under the config's remat policy while autograd records;
* ``decode_step`` writes the conv and SSM states into the cache IN PLACE
  and returns a dict holding the same, updated tensors;
* the cache's ``pos`` is a Python int, or a tuple of ints, one per batch
  row (the slot scheduler's form); nothing here reads it, it counts tokens.

The reference's sharding hints (``constrain``) stand at its points: the
block's input and weights, and the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.context import constrain

from .common import cache_device, cross_entropy, placed_like, rms_norm
from .runtime import remat_wrap
from .specs import ParamSpec, torch_dtype

NEG_INF = -(2.0**30)


# --------------------------------------------------------------------------
# dims and specs
# --------------------------------------------------------------------------
def dims(cfg):
    d_inner = cfg.ssm_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    G = cfg.ssm_groups
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, H, P, G, N, conv_ch, d_in_proj


def block_specs(cfg) -> dict[str, ParamSpec]:
    d = cfg.d_model
    dt = cfg.dtype
    d_inner, H, P, G, N, conv_ch, d_in_proj = dims(cfg)
    return {
        "norm/scale": ParamSpec((d,), dt, ("embed",), "ones"),
        "in_proj/w": ParamSpec((d, d_in_proj), dt, ("embed", "ssm_inner"), "fan_in"),
        "conv/w": ParamSpec((cfg.ssm_conv, conv_ch), dt,
                            ("conv_kernel", "ssm_inner"), "normal"),
        "conv/b": ParamSpec((conv_ch,), dt, ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((H,), "float32", ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((H,), "float32", ("ssm_heads",), "zeros"),
        "D": ParamSpec((H,), "float32", ("ssm_heads",), "ones"),
        "gate_norm/scale": ParamSpec((d_inner,), dt, ("ssm_inner",), "ones"),
        "out_proj/w": ParamSpec((d_inner, d), dt, ("ssm_inner", "embed"), "fan_in"),
    }


def stacked_specs(cfg) -> dict[str, ParamSpec]:
    """``block_specs`` stacked on a leading layers axis, as ``blocks/*``."""
    return {
        f"blocks/{n}": ParamSpec(
            (cfg.num_layers,) + s.shape, s.dtype, ("layers",) + s.axes, s.init
        )
        for n, s in block_specs(cfg).items()
    }


def param_specs(cfg) -> dict[str, ParamSpec]:
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    specs = {"embed/tokens": ParamSpec((V, d), dt, ("vocab", "embed"), "normal")}
    specs.update(stacked_specs(cfg))
    specs["final_norm/scale"] = ParamSpec((d,), dt, ("embed",), "ones")
    if not cfg.tie_embeddings:
        specs["lm_head/w"] = ParamSpec((d, V), dt, ("embed", "vocab"), "fan_in")
    return specs


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
class _Cumsum(torch.autograd.Function):
    """``torch.cumsum`` over the last axis, its gradient the reversed
    cumulative sum that autograd takes, with the reversal an
    ``index_select`` rather than ``flip`` (torch 2.11's DTensor has no
    strategy for ``flip``): the same values, on a mesh too."""

    @staticmethod
    def forward(ctx, x):
        return torch.cumsum(x, -1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1]
        if n <= 1:
            return g
        rev = torch.arange(n - 1, -1, -1, device=g.device)
        return torch.cumsum(g.index_select(-1, rev), -1).index_select(-1, rev)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) with out[i,j] = sum_{j<k<=i} x[k]; NEG_INF
    above the diagonal (finite, so exp gives exact zeros)."""
    T = x.shape[-1]
    cs = _Cumsum.apply(x)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, NEG_INF)


def _zero_pad(t: torch.Tensor, dim: int, *, before: int = 0, after: int = 0):
    """``t`` with zeros before and after it along ``dim``: ``F.pad``'s
    values, as a concatenation (a DTensor of torch 2.11 loses its mesh's
    rank through ``F.pad``)."""
    dim %= t.dim()
    parts = []
    for n in (before, after):
        shape = list(t.shape)
        shape[dim] = n
        parts.append(torch.zeros(shape, dtype=t.dtype, device=t.device))
    return torch.cat([parts[0], t, parts[1]], dim)


def _f32(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (the reference's operand dtype), then in
    float32 for an f32-accumulated product."""
    return t.to(dtype).float()


def ssd(x, a, B, C, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b, s, h, p) dt-premultiplied inputs; a: (b, s, h) per-step log
    decays (A * dt, negative); B, C: (b, s, h, n), already head-expanded.
    Returns (y (b, s, h, p), final_state (b, h, p, n)), both float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:                           # zeros after the sequence
        x, a, B, C = (_zero_pad(t, 1, after=pad) for t in (x, a, B, C))
    sp = s + pad
    c = sp // chunk
    f32 = torch.float32
    xd, bd, cd = x.dtype, B.dtype, C.dtype
    xf = x.reshape(b, c, chunk, h, p).float()
    Bf = B.reshape(b, c, chunk, h, n).float()
    Cf = C.reshape(b, c, chunk, h, n).float()
    a = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2).to(f32)
    a_cum = _Cumsum.apply(a)                                # (b,h,c,l)

    # 1. intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(a))                                  # (b,h,c,l,l)
    g = torch.einsum("bclhn,bcshn->bhcls", Cf, Bf)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", _f32(g * L, xd), xf)

    # 2. chunk-final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bf, _f32(decay_states, bd), xf)

    # 3. inter-chunk recurrence
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    states = torch.cat([initial_state[:, None].to(f32), states], 1)  # (b,c+1,...)
    chunk_decay = a_cum[..., -1]                               # (b,h,c)
    dc = torch.exp(_segsum(_zero_pad(chunk_decay, -1, before=1)))  # (b,h,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, states)
    states, final = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output
    out_decay = torch.exp(a_cum)                               # (b,h,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cf, _f32(states, cd),
                         _f32(out_decay, cd))
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y, final


def ssd_ref(x, a, B, C, *, initial_state=None):
    """Sequential O(s) oracle for tests, in float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        da = torch.exp(a[:, t].float())                         # (b,h)
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].float(), B[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t].float()))
    return torch.stack(ys, 1), state


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------
def _split_proj(cfg, proj):
    """[z | xBC | dt] at split INDICES (``jnp.split``), not sizes."""
    d_inner, H, P, G, N, conv_ch, _ = dims(cfg)
    z, xBC, dt = torch.tensor_split(proj, [d_inner, d_inner + conv_ch], dim=-1)
    return z, xBC, dt


def _causal_conv(xBC, w, b_, conv_state=None):
    """Depthwise causal conv along S. xBC (B,S,C); w (K,C).

    With ``conv_state`` (B,K-1,C) the sequence is prepended (the decode and
    chunked-prefill continuation); otherwise zero history. Returns (out,
    the last K-1 rows of the history, the next call's ``conv_state``)."""
    K = w.shape[0]
    S = xBC.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                                 dtype=xBC.dtype, device=xBC.device)
    xt = torch.cat([conv_state, xBC], 1)
    out = sum(xt[:, i:i + S] * w[i] for i in range(K))
    return out + b_, xt[:, -(K - 1):]


def _heads(cfg, xBC, shape):
    """silu'd conv output -> (xs (..., H, P), B and C (..., H, N)); B and C
    repeated per group with ``repeat_interleave`` (``jnp.repeat``)."""
    d_inner, H, P, G, N, _, _ = dims(cfg)
    xs, Bc, Cc = torch.tensor_split(xBC, [d_inner, d_inner + G * N], dim=-1)
    xs = xs.reshape(*shape, H, P)
    Bc = Bc.reshape(*shape, G, N).repeat_interleave(H // G, dim=len(shape))
    Cc = Cc.reshape(*shape, G, N).repeat_interleave(H // G, dim=len(shape))
    return xs, Bc, Cc


def mamba_block(cfg, p, x, *, state=None, conv_state=None, return_state=False):
    """Full-sequence mamba2 block. x (B,S,d) -> (B,S,d), and with
    ``return_state`` also (final SSM state (B,H,P,N) f32, conv state)."""
    d_inner = cfg.ssm_inner
    B_, S, _ = x.shape
    x = constrain(x, ("batch", "seq", None))
    # FSDP weight unsharding at use-site (see transformer._gather_weights)
    tmpl = block_specs(cfg)
    p = {
        n: (
            constrain(
                a,
                tuple(None if ax == "embed" else ax for ax in tmpl[n].axes),
            )
            if n in tmpl
            else a
        )
        for n, a in p.items()
    }
    h = rms_norm(x, p["norm/scale"], cfg.norm_eps)
    proj = h @ p["in_proj/w"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC, new_conv = _causal_conv(xBC, p["conv/w"], p["conv/b"], conv_state)
    xs, Bc, Cc = _heads(cfg, F.silu(xBC), (B_, S))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # (B,S,H)
    A = -torch.exp(p["A_log"])                                 # (H,)
    y, final = ssd(xs * dt[..., None].to(xs.dtype), dt * A, Bc, Cc,
                   chunk=cfg.ssm_chunk, initial_state=state)
    y = y + xs.float() * p["D"][:, None]
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm/scale"], cfg.norm_eps)
    out = x + y @ p["out_proj/w"]
    if return_state:
        return out, final, new_conv
    return out


def mamba_block_decode(cfg, p, x, conv_state, ssm_state):
    """One-token recurrence. x (B,1,d); returns (out, conv state, SSM
    state), the states new tensors."""
    d_inner = cfg.ssm_inner
    B_ = x.shape[0]
    h = rms_norm(x, p["norm/scale"], cfg.norm_eps)
    proj = h @ p["in_proj/w"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([conv_state, xBC], 1)                   # (B,K,C)
    xBC = (window * p["conv/w"]).sum(1, keepdim=True) + p["conv/b"]
    new_conv = window[:, 1:]
    xs, Bc, Cc = _heads(cfg, F.silu(xBC)[:, 0], (B_,))
    xs, Bc, Cc = xs.float(), Bc.float(), Cc.float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])       # (B,H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                                     # (B,H)
    new_state = ssm_state * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xs * dt[..., None], Bc)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cc) + xs * p["D"][:, None]
    y = y.reshape(B_, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm/scale"], cfg.norm_eps)
    return x + y @ p["out_proj/w"], new_conv, new_state


# --------------------------------------------------------------------------
# model entry points
# --------------------------------------------------------------------------
def _stacked(params, prefix="blocks"):
    plen = len(prefix) + 1
    return {n[plen:]: a for n, a in params.items() if n.startswith(prefix + "/")}


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters from a stacked dict."""
    return {n: a[i] for n, a in stacked.items()}


def remat_block(cfg):
    """``mamba_block`` under the config's remat policy while autograd
    records (training), else ``mamba_block`` itself."""
    return remat_wrap(mamba_block, cfg) if torch.is_grad_enabled() else mamba_block


def embed(params, tokens):
    return params["embed/tokens"][tokens.long()]


def logits_fn(cfg, params, x):
    x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
    logits = (
        x @ params["embed/tokens"].T
        if cfg.tie_embeddings
        else x @ params["lm_head/w"]
    )
    return constrain(logits, ("batch", "seq", "vocab"))


def forward(cfg, params, batch, *, impl: str = "kernel"):
    """Full-sequence forward -> (logits (B, S, V), a float32 zero). ``impl``
    is taken for the uniform API; mamba2 has no attention."""
    x = embed(params, batch["tokens"])
    stacked = _stacked(params)
    block = remat_block(cfg)
    for i in range(cfg.num_layers):
        x = block(cfg, layer(stacked, i), x)
    return logits_fn(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def loss_fn(cfg, params, batch, *, impl: str = "chunked", aux_coef=0.0):
    """Mean next-token cross entropy (an SSM has no aux loss; ``impl`` and
    ``aux_coef`` are taken for the uniform API, as in the reference)."""
    logits, _ = forward(cfg, params, batch, impl=impl)
    return cross_entropy(logits, batch["labels"])


def cache_spec(cfg, batch: int, seq_len: int):
    """({name: (shape, dtype name)}, {name: logical axes}) of the decode
    cache; ``seq_len`` is unused (an SSM cache has no sequence axis)."""
    d_inner, H, P, G, N, conv_ch, _ = dims(cfg)
    L, K = cfg.num_layers, cfg.ssm_conv
    shapes = {
        "conv": ((L, batch, K - 1, conv_ch), cfg.dtype),
        "ssm": ((L, batch, H, P, N), "float32"),
        "pos": ((), "int32"),
    }
    axes = {
        "conv": ("layers", "batch", None, "ssm_inner"),
        "ssm": ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"),
        "pos": (),
    }
    return shapes, axes


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    """Zero ``conv`` (L,B,K-1,conv_ch) in the config's dtype and ``ssm``
    (L,B,H,P,N) in float32; ``pos`` 0."""
    shapes, _ = cache_spec(cfg, batch, seq_len)
    cache = {n: torch.zeros(shape, dtype=torch_dtype(dt), device=device)
             for n, (shape, dt) in shapes.items() if n != "pos"}
    cache["pos"] = 0
    return cache


def prefill(cfg, params, batch, *, impl: str = "kernel", cache_len=None):
    """Process a prompt; returns (last-position logits (B,1,V), cache).
    ``cache_len`` is ignored: the SSM cache has no sequence axis."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params, tokens)
    stacked = _stacked(params)
    cache = placed_like(init_cache(cfg, B, S, cache_device(x)), x, cache_spec(cfg, B, S)[1])
    block = remat_block(cfg)
    for i in range(cfg.num_layers):
        x, final, conv = block(cfg, layer(stacked, i), x, return_state=True)
        cache["conv"][i] = conv
        cache["ssm"][i] = final
    cache["pos"] = S - 1
    return logits_fn(cfg, params, x[:, -1:, :]), cache


def next_pos(pos):
    """The position being written after ``pos``: an int, or per row."""
    if isinstance(pos, (tuple, list)):
        return tuple(int(p) + 1 for p in pos)
    return pos + 1


def decode_layers(cfg, stacked, cache, x, lo: int, hi: int):
    """Layers [lo, hi) of one decode step on x (B,1,d), each reading and
    then overwriting its conv and SSM state rows of ``cache`` in place."""
    for i in range(lo, hi):
        x, conv, ssm = mamba_block_decode(cfg, layer(stacked, i), x,
                                          cache["conv"][i], cache["ssm"][i])
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
    return x


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), cache')."""
    x = embed(params, tokens)
    x = decode_layers(cfg, _stacked(params), cache, x, 0, cfg.num_layers)
    new_cache = dict(cache)
    new_cache["pos"] = next_pos(cache["pos"])
    return logits_fn(cfg, params, x), new_cache
