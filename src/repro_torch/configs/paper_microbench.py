"""The paper's own microbenchmark "application" (§2.2.1 / §5.2.1).

Generates a synthetic (n shared objects) x (f symbols each) world: ``n``
weight bundles each exporting ``f`` small tensors, and an application
referencing all ``n*f`` of them — the ML transliteration of the paper's
generated C program where main() calls every generated function.

The reference's ``benchmarks/microbench.py`` reproduces Figures 1 and 7
with its counterpart; the port's benchmark folder is ROADMAP Queue A
item 14. Manifests, payloads and content hashes equal the reference's
for the same arguments.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (
    ObjectKind,
    PAGE_BYTES,
    SymbolDef,
    SymbolRef,
    align_up,
    make_object,
)


def make_world_spec(
    n_bundles: int,
    f_symbols_per_bundle: int,
    *,
    tensor_elems: int = 64,
    dtype: str = "float32",
    seed: int = 0,
):
    """Returns (bundles: list[(StoreObject, payload)], app: StoreObject).

    Symbols are named ``lib{i}/fn{j}``; the application requires all of them
    in shuffled order (matching the paper's uniform reference pattern, so
    the dynamic baseline's average search depth is n/2).
    """
    rng = np.random.default_rng(seed)
    itemsize = np.dtype(dtype).itemsize
    nbytes = tensor_elems * itemsize
    stride = align_up(nbytes, PAGE_BYTES)

    bundles = []
    all_names: list[str] = []
    for i in range(n_bundles):
        syms = []
        payload = bytearray(stride * f_symbols_per_bundle)
        for j in range(f_symbols_per_bundle):
            name = f"lib{i}/fn{j}"
            arr = rng.standard_normal(tensor_elems).astype(dtype)
            off = j * stride
            payload[off : off + nbytes] = arr.tobytes()
            syms.append(SymbolDef(name, (tensor_elems,), dtype, off, nbytes))
            all_names.append(name)
        obj, pl = make_object(
            name=f"lib{i}",
            version="1",
            kind=ObjectKind.BUNDLE,
            symbols=syms,
            payload=bytes(payload),
        )
        bundles.append((obj, pl))

    order = rng.permutation(len(all_names))
    refs = [
        SymbolRef(all_names[k], (tensor_elems,), dtype) for k in order
    ]
    app, _ = make_object(
        name=f"microbench-n{n_bundles}-f{f_symbols_per_bundle}",
        version="1",
        kind=ObjectKind.APPLICATION,
        refs=refs,
        needed=[f"lib{i}" for i in range(n_bundles)],
    )
    return bundles, app
