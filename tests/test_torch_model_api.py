"""The model API's last public names of the reference, on the port:
``models.init_cache`` against the reference's ``init_cache`` for every
family, and ``models.specs.init_params_np`` / ``abstract_params`` against
the port's ``init_params`` and ``abstract`` (and the reference's
``abstract`` shapes and dtype names)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core.resolver import np_dtype
from repro_torch.models.specs import abstract_params, init_params, init_params_np

FAMILIES = ["gemma3-1b", "olmoe-1b-7b", "seamless-m4t-large-v2", "mamba2-370m", "zamba2-7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_the_references_shapes_and_dtypes(arch):
    """Every leaf the reference's cache holds, at its shape and dtype, all
    zero; ``pos`` is the int 0 (the port keeps the position on the host,
    where the reference holds a 0-d int32 zero)."""
    want = ref_models.init_cache(ref_config(arch, smoke=True), 2, 12)
    got = models.init_cache(get_config(arch, smoke=True), 2, 12, device="cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        if n == "pos":
            assert got[n] == 0 and w.shape == () and int(w) == 0
            continue
        t = got[n]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", n
        assert tuple(t.shape) == tuple(w.shape), n
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, n
        assert not t.any(), n


def test_init_cache_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = get_config("gemma3-1b", smoke=True)
    if torch.cuda.is_available():
        assert models.init_cache(cfg, 1, 4)["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            models.init_cache(cfg, 1, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_np_is_init_params_on_the_cpu(dtype):
    """The same bytes as ``init_params`` on the CPU, in the linker's numpy
    dtype (bfloat16 as its 2-byte stand-in), and the same bundle."""
    cfg = get_config("gemma3-1b", smoke=True).replace(dtype=dtype)
    specs = models.param_specs(cfg)
    arrays = init_params_np(specs, seed=3)
    tensors = init_params(specs, 3, "cpu")
    assert list(arrays) == list(tensors)
    for n, a in arrays.items():
        t = tensors[n]
        assert a.dtype == np_dtype(specs[n].dtype) and a.shape == tuple(t.shape), n
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert a.tobytes() == raw.numpy().tobytes(), n
    a_obj, a_payload = bundle_from_params("w", "1", arrays, specs=specs)
    t_obj, t_payload = bundle_from_params("w", "1", tensors, specs=specs)
    assert a_obj.content_hash == t_obj.content_hash and a_payload == t_payload


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_params_match_abstract_and_init_params(arch):
    """Meta tensors at every parameter's shape and dtype: ``abstract`` is
    ``abstract_params`` of the specs, ``init_params`` draws those shapes,
    and the reference's ``abstract`` gives the same shapes and dtype
    names."""
    cfg = get_config(arch, smoke=True)
    specs = models.param_specs(cfg)
    meta = abstract_params(specs)
    assert all(t.device.type == "meta" for t in meta.values())
    shape_dtype = lambda d: {n: (tuple(t.shape), str(t.dtype)) for n, t in d.items()}
    assert shape_dtype(models.abstract(cfg)) == shape_dtype(meta)
    assert shape_dtype(init_params(specs, 0, "cpu")) == shape_dtype(meta)
    ref = ref_models.abstract(ref_config(arch, smoke=True))
    assert {n: (tuple(s.shape), s.dtype.name) for n, s in ref.items()} == {
        n: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for n, t in meta.items()}
