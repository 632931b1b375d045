"""The reference's ``tests/test_kernel_symbols.py`` on the port's linker: its
cases, with their imports mapped to ``repro_torch`` (``tests/torch_suite.py``),
against the port-side ``workspace`` and ``linker`` fixtures.

One case is the port's own: ``test_kernel_registry_dispatch`` ends in a call
of the JAX Pallas rmsnorm in interpret mode. Its port case links the same
kernel library, then calls ``repro_torch.kernels.rmsnorm.rmsnorm`` on the
CPU (the kernel's plain version) and holds it against that Pallas call on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np

from torch_suite import (  # noqa: F401  (fixtures pytest finds by name)
    _port_strategy_registry_guard,
    linker,
    run_reference_suite,
    workspace,
)

run_reference_suite("test_kernel_symbols.py", globals())


def test_kernel_registry_dispatch(linker):  # noqa: F811  (the port's case)
    """The kernels package resolves bound entry points to callables."""
    import torch

    from repro.kernels.rmsnorm import rmsnorm as ref_rmsnorm
    from repro_torch.ckpt import make_kernel_lib
    from repro_torch.core import SymbolRef
    from repro_torch.kernels import rmsnorm as rms_pkg
    from torch_suite import build_app

    _, mgr, ex = linker
    klib, _ = make_kernel_lib("kernels:prod", "v1", {"rmsnorm": 1})
    app = build_app("app", [SymbolRef("kernel:rmsnorm", (), "kernel")],
                    ["kernels:prod"])
    mgr.update_obj(klib)
    mgr.update_obj(app)
    mgr.end_mgmt()
    img = ex.load("app")
    provider, entry = img.kernels["kernel:rmsnorm"].rsplit(":", 1)
    assert provider == "kernels:prod" and entry == "1"
    fn = rms_pkg.rmsnorm  # the registered impl for entry-point family
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    out = fn(torch.from_numpy(x), torch.from_numpy(scale))
    assert out.shape == (4, 8)
    want = ref_rmsnorm(jnp.asarray(x), jnp.asarray(scale), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
