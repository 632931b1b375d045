"""The reference's ``tests/test_property.py`` on the port's linker: its cases,
with their imports mapped to ``repro_torch`` (``tests/torch_suite.py``),
against the port-side ``workspace`` and ``linker`` fixtures."""

from torch_suite import (  # noqa: F401  (fixtures pytest finds by name)
    _port_strategy_registry_guard,
    linker,
    run_reference_suite,
    workspace,
)

run_reference_suite("test_property.py", globals())
