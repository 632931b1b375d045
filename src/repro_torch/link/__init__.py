"""repro_torch.link — the unified stable-linking session API.

``Workspace`` is the single public entry point: it wires the engine room
(``repro_torch.core``'s Registry/Manager/Executor/CompileCache) into one session
object with transactional management times, by-name load strategies, and
one-call observability:

    from repro_torch.link import Workspace

    ws = Workspace.open("/path/to/store")      # or Workspace.ephemeral()
    with ws.management() as tx:                # commit-or-rollback
        tx.publish(bundle, payload)
        tx.publish(app)
        tx.diff()                              # staged vs committed bindings
        tx.preview()                           # relocation-delta dry run
    img = ws.load("serve:model")               # strategy registry dispatch
    ws.explain("serve:model").summary()        # observable mid-epoch

Management times are journaled (``journal.jsonl`` beside the state file):
``Workspace.management(resume=True)`` replays a crashed session's staged
ops so the operator sees its diff before continuing or resetting.

Direct Registry/Manager/Executor wiring remains available in ``repro_torch.core``
for tooling that measures below the facade, but is deprecated for
application code.
"""

from .journal import (
    Journal,
    JournalEntry,
    PreviewReport,
    RelocationDelta,
    WorldDiff,
    preview_world,
    world_diff,
)
from .report import LinkReport, report_from_table
from .strategies import (
    available_strategies,
    get_strategy,
    register_strategy,
    resolve_strategy,
    strategy_overrides,
    unregister_strategy,
)
from .transaction import ManagementTransaction
from .workspace import WarmupReport, Workspace

__all__ = [
    "Journal",
    "JournalEntry",
    "LinkReport",
    "ManagementTransaction",
    "PreviewReport",
    "RelocationDelta",
    "WarmupReport",
    "Workspace",
    "WorldDiff",
    "available_strategies",
    "get_strategy",
    "preview_world",
    "register_strategy",
    "report_from_table",
    "resolve_strategy",
    "strategy_overrides",
    "unregister_strategy",
    "world_diff",
]
