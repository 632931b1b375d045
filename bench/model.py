"""The program's side of a configuration: its ``ModelConfig``, checked
against the benchmark's file.

A configuration file names the program's architecture (``program.arch``)
and maps its own keys to the ``ModelConfig`` fields that hold them
(``program.fields``). Every mapped key has to equal the program's value, so
the file holds the configuration as it is run. ``smoke=True`` (the CPU
tests) takes the program's reduced variant in the file's dtype and writes
its sizes back into a copy of the file, which the reference then reads.
"""

from __future__ import annotations

import copy


def _field(cfg, field: str):
    return cfg.resolved_head_dim if field == "head_dim" else getattr(cfg, field)


def program_config(conf: dict, *, smoke: bool = False):
    """(the program's ``ModelConfig``, the file's dict as it is run)."""
    from repro_torch.configs import get_config

    prog = conf["program"]
    cfg = get_config(prog["arch"], smoke=smoke)
    if smoke:
        cfg = cfg.replace(dtype=conf["dtype"])
        conf = copy.deepcopy(conf)
        for key, field in prog["fields"].items():
            conf[key] = _field(cfg, field)
        return cfg, conf
    for key, field in prog["fields"].items():
        if conf[key] != _field(cfg, field):
            raise ValueError(f"{prog['arch']}: the file's {key}={conf[key]!r} is not "
                             f"the program's {field}={_field(cfg, field)!r}")
    return cfg, conf
