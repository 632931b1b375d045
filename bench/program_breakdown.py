"""One traced run of a cell, with the card's idle time keyed by the
program's own spans.

    python3 bench/program_breakdown.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout. Runs the cell once as ``bench/run.py --trace
1`` does and prints the same lines; before the result line it prints one
more on standard error: ``program_breakdown`` and a JSON object
(``bench.spans.idle_by_span``) with the traced stretch's idle seconds on
the card, the part of them the host spent inside some span of the program
(``repro_torch.obs``) and outside every one (``between_spans_s``), and the
idle seconds by the innermost program span the host was in at each gap's
middle. The result's own ``breakdown`` keys the same gaps by the harness's
spans. A program without the recorder, or one that dropped records of the
stretch, prints ``null``.
"""

from __future__ import annotations

import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# run as a script, this folder heads sys.path; its modules (trace, cell, ...)
# must not shadow the standard library's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from bench import run, spans, trace  # noqa: E402


class ProgramTracer(trace.Tracer):
    """A ``Tracer`` whose summary also prints the stretch's idle time by
    program span."""

    def summary(self, harness_spans) -> dict | None:
        out = super().summary(harness_spans)
        if out is not None:
            by_span = spans.idle_by_span(super().summary, self.t0, self.t1)
            print("program_breakdown " + json.dumps(by_span), file=sys.stderr, flush=True)
        return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" in argv:
        print("program_breakdown.py always traces: leave out --trace", file=sys.stderr)
        return 2
    # the drivers take ``Tracer`` from bench.trace when they are loaded,
    # which run_cell does after this
    trace.Tracer = ProgramTracer
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
