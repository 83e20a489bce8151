"""How full the expert buffer is: 100 × the rows some assignment writes
over all rows (b·e·cap), summed over the program's ``moe.route`` spans
of the profiled steps (their ``filled`` and ``rows`` counters)."""
from portbench.spans import last_steps

UNIT = "%"


def read(ctx):
    if ctx.trace is None:
        return None
    routes = [s["attrs"] for s in last_steps(ctx.trace.steps) if s["name"] == "moe.route"]
    rows = sum(a["rows"] for a in routes)
    return 100.0 * sum(a["filled"] for a in routes) / rows if rows else None
