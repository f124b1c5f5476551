"""solve_roofline.precondition: the least time the card could take for
the window's solves (roofline.solve_bound_s: n^2 k flops at the
bfloat16 peak, or the bfloat16 triangle and the float32 B and X at full
bandwidth, whichever is longer) over the window's device-busy time."""

from solvebench import roofline


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["busy_s"] or not ctx.get("solves"):
        return None
    bound = sum(count * roofline.solve_bound_s(n, k)
                for n, k, count in ctx["solves"])
    return 100.0 * bound / tr["busy_s"]
