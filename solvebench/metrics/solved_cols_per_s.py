"""solved_cols_per_s: every right-hand-side column solved in the
window over the window's host-clock seconds (whole steps, each ending
in a synchronize)."""


def read(ctx):
    if ctx.get("columns") is None:
        return None
    return ctx["columns"] / ctx["window_s"]
