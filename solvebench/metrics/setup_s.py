"""setup_s: seconds from the process's start to the first timed step:
imports, loading the kernels, statistics, banking and warm-up."""


def read(ctx):
    return ctx["setup_s"]
