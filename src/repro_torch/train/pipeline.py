"""GPipe-style pipeline parallelism over a mesh axis (the counterpart of
``repro.train.pipeline``).

Each rank along the axis is one stage holding a contiguous slice of
layers; microbatches stream through a ring of point-to-point sends.

Schedule: T = M + S - 1 ticks.  At tick t, stage s computes microbatch
(t - s) if 0 <= t - s < M (otherwise it computes on the buffer it
holds, whose result is discarded: the GPipe bubble, (S-1)/(M+S-1) of
the compute, as in the reference).
"""

from __future__ import annotations

import torch

from repro_torch.core import comm
from repro_torch.optim.tree import tree_map


def pipeline_apply(stage_fn, stage_params, microbatches, *, mesh,
                   axis: str = "pipe"):
    """Run microbatches (M, B, ...) through S = mesh.shape[axis] stages.

    stage_fn(params_slice, x) -> y applies one stage's layers.
    stage_params: this rank's piece of a tree stacked over stages (its
    leading dim 1: the stage-sharded ``P(axis)`` piece).  microbatches:
    the whole stream, on every rank.  Returns the last stage's (M, B,
    ...) outputs, on every rank.  Collective over ``axis``."""
    S = mesh.shape[axis]
    M = microbatches.shape[0]
    T = M + S - 1
    params = tree_map(lambda a: a[0], stage_params)
    with comm.on_mesh(mesh):
        sid = comm.axis_index(axis)
        buf = torch.zeros_like(microbatches[0])
        outs = torch.zeros_like(microbatches)
        perm = [(i, (i + 1) % S) for i in range(S)]
        for t in range(T):
            # stage 0 ingests microbatch t (if any); the others use the
            # buffer received from the previous stage
            x_in = microbatches[min(t, M - 1)] if sid == 0 else buf
            y = stage_fn(params, x_in)
            if sid == S - 1 and t >= S - 1:
                outs[t - (S - 1)] = y.to(outs.dtype)
            buf = comm.ppermute(y, axis, perm)
        # only the last stage's outputs are real: a sum hands them to
        # every stage
        if sid != S - 1:
            outs = torch.zeros_like(outs)
        return comm.psum(outs, axis)
