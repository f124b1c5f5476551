"""Gradient compression for the cross-pod reduction (the counterpart of
``repro.train.compress``).

Shared-scale int8 with stochastic rounding: the pod-level gradient
reduction is the slowest collective of a multi-pod job (data-center
network).  Quantizing to int8 with a scale shared by a max over the
axis cuts its payload 4x against fp32 at less than an int8 ulp of bias
(stochastic rounding is unbiased).  The sum of p int8 values fits int32
for any realistic pod count, so the reduction itself is exact.

``psum_compressed`` is the drop-in for ``comm.psum`` in a program run
on a mesh (inside ``comm.on_mesh``).  ``tag_for_compression`` is the
identity: the reference's jitted step leaves its gradients as they are
(its partitioner places the reduction), and so does
``train_step.jit_train_step``.
"""

from __future__ import annotations

import torch

from repro_torch.core import comm


def _stochastic_round(x, generator=None):
    """floor(x) + 1 with probability x - floor(x), else floor(x)."""
    lo = torch.floor(x)
    frac = x - lo
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return lo + (u < frac).to(x.dtype)


def quantize(g, generator=None, axis_name=None):
    """-> (int8 q, fp32 scale).  The scale is shared across
    ``axis_name`` (a max over it) so that the reduced sum dequantizes
    with one multiply."""
    gf = g.to(torch.float32)
    amax = torch.max(torch.abs(gf)).reshape(1)
    if axis_name is not None:
        amax = comm.pmax(amax, axis_name)
    scale = torch.clamp(amax[0], min=1e-30) / 127.0
    q = _stochastic_round(gf / scale, generator)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def psum_compressed(g, axis_name, generator=None):
    """int8 all-reduce with a shared scale; exact int32 summation.
    ``generator`` draws this rank's rounding (seed it per rank)."""
    q, scale = quantize(g, generator, axis_name)
    s = comm.psum(q.to(torch.int32), axis_name)
    return dequantize(s, scale)


def tag_for_compression(grads):
    """The identity: the step's gradient reduction stays uncompressed
    (the reference's ``tag_for_compression`` under ``jax.jit``)."""
    return grads
