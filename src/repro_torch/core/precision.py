"""Precision policies for the solve pipeline (DESIGN.md Sec. 7).

A :class:`PrecisionPolicy` separates the four dtype roles so the sweep
can run at low precision while the answer is recovered at high
precision by iterative refinement (``repro_torch.core.refine``):

* ``storage``    — dtype of the resident factor fed to the sweep (cast
                   ONCE, at admission).
* ``compute``    — dtype the sweep's GEMM operands are held in.
* ``accumulate`` — dtype of GEMM partial sums (bf16 operands accumulate
                   in fp32 in the kernels and in cuBLAS).
* ``residual``   — dtype of the refinement residual r = B - op(A)·X and
                   of the refined solution; a SECOND resident copy of
                   the factor is kept at this precision when
                   ``refine_steps > 0``.

Presets (the ``precision=`` argument everywhere accepts these names):

    name         storage  compute  accumulate residual steps  io dtype
    fp32         f32      f32      f32        f32      0      f32
    bf16         bf16     bf16     f32        f32      0      bf16
    bf16_refine  bf16     bf16     f32        f32      2      f32
    fp64_refine  f32      f32      f32        f64      2      f64

A policy is hashable and lands verbatim in the ``CompiledSolverCache``
key; ``name`` is cosmetic and stays out of equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def as_torch_dtype(dtype) -> torch.dtype:
    """Canonicalize a torch dtype, a dtype name, or a NumPy dtype (or
    scalar type) to the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pin_matmul_numerics() -> None:
    """Keep fp32 GEMMs in IEEE fp32 and bf16 GEMMs accumulating in fp32.

    TF32 would silently drop 13 mantissa bits from the ``fp32`` and
    ``fp64_refine`` sweeps; a reduced-precision bf16 reduction would
    break the fp32 accumulation that ``preferred_element_type=f32``
    gives the reference's bf16 trailing update."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction):
        raise RuntimeError("could not pin IEEE fp32 / fp32-accumulating "
                           "bf16 matmul numerics")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype assignment for one solve pipeline; see module docstring.

    The four roles are held as torch dtypes (hashable, so the policy is
    part of the compiled-program cache key).  ``name`` is excluded from
    equality/hash: two policies with the same roles and trip count are
    the SAME cache key.  Use :func:`resolve` to build one from a preset
    name, a dtype, or another policy."""
    name: str = dataclasses.field(compare=False)
    storage: torch.dtype
    compute: torch.dtype
    accumulate: torch.dtype
    residual: torch.dtype
    refine_steps: int = 0

    def __post_init__(self):
        for field in ("storage", "compute", "accumulate", "residual"):
            object.__setattr__(self, field,
                               as_torch_dtype(getattr(self, field)))
        if self.refine_steps < 0:
            raise ValueError(f"refine_steps must be >= 0, got "
                             f"{self.refine_steps}")

    @property
    def io_dtype(self) -> torch.dtype:
        """Dtype of the program boundary (B in, X out): the residual
        dtype when refining, otherwise the sweep's compute dtype."""
        return self.residual if self.refine_steps else self.compute

    @property
    def refines(self) -> bool:
        return self.refine_steps > 0

    def describe(self) -> str:
        return (f"{self.name}: storage={dtype_name(self.storage)} "
                f"compute={dtype_name(self.compute)} "
                f"accumulate={dtype_name(self.accumulate)} "
                f"residual={dtype_name(self.residual)} "
                f"refine_steps={self.refine_steps}")


def _preset(name, storage, compute, accumulate, residual, steps):
    return PrecisionPolicy(name=name, storage=storage, compute=compute,
                           accumulate=accumulate, residual=residual,
                           refine_steps=steps)


PRESETS: dict[str, PrecisionPolicy] = {
    "fp32": _preset("fp32", "float32", "float32", "float32", "float32", 0),
    "bf16": _preset("bf16", "bfloat16", "bfloat16", "float32", "float32", 0),
    "bf16_refine": _preset("bf16_refine", "bfloat16", "bfloat16",
                           "float32", "float32", 2),
    "fp64_refine": _preset("fp64_refine", "float32", "float32",
                           "float32", "float64", 2),
}


def from_dtype(dtype) -> PrecisionPolicy:
    """The uniform (legacy) policy: every role at ``dtype``, no
    refinement."""
    d = as_torch_dtype(dtype)
    return PrecisionPolicy(name=dtype_name(d), storage=d, compute=d,
                           accumulate=d, residual=d, refine_steps=0)


def resolve(precision=None, dtype=None) -> PrecisionPolicy:
    """Normalize the ``precision=`` argument into a PrecisionPolicy.

    * ``PrecisionPolicy`` — returned as-is.
    * preset name (``"fp32" | "bf16" | "bf16_refine" | "fp64_refine"``)
      — looked up in :data:`PRESETS`.
    * ``None`` — the uniform policy at ``dtype`` (which must then be
      given).
    """
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision is not None:
        try:
            return PRESETS[precision]
        except KeyError:
            raise ValueError(
                f"unknown precision preset {precision!r}; expected one of "
                f"{sorted(PRESETS)} or a PrecisionPolicy") from None
    if dtype is None:
        raise ValueError("need precision= or dtype= to resolve a policy")
    return from_dtype(dtype)


def matmul_as(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype,
              out: torch.dtype) -> torch.Tensor:
    """``a @ b`` with partial sums at ``acc`` and the result rounded once
    to ``out`` — the reference's ``dot(..., preferred_element_type=acc)
    .astype(out)``.  A bf16 or fp16 product with fp32 accumulation runs
    in the operand dtype: cuBLAS accumulates it in fp32 (reduced-
    precision reduction is pinned off) and rounds once to the operand
    dtype, which is the same result when ``out`` is that dtype."""
    if a.dtype == acc or (a.dtype == out and acc == torch.float32
                          and a.dtype in (torch.bfloat16, torch.float16)):
        return torch.matmul(a, b).to(out)
    return torch.matmul(a.to(acc), b.to(acc)).to(out)
