"""Optimizers: the AdamW baseline and the KFAC-CA second-order optimizer
whose preconditioner solves run through the paper's inversion-based
TRSM (the counterpart of ``repro.optim``).  Both are functional
``(init, update)`` pairs over nested dicts of tensors."""

from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.kfac_ca import kfac_ca  # noqa: F401


def get(name: str, **kw):
    if name == "adamw":
        return adamw(**kw)
    if name == "kfac_ca":
        return kfac_ca(**kw)
    raise ValueError(name)
