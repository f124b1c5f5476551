"""Closed loop of preconditioning steps, one in flight at a time.

A step solves every banked factor once, ``Solver.from_bank(bank)
.solve(B)`` on each bank, and synchronizes.  A factor takes ``columns``
right-hand sides: a number, or "gradient", the width of the gradient
K-FAC preconditions with it (a factor of order r of a weight (r, c)
takes c columns, one of order c takes r).  So the weights are banked by
``kfac_ca.factor_banks_from_state`` one group of like shapes at a time
(``statistics.weight_groups``), which gives one bank per (order, width).
The right-hand sides are ``rhs_sets`` sets drawn from the seed in
set-up and used in turn.

The check: in every step the answers of a few slots and columns,
drawn on the device from the seed among ``check_factors`` slots of each
bank, are kept; once the window has closed and the program is freed,
each is judged by its residual against the reference's float64 factor
of the same statistics.
"""

from __future__ import annotations

import gc
import time

import torch

from solvebench import loops, reference, statistics


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Runner:
    def __init__(self, cfg, traffic, *, seed, seconds, device, control,
                 spans):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device, self.control = seed, device, control
        self.seconds, self.spans = seconds, spans

    def setup(self) -> None:
        api, kfac = loops.program()
        grid = loops.grid(self.device)
        state = statistics.make_state(self.cfg, self.seed, loops.STATS,
                                      self.device)
        self.banks, manifest = {}, {}
        for pair, weights in statistics.weight_groups(self.cfg).items():
            banks, tags = kfac.factor_banks_from_state(
                statistics.substate(state, weights), grid=grid,
                **loops.bank_kwargs(self.cfg))
            for d, bank in banks.items():
                key = (d, loops.columns(self.traffic["columns"], pair, d))
                self.banks[key], manifest[key] = bank, tags[d]
        pick = loops.rng(self.seed, loops.SCHEDULE)
        cand = loops.candidates(manifest, self.traffic["check_factors"],
                                pick)
        index = statistics.factor_index(state)
        self.stats = {(key, s): index[manifest[key][s]].clone()
                      for key, slots in cand.items() for s in slots}
        del state, index
        self.cand = {key: torch.as_tensor(slots, device=self.device)
                     for key, slots in cand.items()}
        gen = statistics.generator(self.seed, loops.RHS, self.device)
        self.keys = sorted(self.banks, reverse=True)
        self.B = {(d, k): [torch.randn((self.banks[(d, k)].width, d, k),
                                       generator=gen, device=self.device)
                           for _ in range(self.traffic["rhs_sets"])]
                  for d, k in self.keys}
        self.solvers = {key: api.Solver.from_bank(self.banks[key])
                        for key in self.keys}
        if self.control:
            # the control: the solve's float32 products in TF32
            loops.solve_control(self.cfg)
        self.samples = []
        self.gen = statistics.generator(self.seed, loops.SAMPLE,
                                        self.device)
        for j in range(self.traffic["rhs_sets"]):    # every shape, warm
            self._step(j, keep=False)
        synchronize(self.device)
        self.gen = statistics.generator(self.seed, loops.SAMPLE + 1,
                                        self.device)

    def _draw(self, n: int, size: int) -> torch.Tensor:
        """``size`` distinct indices below ``n``, drawn on the device, so
        the step waits on nothing of the host's."""
        return torch.rand(n, generator=self.gen, device=self.device) \
            .argsort()[:min(size, n)]

    def _step(self, j: int, keep: bool = True) -> None:
        for key in self.keys:
            X = self.solvers[key].solve(self.B[key][j])
            cand = self.cand[key]
            slots = cand[self._draw(len(cand),
                                    self.traffic["check_slots_per_step"])]
            cidx = self._draw(key[1], self.traffic["check_columns"])
            part = X.index_select(0, slots).index_select(2, cidx)
            if keep:
                self.samples.append((key, j, slots, cidx, part))

    def window(self, prof) -> dict:
        sets = self.traffic["rhs_sets"]
        steps = 0
        prof.mark_start()
        t0 = time.monotonic()
        while True:
            with self.spans.span("solve"):
                self._step(steps % sets)
            with self.spans.span("synchronize"):
                synchronize(self.device)
            steps += 1
            if time.monotonic() - t0 >= self.seconds:
                break
        window_s = time.monotonic() - t0
        prof.mark_end()
        solves = [(d, k, steps * self.banks[(d, k)].width)
                  for d, k in self.keys]
        return {"attempted": sum(c for _, _, c in solves), "failed": 0,
                "window_s": window_s, "steps": steps,
                "columns": sum(c * k for _, k, c in solves),
                "solves": solves}

    def check(self) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        del self.solvers, self.banks
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        damping = self.cfg["kfac"]["damping"]
        factors: dict = {}
        worst = torch.zeros((), dtype=torch.float64)
        for key, j, slots, cidx, part in self.samples:
            for i, s in enumerate(slots.tolist()):
                if (key, s) not in factors:
                    factors[(key, s)] = reference.factor64(
                        self.stats[(key, s)], damping)
                B = self.B[key][j][s][:, cidx]
                r = reference.relres(factors[(key, s)], part[i], B)
                worst = torch.maximum(worst, torch.nan_to_num(
                    r, nan=float("inf")).max().cpu())
        return {"relres_max": {"value": float(worst),
                               "limit": self.cfg["limits"]["relres"]}}
