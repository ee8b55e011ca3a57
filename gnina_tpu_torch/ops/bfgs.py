"""Batched dense BFGS over pose DOF, with Vina's two line searches.

The general path's minimiser, counterpart of gnina_tpu/ops/bfgs.py
(reference: gninasrc/lib/bfgs.h:357-502, fast_line_search :73-91,
accurate_line_search :107-180, bfgs_update :52-66).  Plain PyTorch on a
batch of poses: every function takes a Conf with ONE leading pose dimension
(B, ...) and masks the poses that have finished, where the JAX functions take
one pose and are vmapped.  Gradients come from the objective (ops/energy.py's
autograd); no kernel is involved.  `--minimize`, `--local_only` and the
refine_structure stages of DockingEngine.minimize run through it.

Trials are forward-only and the gradient is computed once after acceptance,
as in the JAX module.  The final "restore if not improved" check
(bfgs.h:491-495) is preserved; it also recovers from NaN energies.

The fast line search evaluates its ten Armijo trials in one batched call,
as the JAX module's does; the JAX module's fused_trials (the gradient at
every trial too) has no counterpart.  The `simple` type (--simple_ascent)
runs ops/ssd.py instead.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from gnina_tpu_torch.constants import EPSILON_FL
from gnina_tpu_torch.ops import quat as Q
from gnina_tpu_torch.ops.fk import conf_increment
from gnina_tpu_torch.types import Conf


@dataclasses.dataclass(frozen=True)
class MinimizeParams:
    maxiters: int = 20
    type: str = "fast"          # "fast" | "accurate" | "simple"
    early_term: bool = False


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor         # (B,)
    x_new: Conf
    f1: torch.Tensor            # (B,)


def _where_conf(mask, a: Conf, b: Conf) -> Conf:
    """mask (B,) ? a : b, field by field."""
    return Conf(*[torch.where(mask[:, None], x, y) for x, y in zip(a, b)])


def fast_line_search(f_val: Callable, x: Conf, g, f0, p,
                     lazy: bool = False) -> LineSearchResult:
    """Backtracking Armijo search (bfgs.h:73-91): up to 10 halvings.

    The ten step sizes are known in advance (alpha = 0.5^k), so the trials
    are one f_val call on (10, B) confs and the first acceptable alpha is
    selected: the reference's sequential loop's result.  If none is
    accepted the reference keeps the LAST trial's point but returns alpha
    after a final halving (0.5^10).

    lazy=True evaluates trial k only for the poses whose trials 0..k-1
    all failed, as f_val(confs (R, ...), rows (R,)) with rows the poses'
    indices in the batch: the same result for an objective whose
    evaluation costs more than a batched call saves (the CNN)."""
    c0 = 1e-4
    pg = torch.sum(p * g, dim=-1)
    alphas = 0.5 ** torch.arange(10, dtype=torch.float32, device=f0.device)
    xs = conf_increment(Conf(*[v.expand((10,) + v.shape) for v in x]),
                        p.expand((10,) + p.shape), alphas[:, None])
    bound = c0 * alphas[:, None] * pg
    if lazy:
        f1s = torch.full(bound.shape, float("inf"), device=f0.device)
        search = torch.ones_like(f0, dtype=torch.bool)
        for k in range(10):
            rows = torch.nonzero(search)[:, 0]
            if not len(rows):
                break
            f1 = f_val(Conf(*[v[k, rows] for v in xs]), rows)
            f1s[k, rows] = f1
            search[rows] = ~((f1 - f0[rows]) < bound[k, rows])
    else:
        f1s = f_val(xs)                                        # (10, B)
    accept = (f1s - f0) < bound
    any_ok = accept.any(0)
    idx = torch.where(any_ok, torch.argmax(accept.to(torch.int8), 0), 9)
    cols = torch.arange(f0.shape[0], device=f0.device)
    return LineSearchResult(
        alpha=torch.where(any_ok, alphas[idx], 0.5 ** 10),
        x_new=Conf(*[v[idx, cols] for v in xs]), f1=f1s[idx, cols])


def flatten_conf(c: Conf) -> torch.Tensor:
    """conf flat view for lambdamin: [pos, rotvec(q), torsions] (conf.h:459)."""
    return torch.cat([c.position, Q.quaternion_to_rotvec(c.orientation),
                      c.torsions], dim=-1)


def accurate_line_search(f_val: Callable, x: Conf, g, f0,
                         p) -> LineSearchResult:
    """Numerical-Recipes style lnsrch (bfgs.h:107-180).

    Guarantees sufficient decrease or returns alpha=0 (the caller zeroes the
    gradient in that case, matching the reference)."""
    ALF = 1e-4
    slope = torch.sum(g * p, dim=-1)
    xflat = flatten_conf(x)
    test = torch.max(torch.abs(p) / torch.clamp(torch.abs(xflat), min=1.0),
                     dim=-1).values
    alamin = EPSILON_FL / torch.clamp(test, min=EPSILON_FL)

    done = slope >= 0                       # wrong direction: alpha 0
    alpha = torch.ones_like(f0)
    alpha2 = torch.zeros_like(f0)
    f2 = torch.zeros_like(f0)
    best = LineSearchResult(torch.zeros_like(f0), x, f0)
    for it in range(50):
        if bool(done.all()):
            break
        x_new = conf_increment(x, p, alpha)
        f1 = f_val(x_new)
        too_small = (alpha < alamin) | ~torch.isfinite(alpha)
        sufficient = f1 <= f0 + ALF * alpha * slope
        finish = too_small | sufficient

        tmplam_first = -slope / (2.0 * (f1 - f0 - slope))
        rhs1 = f1 - f0 - alpha * slope
        rhs2 = f2 - f0 - alpha2 * slope
        denom = torch.where(torch.abs(alpha - alpha2) < 1e-20, 1e-20,
                            alpha - alpha2)
        a2c = torch.clamp(alpha2 * alpha2, min=1e-20)
        a = (rhs1 / (alpha * alpha) - rhs2 / a2c) / denom
        b = (-alpha2 * rhs1 / (alpha * alpha) + alpha * rhs2 / a2c) / denom
        disc = b * b - 3.0 * a * slope
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tmplam_sub = torch.where(
            torch.abs(a) < 1e-20, -slope / (2.0 * b),
            torch.where(disc < 0, 0.5 * alpha,
                        torch.where(b <= 0, (-b + sq) / (3.0 * a),
                                    -slope / (b + sq))))
        tmplam_sub = torch.minimum(tmplam_sub, 0.5 * alpha)
        tmplam = tmplam_first if it == 0 else tmplam_sub

        res = LineSearchResult(
            alpha=torch.where(too_small, 0.0, alpha),
            x_new=_where_conf(too_small, x, x_new),
            f1=torch.where(too_small, f0, f1))
        best = LineSearchResult(
            alpha=torch.where(done, best.alpha, res.alpha),
            x_new=_where_conf(done, best.x_new, res.x_new),
            f1=torch.where(done, best.f1, res.f1))
        alpha_next = torch.maximum(tmplam, 0.1 * alpha)
        # a finished pose keeps its alpha; the others move on
        step = ~done
        alpha2 = torch.where(step, alpha, alpha2)
        f2 = torch.where(step, f1, f2)
        alpha = torch.where(step & ~finish, alpha_next, alpha)
        done = done | finish
    return best


class BfgsResult(NamedTuple):
    x: Conf
    f0: torch.Tensor
    g: torch.Tensor


def _conf_store(c: Conf) -> torch.Tensor:
    """Conf -> flat (..., 7+T) storage row."""
    return torch.cat([c.position, c.orientation, c.torsions], dim=-1)


def conf_unstore(row, t: int) -> Conf:
    """Inverse of _conf_store."""
    return Conf(position=row[..., :3], orientation=row[..., 3:7],
                torsions=row[..., 7:7 + t])


def bfgs(f: Callable, x0: Conf, params: MinimizeParams,
         dof_mask=None, f_val: Optional[Callable] = None,
         traj_cap: int = 0, lazy_trials: bool = False):
    """Minimize f over pose DOF starting at x0 (bfgs.h:357-502).

    f: Conf (B, ...) -> (energy (B,), flat gradient (B, D)).
    f_val: optional forward-only energy (defaults to f's first output).
    lazy_trials: the fast line search evaluates a trial only where it is
    needed (fast_line_search), through f_val(confs, rows); the accurate
    one calls f_val(confs) on the whole batch.
    dof_mask: optional (D,) bool of active DOF (padded torsions False).
    A pose stops once its line search finds no step (alpha 0), its gradient
    is small (|g|^2 < 1e-4) or, with early_term, its energy moved by less
    than 1e-5; the loop ends when every pose has, or at maxiters.

    traj_cap > 0 (--outputmin, bfgs.h:244-310): also record each pose's
    conf at the start of every iteration it runs (at row min(step,
    traj_cap - 1)) and its last iterate after them, into a (B, traj_cap+1,
    7+T) history; returns (BfgsResult, hist, n_steps (B,)), where rows
    [i, i+1] for i < n_steps are the accepted-step endpoints that the
    reference interpolates minout.sdf frames between."""
    if f_val is None:
        def f_val(c):
            return f(c)[0]

    if params.type == "simple":
        # --simple_ascent (main.cpp:1189-1191, quasi_newton.cpp:76): the
        # legacy adaptive steepest descent instead of BFGS
        from gnina_tpu_torch.ops.ssd import SSDParams, ssd

        r = ssd(f, x0, SSDParams(evals=params.maxiters), dof_mask=dof_mask)
        return BfgsResult(x=r.x, f0=r.f0, g=r.g)
    if params.type not in ("fast", "accurate"):
        raise ValueError(f"unknown line search {params.type!r}")

    with torch.no_grad():
        f0_init, g_init = f(x0)
        b, d = g_init.shape
        dev = g_init.device
        if dof_mask is not None:
            g_init = torch.where(dof_mask, g_init, 0.0)
        eye = torch.eye(d, dtype=torch.float32, device=dev)
        if params.type == "accurate":
            line_search = accurate_line_search
        elif lazy_trials:
            line_search = functools.partial(fast_line_search, lazy=True)
        else:
            line_search = fast_line_search

        x, g, f0 = x0, g_init, f0_init
        h = eye.expand(b, d, d).clone()
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        cols = torch.arange(b, device=dev)
        nsteps = torch.zeros(b, dtype=torch.int64, device=dev)
        if traj_cap:
            hist = torch.zeros((b, traj_cap + 1, 7 + x0.torsions.shape[-1]),
                               dtype=torch.float32, device=dev)
        for step in range(params.maxiters):
            if bool(done.all()):
                break
            if traj_cap:
                row = torch.clamp(nsteps, max=traj_cap - 1)
                hist[cols, row] = torch.where(~done[:, None], _conf_store(x),
                                              hist[cols, row])
            p = -torch.einsum("bij,bj->bi", h, g)
            if dof_mask is not None:
                p = torch.where(dof_mask, p, 0.0)
            ls = line_search(f_val, x, g, f0, p)
            alpha = ls.alpha
            wrong_dir = alpha == 0.0
            # gradient at the accepted point (forward trials skipped it)
            _f1g, g_new = f(ls.x_new)
            if dof_mask is not None:
                g_new = torch.where(dof_mask, g_new, 0.0)
            g_new = torch.where(wrong_dir[:, None], 0.0, g_new)
            y = g_new - g

            f0_new = torch.where(wrong_dir, f0, ls.f1)
            x_new = _where_conf(wrong_dir, x, ls.x_new)
            g_next = torch.where(wrong_dir[:, None], g, g_new)
            small_grad = torch.sum(g_next * g_next, dim=-1) < 1e-4
            if params.early_term:
                small_grad = small_grad | (torch.abs(f0 - f0_new) < 1e-5)
            done_new = wrong_dir | small_grad

            # Hessian scaling on first step (bfgs.h:481-486)
            yy = torch.sum(y * y, dim=-1)
            yp = torch.sum(y * p, dim=-1)
            scale = torch.where(torch.abs(yy) > EPSILON_FL,
                                alpha * yp / torch.clamp(yy, min=EPSILON_FL),
                                1.0)
            if step == 0:
                h = eye * scale[:, None, None]

            # bfgs_update (bfgs.h:52-66)
            ok = alpha * yp >= EPSILON_FL
            minus_hy = -torch.einsum("bij,bj->bi", h, y)
            yhy = -torch.sum(y * minus_hy, dim=-1)
            r = 1.0 / torch.clamp(alpha * yp, min=EPSILON_FL)
            outer = (alpha * r)[:, None, None] * (
                minus_hy[:, :, None] * p[:, None, :]
                + p[:, :, None] * minus_hy[:, None, :])
            outer = outer + (alpha * alpha * (r * r * yhy + r))[
                :, None, None] * (p[:, :, None] * p[:, None, :])
            h_new = torch.where((ok & ~done_new)[:, None, None], h + outer, h)

            # a pose that was already done is frozen
            live = ~done
            x = _where_conf(live, x_new, x)
            g = torch.where(live[:, None], g_next, g)
            h = torch.where(live[:, None, None], h_new, h)
            f0 = torch.where(live, f0_new, f0)
            nsteps = nsteps + live.long()
            done = done | done_new

        # restore original if not improved (succeeds for NaN too), bfgs.h:491
        improved = f0 <= f0_init
        res = BfgsResult(x=_where_conf(improved, x, x0),
                         f0=torch.where(improved, f0, f0_init),
                         g=torch.where(improved[:, None], g, g_init))
        if traj_cap:
            n = torch.clamp(nsteps, max=traj_cap)
            hist[cols, n] = _conf_store(x)
            return res, hist, n
        return res
