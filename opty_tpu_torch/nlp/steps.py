"""Step functions of the interior-point solver, over a lane axis.

The counterpart of opty_tpu/nlp/steps.py: barrier diagonals, optimality
error, the monotone barrier ladder, Mehrotra probing and the stall
fallback, the regularized direction, the filter line search with its
second-order correction, and the elastic feasibility restoration.
Every array carries a leading lane axis B: vectors are (B, n), per-lane
scalars (B,).  JAX batches the solver with ``vmap`` over
``lax.while_loop``; here each data-dependent loop runs until no live
lane wants another pass, and each lane's carry updates through
``torch.where`` — the per-lane semantics vmap gives, so per-lane
iteration counts match the reference.  Each loop test is one host sync
(``.any()``).

Algorithmic provenance (Waechter-Biegler, Math. Prog. 106, 2006) and
the reasons behind every policy are documented at the JAX functions of
the same names.
"""

from typing import NamedTuple

import torch
from torch.func import jvp, vjp

from .ipm_types import Spec  # noqa: F401  (re-export for tests)

__all__ = [
    'BIG_SIGMA', 'FILTER_SIZE', 'masked_inv', 'push_inside', 'ftb_alpha',
    'fresh_filter', 'filter_ok', 'Diag', 'barrier_diagonals',
    'optimality_error', 'monotone_barrier_update', 'complementarity_average',
    'stall_fallback', 'regularized_direction', 'mehrotra_probe',
    'filter_line_search', 'slack_opt', 'restoration_solve',
    'RestorationOut', 'lane_where',
]

BIG_SIGMA = 1e30
FILTER_SIZE = 64


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _lane(mask, like):
    """Reshape a per-lane (B,) tensor to broadcast against ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def lane_where(mask, new, old):
    """Per-lane select over a tensor or (named) tuples of tensors: lane
    b takes ``new`` where ``mask[b]``, else ``old``."""
    if isinstance(new, torch.Tensor):
        return torch.where(_lane(mask, new), new, old)
    vals = [lane_where(mask, a, b) for a, b in zip(new, old)]
    return type(new)(*vals) if hasattr(new, '_fields') else tuple(vals)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def masked_inv(dist, mask):
    return torch.where(mask, 1.0 / torch.where(mask, dist, 1.0), 0.0)


def push_inside(v, lo, hi, has_lo, has_hi, k1, k2):
    """Ipopt-style initial point push into the strict interior."""
    both = has_lo & has_hi
    width = torch.where(both, hi - lo, 1.0)
    one = torch.ones_like(lo)
    pL = torch.where(both,
                     torch.minimum(k1 * torch.maximum(one, torch.abs(lo)),
                                   k2 * width),
                     k1 * torch.maximum(one, torch.abs(lo)))
    pU = torch.where(both,
                     torch.minimum(k1 * torch.maximum(one, torch.abs(hi)),
                                   k2 * width),
                     k1 * torch.maximum(one, torch.abs(hi)))
    v = torch.where(has_lo, torch.maximum(v, lo + pL), v)
    v = torch.where(has_hi, torch.minimum(v, hi - pU), v)
    return v


def ftb_alpha(dist, step, mask, tau):
    """Fraction-to-boundary per lane: max alpha in (0, 1] with
    dist + alpha * step >= (1 - tau) * dist on the masked coords.
    ``tau`` is (B,); returns (B,)."""
    neg = mask & (step < 0)
    ratio = torch.where(neg, -_lane(tau, dist) * dist
                        / torch.where(neg, step, -1.0), 1.0)
    return torch.clamp(torch.amin(ratio, dim=-1), max=1.0)


def fresh_filter(theta_max, dtype):
    """Empty filter per lane holding only the (theta_max, -inf) cap."""
    B = theta_max.shape[0]
    dev = theta_max.device
    f_theta = torch.full((B, FILTER_SIZE), torch.inf, dtype=dtype,
                         device=dev)
    f_phi = torch.full((B, FILTER_SIZE), torch.inf, dtype=dtype, device=dev)
    f_theta[:, 0] = theta_max
    f_phi[:, 0] = -torch.inf
    return f_theta, f_phi, torch.ones(B, dtype=torch.int32, device=dev)


def filter_ok(f_theta, f_phi, f_count, theta_t, phi_t):
    """Is (theta_t, phi_t) acceptable to each lane's filter?"""
    valid = torch.arange(FILTER_SIZE, device=f_theta.device)[None, :] \
        < f_count[:, None]
    return torch.all((theta_t[:, None] < f_theta)
                     | (phi_t[:, None] < f_phi) | ~valid, dim=-1)


# ---------------------------------------------------------------------------
# barrier diagonals
# ---------------------------------------------------------------------------

class Diag(NamedTuple):
    """Bound distances, their inverses, and the primal-dual barrier
    diagonals at one iterate."""
    dLx: torch.Tensor
    dUx: torch.Tensor
    dLs: torch.Tensor
    dUs: torch.Tensor
    iLx: torch.Tensor
    iUx: torch.Tensor
    iLs: torch.Tensor
    iUs: torch.Tensor
    SigL: torch.Tensor
    SigU: torch.Tensor
    SigsL: torch.Tensor
    SigsU: torch.Tensor
    sigma_x: torch.Tensor
    sigma_s: torch.Tensor
    Ds: torch.Tensor


def barrier_diagonals(spec: Spec, x, s, zL, zU, wL, wU) -> Diag:
    """Bound distances, inverse distances, and the condensed barrier
    diagonals Sigma_x / Sigma_s; ``Ds`` is the (2,2)-block diagonal of
    the condensed system (with BIG_SIGMA for free rows)."""
    dLx = torch.where(spec.mL, x - spec.xl, 1.0)
    dUx = torch.where(spec.mU, spec.xu - x, 1.0)
    dLs = torch.where(spec.msL, s - spec.cl, 1.0)
    dUs = torch.where(spec.msU, spec.cu - s, 1.0)
    iLx = masked_inv(dLx, spec.mL)
    iUx = masked_inv(dUx, spec.mU)
    iLs = masked_inv(dLs, spec.msL)
    iUs = masked_inv(dUs, spec.msU)
    SigL = zL * iLx
    SigU = zU * iUx
    sigma_x = SigL + SigU + torch.where(spec.fixed, BIG_SIGMA, 0.0)
    SigsL = wL * iLs
    SigsU = wU * iUs
    sigma_s = SigsL + SigsU
    Ds = torch.where(spec.eq, 0.0,
                     torch.where(spec.free_row, BIG_SIGMA,
                                 1.0 / torch.clamp(sigma_s, min=1e-30)))
    return Diag(dLx, dUx, dLs, dUs, iLx, iUx, iLs, iUs,
                SigL, SigU, SigsL, SigsU, sigma_x, sigma_s, Ds)


# ---------------------------------------------------------------------------
# optimality error and barrier updates
# ---------------------------------------------------------------------------

def optimality_error(spec: Spec, g, c, Jty, x, s, y, zL, zU, wL, wU, mu):
    """Ipopt's scaled KKT error E_mu from precomputed g, c, J^T y;
    ``mu`` is (B,).  Returns (E, inf_pr, inf_du), each (B,)."""
    opt = spec.opt
    n = x.shape[-1]
    m = c.shape[-1]
    mu_ = mu[:, None]
    r_dual_x = torch.where(spec.fixed, 0.0, g + Jty - zL + zU)
    r_dual_s = torch.where(spec.eq, 0.0, -y - wL + wU)
    inf_du = torch.maximum(torch.amax(torch.abs(r_dual_x), dim=-1),
                           torch.amax(torch.abs(r_dual_s), dim=-1))
    r_prim = c - s
    inf_pr = torch.amax(torch.abs(r_prim), dim=-1)
    dLx = torch.where(spec.mL, x - spec.xl, 1.0)
    dUx = torch.where(spec.mU, spec.xu - x, 1.0)
    dLs = torch.where(spec.msL, s - spec.cl, 1.0)
    dUs = torch.where(spec.msU, spec.cu - s, 1.0)
    comp = torch.cat([
        torch.where(spec.mL, zL * dLx - mu_, 0.0),
        torch.where(spec.mU, zU * dUx - mu_, 0.0),
        torch.where(spec.msL, wL * dLs - mu_, 0.0),
        torch.where(spec.msU, wU * dUs - mu_, 0.0)], dim=-1)
    inf_comp = torch.amax(torch.abs(comp), dim=-1)
    asum = lambda v: torch.sum(torch.abs(v), dim=-1)
    dual_l1 = asum(y) + asum(zL) + asum(zU) + asum(wL) + asum(wU)
    # Waechter-Biegler denominator m + n with n = primal variable
    # count including slacks (x and s in this formulation)
    sd = torch.clamp(dual_l1 / (m + (n + m)), min=opt.s_max) / opt.s_max
    z_l1 = asum(zL) + asum(zU) + asum(wL) + asum(wU)
    sc = torch.clamp(z_l1 / spec.n_comp, min=opt.s_max) / opt.s_max
    E = torch.maximum(torch.maximum(inf_du / sd, inf_pr), inf_comp / sc)
    return E, inf_pr, inf_du


def monotone_barrier_update(spec: Spec, mu, g, c, Jty, x, s, y,
                            zL, zU, wL, wU):
    """Fiacco-McCormick ladder: shrink mu (up to 4 times) while the
    barrier problem is solved to kappa_eps * mu.  Returns
    (mu, tau, shrunk), each (B,)."""
    opt = spec.opt
    tau = torch.zeros_like(mu)
    shrunk = torch.zeros(mu.shape, dtype=torch.bool, device=mu.device)
    floor = torch.full_like(mu, opt.tol / 11.0)
    for _ in range(4):
        E_mu, _, _ = optimality_error(
            spec, g, c, Jty, x, s, y, zL, zU, wL, wU, mu)
        shrink = (E_mu <= opt.kappa_eps * mu) & (mu > opt.tol / 11.0)
        new_mu = torch.maximum(floor, torch.minimum(opt.kappa_mu * mu,
                                                    mu ** opt.theta_mu))
        mu = torch.where(shrink, new_mu, mu)
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)
        shrunk = shrunk | shrink
    return mu, tau, shrunk


def complementarity_average(spec: Spec, x, s, zL, zU, wL, wU):
    """Average complementarity product over all finite bound/slack
    pairs (Mehrotra's mu_avg), per lane."""
    dLx = torch.where(spec.mL, x - spec.xl, 0.0)
    dUx = torch.where(spec.mU, spec.xu - x, 0.0)
    dLs = torch.where(spec.msL, s - spec.cl, 0.0)
    dUs = torch.where(spec.msU, spec.cu - s, 0.0)
    comp = (_dot(zL, dLx) + _dot(zU, dUx) + _dot(wL, dLs) + _dot(wU, dUs))
    return comp / spec.n_comp


def stall_fallback(spec: Spec, mono, in_rest, alpha, E_new, E_best,
                   free_stall):
    """Adaptive-mode stall detector: a probing lane that spends
    ``stall_window`` consecutive accepted iterations with a step below
    ``stall_alpha`` or an optimality error not beating its running best
    by (1 - ``stall_ratio``) falls back to the monotone ladder.

    Returns (free_stall_next, fall_now, E_best_next), each (B,)."""
    opt = spec.opt
    slow = ((~mono) & (~in_rest)
            & ((alpha < opt.stall_alpha)
               | (E_new > opt.stall_ratio * E_best)))
    free_stall_next = torch.where(slow, free_stall + 1,
                                  torch.zeros_like(free_stall))
    fall_now = (~mono) & (free_stall_next >= opt.stall_window)
    return free_stall_next, fall_now, torch.minimum(E_best, E_new)


# ---------------------------------------------------------------------------
# regularized direction computation
# ---------------------------------------------------------------------------

def regularized_direction(spec: Spec, fns, x, y, prep,
                          rx, rc, Ds, rhs_s_lad, sigma_x, sigma_s,
                          delta_w_prev, alpha_last, E_last, E_prev,
                          accept_count, mu_prev, live=None):
    """Direction solve with the inertia-free regularization retry
    ladder (see opty_tpu's regularized_direction for the policy).
    Factors once per trial; the final factorization is returned for
    reuse.  Trials repeat while any ``live`` lane (default: all) is not
    yet ok; finished lanes keep their values.

    Returns (dx, dy, ds, fac_used, delta_w_used, delta_c, dir_ok)."""
    opt = spec.opt
    fixed, eq = spec.fixed, spec.eq
    if live is None:
        live = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)

    def lag_grad(xx):
        _, vjp_fn = vjp(fns.constraints, xx)
        return fns.gradient(xx) + vjp_fn(y)[0]

    def compute_dir(delta_w, delta_c):
        fac = fns.kkt_factor(prep, sigma_x + delta_w[:, None],
                             Ds + delta_c[:, None], None)
        dxx, dyy, rres = fns.kkt_apply(fac, rx, rc)
        dxx = torch.where(fixed, 0.0, dxx)
        dss = Ds * (dyy + rhs_s_lad)
        dss = torch.where(eq, 0.0, dss)
        return dxx, dyy, dss, fac, rres

    def dir_quality(dxx, dyy, dss, delta_w, rres):
        finite = (torch.all(torch.isfinite(dxx), dim=-1)
                  & torch.all(torch.isfinite(dyy), dim=-1))
        # an exploding multiplier step flags a near-singular matrix
        dy_ok = torch.amax(torch.abs(dyy), dim=-1) <= opt.dy_cap
        healthy = finite & dy_ok
        # a trial counts only when the Newton system was actually solved
        solved = rres <= opt.eta_kkt_resid
        Wdx = fns.lagrangian_hvp(x, y, dxx) \
            if fns.lagrangian_hvp is not None \
            else jvp(lag_grad, (x,), (dxx,))[1]
        curv = (_dot(dxx, Wdx) + _dot(sigma_x * dxx, dxx)
                + delta_w * _dot(dxx, dxx)
                + _dot(sigma_s * dss, dss))
        nrm = _dot(dxx, dxx) + _dot(dss, dss)
        ok = healthy & solved & (curv >= opt.kappa_curv * nrm)
        return ok, healthy

    # delta_w schedule inputs (cross-iteration feedback; see opty_tpu)
    was_zero = delta_w_prev == 0.0
    good_step = alpha_last >= 0.9
    improving = E_last < 0.99 * E_prev
    bad_step = (alpha_last > 0.0) & (alpha_last < 1e-2) & ~improving
    freeze = (accept_count > 0) & ~improving
    decayed = torch.clamp(delta_w_prev * 0.33, min=opt.delta_w_min)
    if opt.dw_decay == 'hold':
        dw_default = torch.where(good_step, decayed, delta_w_prev)
    else:
        dw_default = decayed
    first_retry = torch.where(
        freeze & ~was_zero, delta_w_prev,
        torch.where(
            bad_step & ~was_zero,
            torch.clamp(delta_w_prev * 8.0, max=1e6),
            torch.where(
                was_zero,
                torch.full_like(delta_w_prev, opt.delta_w_init * 1e4),
                dw_default)))
    dc_seed = torch.clamp(1e-8 * mu_prev ** 0.25, min=opt.delta_c_init)

    zero = torch.zeros_like(delta_w_prev)
    dw, dc = zero, zero
    healthy = torch.ones_like(live)
    ok = torch.zeros_like(live)
    tries = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    carry = None
    active = torch.ones_like(live)      # trial 0 runs on every lane
    while True:
        growth = torch.where(was_zero | ~healthy, 100.0, 8.0)
        dw_candidate = torch.where(
            dw == 0.0, first_retry,
            torch.clamp(dw * growth, max=opt.delta_w_max))
        dc_only = (~healthy) & (dc == 0.0)
        dw_new = torch.where(dc_only, dw, dw_candidate)
        dc_new = torch.where(healthy, dc, dc_seed)
        first = tries == 0
        dw_new = torch.where(first, 0.0, dw_new)
        dc_new = torch.where(first, 0.0, dc_new)
        dxx, dyy, dss, fac, rres = compute_dir(dw_new, dc_new)
        ok_n, healthy_n = dir_quality(dxx, dyy, dss, dw_new, rres)
        new = (dxx, dyy, dss, fac, dw_new, dc_new, healthy_n, ok_n)
        carry = new if carry is None else lane_where(active, new, carry)
        _, _, _, _, dw, dc, healthy, ok = carry
        tries = torch.where(active, tries + 1, tries)
        active = (~ok) & (tries < 15) & live
        if not bool(active.any()):
            break

    dx, dy, ds, fac_used, delta_w_used, delta_c, _, dir_ok = carry
    dir_bad = ~dir_ok
    dx = lane_where(dir_bad, torch.zeros_like(dx), dx)
    dy = lane_where(dir_bad, torch.zeros_like(dy), dy)
    ds = lane_where(dir_bad, torch.zeros_like(ds), ds)
    return dx, dy, ds, fac_used, delta_w_used, delta_c, dir_ok


# ---------------------------------------------------------------------------
# Mehrotra probing barrier
# ---------------------------------------------------------------------------

def _step_to_boundary(dLx, dUx, dLs, dUs, dx, ds, spec, tau):
    """The largest primal step fraction the fraction-to-boundary rule
    allows along (dx, ds), per lane."""
    return torch.minimum(
        torch.minimum(ftb_alpha(dLx, dx, spec.mL, tau),
                      ftb_alpha(dUx, -dx, spec.mU, tau)),
        torch.minimum(ftb_alpha(dLs, ds, spec.msL, tau),
                      ftb_alpha(dUs, -ds, spec.msU, tau)))


def mehrotra_probe(spec: Spec, diag: Diag, zL, zU, wL, wU,
                   dx, ds, mu_prev, dir_bad):
    """Mehrotra-style probing mu from the affine (mu = 0) predictor
    (dx, ds): mu = clip((mu_aff / mu_avg)^3, 1e-4, 1) * mu_avg, capped
    at the carried mu (downward only) and held where the direction was
    rejected.  ``mu_prev`` and ``dir_bad`` are (B,)."""
    opt = spec.opt
    tau_p = torch.clamp(1.0 - mu_prev, min=opt.tau_min)
    dzLa = torch.where(spec.mL, -zL - diag.SigL * dx, 0.0)
    dzUa = torch.where(spec.mU, -zU + diag.SigU * dx, 0.0)
    dwLa = torch.where(spec.msL, -wL - diag.SigsL * ds, 0.0)
    dwUa = torch.where(spec.msU, -wU + diag.SigsU * ds, 0.0)
    a_pr_a = _step_to_boundary(diag.dLx, diag.dUx, diag.dLs, diag.dUs,
                               dx, ds, spec, tau_p)
    a_du_a = torch.minimum(
        torch.minimum(ftb_alpha(zL, dzLa, spec.mL, tau_p),
                      ftb_alpha(zU, dzUa, spec.mU, tau_p)),
        torch.minimum(ftb_alpha(wL, dwLa, spec.msL, tau_p),
                      ftb_alpha(wU, dwUa, spec.msU, tau_p)))
    a = torch.minimum(a_pr_a, a_du_a)[:, None]
    msum = lambda mk, v: torch.sum(torch.where(mk, v, 0.0), dim=-1)
    comp0 = (msum(spec.mL, zL * diag.dLx) + msum(spec.mU, zU * diag.dUx)
             + msum(spec.msL, wL * diag.dLs)
             + msum(spec.msU, wU * diag.dUs))
    comp_aff = (
        msum(spec.mL, (zL + a * dzLa) * (diag.dLx + a * dx))
        + msum(spec.mU, (zU + a * dzUa) * (diag.dUx - a * dx))
        + msum(spec.msL, (wL + a * dwLa) * (diag.dLs + a * ds))
        + msum(spec.msU, (wU + a * dwUa) * (diag.dUs - a * ds)))
    mu_avg = torch.clamp(comp0 / spec.n_comp, min=1e-300)
    mu_aff = torch.clamp(comp_aff, min=0.0) / spec.n_comp
    sigma_p = torch.clamp((mu_aff / mu_avg) ** 3, 1e-4, 1.0)
    mu_ad = torch.minimum(
        torch.clamp(sigma_p * mu_avg, min=opt.tol / 11.0), mu_prev)
    return torch.where(dir_bad, mu_prev, mu_ad)


# ---------------------------------------------------------------------------
# filter line search (the regular IPM step)
# ---------------------------------------------------------------------------

def _slog(d):
    return torch.sum(torch.log(torch.clamp(d, min=1e-30)), dim=-1)


def _all_pos(*ds_):
    ok = torch.all(ds_[0] > 0, dim=-1)
    for d in ds_[1:]:
        ok = ok & torch.all(d > 0, dim=-1)
    return ok


def _log_barrier(spec: Spec, x, s):
    """(sum of the logs of the bound distances, all distances > 0) at
    (x, s), per lane."""
    dL1 = torch.where(spec.mL, x - spec.xl, 1.0)
    dU1 = torch.where(spec.mU, spec.xu - x, 1.0)
    dL2 = torch.where(spec.msL, s - spec.cl, 1.0)
    dU2 = torch.where(spec.msU, spec.cu - s, 1.0)
    return (_slog(dL1) + _slog(dU1) + _slog(dL2) + _slog(dU2),
            _all_pos(dL1, dU1, dL2, dU2))


def filter_line_search(spec: Spec, fns, x, s, y, zL, zU, wL, wU,
                       diag: Diag, g, c, theta_now, theta_min,
                       mu, tau, dx, dy, ds, dir_bad,
                       fac_used, rx, rhs_s,
                       f_theta, f_phi, f_count,
                       theta_prev, stall_count_prev, live=None):
    """One regular filter-IPM step: fraction-to-boundary, filter
    acceptance of the full step, second-order correction (Ipopt A-5.7,
    with ``opt.use_soc``; a re-solve on ``fac_used``), backtracking,
    dual step, filter augmentation, restoration triggers.  The
    correction and the backtracking run while any ``live`` lane
    (default: all) wants them; the other lanes' results are the ones
    they would get alone.

    Returns (x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, f_theta, f_phi,
    f_count, enter_rest, alpha, stall_count)."""
    opt = spec.opt
    dtype = x.dtype
    eps_mach = torch.finfo(dtype).eps
    mL, mU, msL, msU = spec.mL, spec.mU, spec.msL, spec.msU
    fixed, eq = spec.fixed, spec.eq
    dLx, dUx, dLs, dUs = diag.dLx, diag.dUx, diag.dLs, diag.dUs
    iLx, iUx, iLs, iUs = diag.iLx, diag.iUx, diag.iLs, diag.iUs
    Ds = diag.Ds
    if live is None:
        live = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    mu_ = mu[:, None]

    # -- fraction to boundary --------------------------------------
    a_pr_max = _step_to_boundary(dLx, dUx, dLs, dUs, dx, ds, spec, tau)

    # -- filter line search ----------------------------------------
    # phi/theta at the current point from the carried residual c
    bar0 = _slog(dLx) + _slog(dUx) + _slog(dLs) + _slog(dUs)
    okb0 = _all_pos(dLx, dUx, dLs, dUs)
    phi0 = torch.where(okb0, fns.objective(x) - mu * bar0, torch.inf)
    theta0 = theta_now
    gphi_x = g - mu_ * iLx + mu_ * iUx
    gphi_s = -mu_ * iLs + mu_ * iUs
    Dphi = _dot(gphi_x, dx) + _dot(gphi_s, ds)

    neg = Dphi < 0
    amin_sw = torch.clamp(
        torch.minimum(
            opt.gamma_phi * theta0 / torch.clamp(-Dphi, min=1e-30),
            opt.delta_switch * theta0 ** opt.s_theta
            / torch.clamp((-Dphi) ** opt.s_phi, min=1e-30)),
        max=opt.gamma_theta)
    amin_ne = torch.clamp(opt.gamma_phi * theta0
                          / torch.clamp(-Dphi, min=1e-30),
                          max=opt.gamma_theta)
    alpha_min = opt.gamma_alpha * torch.where(
        neg & (theta0 <= theta_min), amin_sw,
        torch.where(neg, amin_ne, torch.full_like(theta0, opt.gamma_theta)))

    step_small = torch.amax(
        torch.abs(torch.cat([dx, ds], dim=-1))
        / (1.0 + torch.abs(torch.cat([x, s], dim=-1))), dim=-1
    ) < 10.0 * eps_mach

    def trial_point(alpha, dxx, dss):
        """phi, theta and the raw constraint residual at a trial point
        — one constraints evaluation shared by the filter tests, the
        theta comparison and the SOC residual."""
        xt = x + alpha[:, None] * dxx
        st_ = s + alpha[:, None] * dss
        bar, okt = _log_barrier(spec, xt, st_)
        rt = fns.constraints(xt) - st_
        phi_t = torch.where(okt, fns.objective(xt) - mu * bar, torch.inf)
        return phi_t, torch.sum(torch.abs(rt), dim=-1), rt

    def accept_tests(alpha, dxx, dss, phi_t, theta_t):
        f_ok = filter_ok(f_theta, f_phi, f_count, theta_t, phi_t)
        Dphi_d = _dot(gphi_x, dxx) + _dot(gphi_s, dss)
        sw = (Dphi_d < 0) & (alpha * (-Dphi_d) ** opt.s_phi
                             > opt.delta_switch
                             * theta0 ** opt.s_theta)
        armijo = phi_t <= phi0 + opt.eta_phi * alpha * Dphi_d \
            + 10.0 * eps_mach * torch.abs(phi0)
        curr_ok = ((theta_t <= (1.0 - opt.gamma_theta) * theta0)
                   | (phi_t <= phi0 - opt.gamma_phi * theta0))
        ftype = (theta0 <= theta_min) & sw
        return f_ok & torch.where(ftype, armijo, curr_ok), ftype & armijo

    def try_dir(alpha, dxx, dss):
        phi_t, theta_t, _ = trial_point(alpha, dxx, dss)
        return accept_tests(alpha, dxx, dss, phi_t, theta_t)

    phi_t1, theta_t1, r_trial1 = trial_point(a_pr_max, dx, ds)
    acc1, ftype1 = accept_tests(a_pr_max, dx, ds, phi_t1, theta_t1)
    acc1 = (acc1 | step_small) & ~dir_bad

    # -- second-order correction (Ipopt A-5.7) ---------------------
    # runs only while a live lane wants it; a lane that does not want
    # it gets no correction, as under the reference's lax.cond
    no = torch.zeros_like(acc1)
    dx_soc, dy_soc, ds_soc = dx, dy, ds
    acc_soc, ftype_soc = no, no
    a_soc = torch.zeros_like(a_pr_max)
    want_soc = (~acc1) & (theta_t1 >= theta0) & ~dir_bad & live
    if opt.use_soc and bool(want_soc.any()):
        # r_trial1 was evaluated for the full step's filter test: no
        # extra constraints evaluation; the matrix is the direction's,
        # so its factorization is reused
        c_soc = a_pr_max[:, None] * (c - s) + r_trial1
        rc_soc = -c_soc + Ds * rhs_s
        if fns.kkt_apply_soc is not None:
            dxx, dyy = fns.kkt_apply_soc(fac_used, rx, rc_soc)
        else:
            dxx, dyy, _ = fns.kkt_apply(fac_used, rx, rc_soc)
        dxx = torch.where(fixed, 0.0, dxx)
        dss = torch.where(eq, 0.0, Ds * (dyy + rhs_s))
        fin = torch.all(torch.isfinite(dxx), dim=-1) \
            & torch.all(torch.isfinite(dyy), dim=-1) & want_soc
        dx_soc = lane_where(fin, dxx, torch.zeros_like(dxx))
        dy_soc = lane_where(fin, dyy, torch.zeros_like(dyy))
        ds_soc = lane_where(fin, dss, torch.zeros_like(dss))
        a_soc = _step_to_boundary(dLx, dUx, dLs, dUs, dx_soc, ds_soc, spec,
                                  tau)
        acc_soc, ftype_soc = try_dir(a_soc, dx_soc, ds_soc)
        acc_soc = acc_soc & fin

    # -- backtracking fallback -------------------------------------
    # the loop starts pre-accepted when the full step or the SOC step
    # already passed
    alpha_bt = a_pr_max * 0.5
    j = torch.ones_like(f_count)
    acc_bt = acc1 | acc_soc
    ftype_bt = torch.zeros_like(acc1)
    active = (~acc_bt) & (j < opt.max_ls) & (alpha_bt >= alpha_min) & live
    while bool(active.any()):
        acc, is_ftype = try_dir(alpha_bt, dx, ds)
        acc = acc | step_small
        alpha_bt = torch.where(active & ~acc, alpha_bt * 0.5, alpha_bt)
        j = torch.where(active, j + 1, j)
        acc_bt = torch.where(active, acc, acc_bt)
        ftype_bt = torch.where(active, is_ftype, ftype_bt)
        active = (~acc_bt) & (j < opt.max_ls) & (alpha_bt >= alpha_min) \
            & live
    acc_bt = acc_bt & ~(acc1 | acc_soc) & ~dir_bad

    use_soc = (~acc1) & acc_soc
    use_bt = (~acc1) & (~use_soc) & acc_bt
    accepted = acc1 | use_soc | use_bt
    alpha = torch.where(acc1, a_pr_max,
                        torch.where(use_soc, a_soc,
                                    torch.where(use_bt, alpha_bt, 0.0)))
    dx = lane_where(use_soc, dx_soc, dx)
    dy = lane_where(use_soc, dy_soc, dy)
    ds = lane_where(use_soc, ds_soc, ds)
    was_ftype = torch.where(acc1, ftype1,
                            torch.where(use_soc, ftype_soc, ftype_bt))

    # dual directions & step
    a_ = alpha[:, None]
    dzL = torch.where(mL, mu_ * iLx - zL - diag.SigL * dx, 0.0)
    dzU = torch.where(mU, mu_ * iUx - zU + diag.SigU * dx, 0.0)
    dwL = torch.where(msL, mu_ * iLs - wL - diag.SigsL * ds, 0.0)
    dwU = torch.where(msU, mu_ * iUs - wU + diag.SigsU * ds, 0.0)
    a_du = torch.minimum(
        torch.minimum(ftb_alpha(zL, dzL, mL, tau),
                      ftb_alpha(zU, dzU, mU, tau)),
        torch.minimum(ftb_alpha(wL, dwL, msL, tau),
                      ftb_alpha(wU, dwU, msU, tau)))[:, None]

    x_n = x + a_ * dx
    s_n = s + a_ * ds
    y_n = y + a_ * dy
    zL_n = zL + a_du * dzL
    zU_n = zU + a_du * dzU
    wL_n = wL + a_du * dwL
    wU_n = wU + a_du * dwU

    # filter augmentation for accepted non-f-type steps
    augment = accepted & ~was_ftype & ~step_small
    slot = torch.clamp(f_count, max=FILTER_SIZE - 1).long()[:, None]
    fth = torch.where(augment[:, None], f_theta.scatter(
        1, slot, ((1.0 - opt.gamma_theta) * theta0)[:, None]), f_theta)
    fph = torch.where(augment[:, None], f_phi.scatter(
        1, slot, (phi0 - opt.gamma_phi * theta0)[:, None]), f_phi)
    fcn = torch.where(augment, torch.clamp(f_count + 1, max=FILTER_SIZE - 1),
                      f_count)

    # -- restoration triggers --------------------------------------
    # (a) line search failed; (b) theta stagnates far from
    # feasibility; (c) duals blow up (degenerate subproblem)
    stall = (theta0 > 1e3 * theta_min) & (theta0 > 0.9995 * theta_prev)
    stall_count = torch.where(accepted & stall, stall_count_prev + 1,
                              torch.zeros_like(stall_count_prev))
    y_blown = torch.amax(torch.abs(y_n), dim=-1) > 1e10
    enter_rest = (~accepted) | (((stall_count >= 25) | y_blown)
                                & (theta0 > theta_min))
    y_n = torch.where((enter_rest & y_blown)[:, None], 0.0, y_n)

    return (x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, fth, fph, fcn,
            enter_rest, alpha, stall_count)


# ---------------------------------------------------------------------------
# feasibility restoration: a full inner solver (W-B A-9)
# ---------------------------------------------------------------------------

def slack_opt(spec: Spec, c, s, mu_R, rho_R):
    """Row-wise exact slack optimum of the elastic restoration NLP at
    fixed x: per row, minimize smoothedL1(c - s) - mu_R [log(s - cl) +
    log(cu - s)] by 12 safeguarded scalar Newton steps.  ``mu_R`` is
    (B,).  eq rows return cl, free rows c.

    As in the reference, the interiority margin mu_R / (4 rho_R) is not
    capped by the row's width, so on a row narrower than twice the
    margin the two clamps cross."""
    msL, msU, eq, free_row = spec.msL, spec.msU, spec.eq, spec.free_row
    mu = mu_R[:, None]
    margin = torch.clamp(mu / (4.0 * rho_R), min=1e-14)

    def clampf(v):
        v = torch.where(msL, torch.maximum(v, spec.cl + margin), v)
        v = torch.where(msU, torch.minimum(v, spec.cu - margin), v)
        return v

    sv = clampf(torch.where(eq, spec.cl, torch.where(free_row, c, s)))
    for _ in range(12):
        r = c - sv
        S = torch.sqrt((rho_R * r) ** 2 + mu ** 2)
        n_el = (mu - rho_R * r + S) / (2.0 * rho_R)
        p_el = n_el + r
        y_imp = rho_R - mu / torch.clamp(p_el, min=1e-30)
        dp = 0.5 * (1.0 + rho_R * r / S)
        dy = mu * dp / torch.clamp(p_el, min=1e-30) ** 2
        iL = masked_inv(torch.where(msL, sv - spec.cl, 1.0), msL)
        iU = masked_inv(torch.where(msU, spec.cu - sv, 1.0), msU)
        # F'(s) = -y_imp - mu_R/(s-cl) + mu_R/(cu-s); F'' > 0
        Fp = -y_imp - mu * iL + mu * iU
        Fpp = dy + mu * iL ** 2 + mu * iU ** 2
        sv = clampf(sv - Fp / torch.clamp(Fpp, min=1e-30))
    return torch.where(eq, spec.cl, torch.where(free_row, c, sv))


class RestorationOut(NamedTuple):
    """Result of one restoration visit (an inner solve), per lane."""
    x: torch.Tensor
    s: torch.Tensor
    theta: torch.Tensor        # final infeasibility (L1)
    iters: torch.Tensor        # inner iterations consumed
    success: torch.Tensor      # exited filter-acceptable and reduced
    certified: torch.Tensor    # first-order local-infeasibility proof
    kick: torch.Tensor         # exited stuck far from feasibility


def restoration_solve(spec: Spec, fns, x0, s0, c0, mu, live,
                      f_theta, f_phi, f_count, theta_min,
                      max_inner=None, kappa=None) -> RestorationOut:
    """Feasibility restoration as its own inner solver (Waechter-
    Biegler A-9; see opty_tpu's restoration_solve for the design): a
    damped Gauss-Newton descent on the elastic merit

        rho (p + n) + zeta/2 |D_R (x - x_R)|^2
        - mu_R [sum log(bound distances) + log p + log n]

    with (p, n) re-eliminated in closed form after every step, its own
    barrier ladder on mu_R, an elastic step backtracked on the merit
    with a steepest-descent fallback, and the exits of the reference:
    theta reduced below kappa * theta_entry at a point acceptable to
    the regular filter, a first-order local-infeasibility certificate,
    or the visit's time box (``max_inner``, default
    ``opt.max_rest_visit``) with the kick flag.

    Every argument carries the lane axis B (``kappa`` (B,) or None);
    the inner loop runs until no lane is running, and a lane's carry
    updates only while it runs, so each lane's iterates are its own.
    ``live=False`` lanes exit at once with their inputs.  As in the
    reference, a non-finite Gauss-Newton step still runs its 15 merit
    backtracks (from a zero step)."""
    opt = spec.opt
    dtype = x0.dtype
    mL, mU, msL, msU = spec.mL, spec.mU, spec.msL, spec.msU
    fixed, eq, free_row = spec.fixed, spec.eq, spec.free_row
    rho_R = 1000.0
    if max_inner is None:
        max_inner = opt.max_rest_visit
    if kappa is None:
        kappa = torch.full_like(theta_min, opt.rest_reduction)
    live = torch.as_tensor(live, dtype=torch.bool, device=x0.device)
    if live.ndim == 0:
        live = live.expand(x0.shape[0]).clone()

    prepare_gn = fns.kkt_prepare_gn
    if prepare_gn is None:
        prepare_gn = lambda xx: fns.kkt_prepare(xx, torch.zeros_like(c0))

    x_R = x0
    dR2 = 1.0 / torch.clamp(torch.abs(x_R), min=1.0) ** 2
    mu_floor = opt.tol
    mu_R0 = torch.clamp(
        torch.maximum(mu, torch.amax(torch.abs(c0 - s0), dim=-1)),
        mu_floor, 1e2)
    lane = lambda v: v[:, None]

    def rest_merit(xt, st_, mu_R, zeta_R):
        """Elastic merit at (xt, st_) and its theta, per lane."""
        rt = fns.constraints(xt) - st_
        m = lane(mu_R)
        St = torch.sqrt((rho_R * rt) ** 2 + m ** 2)
        nt = (m - rho_R * rt + St) / (2.0 * rho_R)
        pt = nt + rt
        elas = (torch.sum(rho_R * (pt + nt), dim=-1)
                - mu_R * (_slog(pt) + _slog(nt)))
        bar, okb = _log_barrier(spec, xt, st_)
        prox = 0.5 * zeta_R * _dot(dR2 * (xt - x_R), xt - x_R)
        theta_t = torch.sum(torch.abs(rt), dim=-1)
        return torch.where(okb, elas - mu_R * bar + prox, torch.inf), theta_t

    def body(carry):
        (x, s, c, mu_R, tr, j, stall, E_prev_R, theta_goal, run,
         success, certified, kick) = carry
        m = lane(mu_R)
        # slacks at their exact per-row optimum for (x, mu_R)
        s = slack_opt(spec, c, s, mu_R, rho_R)
        r = c - s
        theta_now = torch.sum(torch.abs(r), dim=-1)
        theta_goal = torch.where(
            theta_goal < 0.0,
            torch.maximum(kappa * theta_now, theta_min), theta_goal)

        # -- distances and elastic quantities at the current point --
        dLx = torch.where(mL, x - spec.xl, 1.0)
        dUx = torch.where(mU, spec.xu - x, 1.0)
        dLs = torch.where(msL, s - spec.cl, 1.0)
        dUs = torch.where(msU, spec.cu - s, 1.0)
        iLx = masked_inv(dLx, mL)
        iUx = masked_inv(dUx, mU)
        iLs = masked_inv(dLs, msL)
        iUs = masked_inv(dUs, msU)
        S_el = torch.sqrt((rho_R * r) ** 2 + m ** 2)
        n_el = (m - rho_R * r + S_el) / (2.0 * rho_R)
        p_el = n_el + r
        y_imp = rho_R - m / torch.clamp(p_el, min=1e-30)
        sigma_sR = m * (iLs ** 2 + iUs ** 2)
        DsR = torch.where(eq, 0.0,
                          torch.where(free_row, BIG_SIGMA,
                                      1.0 / torch.clamp(sigma_sR,
                                                        min=1e-30)))
        rhs_sR = torch.where(eq, 0.0, y_imp + m * iLs - m * iUs)
        zeta_R = torch.sqrt(mu_R)        # Ipopt's fixed prox weight
        z = lane(zeta_R)
        sigma_xR = (m * (iLx ** 2 + iUx ** 2) + z * dR2
                    + torch.where(fixed, BIG_SIGMA, 0.0))
        _, vjp_x = vjp(fns.constraints, x)
        Jty_imp = vjp_x(y_imp)[0]
        rx_rest = torch.where(fixed, 0.0,
                              -(z * dR2 * (x - x_R) + Jty_imp
                                - m * iLx + m * iUx))
        rc_rest = DsR * rhs_sR     # c - s - p + n = 0 by construction

        # -- damped Gauss-Newton step (condensed elastic system) ----
        prep = prepare_gn(x)
        Dp_el = p_el ** 2 / m
        Dn_el = n_el ** 2 / m
        fac = fns.kkt_factor(prep, sigma_xR, DsR + Dp_el + Dn_el, True)
        dxr, dyr, _ = fns.kkt_apply(fac, rx_rest, rc_rest)
        dxr = torch.where(fixed, 0.0, dxr)
        dsr = torch.where(eq, 0.0, DsR * (dyr + rhs_sR))
        fin = (torch.all(torch.isfinite(dxr), dim=-1)
               & torch.all(torch.isfinite(dsr), dim=-1)
               & (torch.amax(torch.abs(dyr), dim=-1) <= opt.dy_cap))
        dxr = lane_where(fin, dxr, torch.zeros_like(dxr))
        dsr = lane_where(fin, dsr, torch.zeros_like(dsr))

        # merit at the current point, from already-known pieces
        M0 = (torch.sum(rho_R * (p_el + n_el), dim=-1)
              - mu_R * (_slog(p_el) + _slog(n_el))
              - mu_R * (_slog(dLx) + _slog(dUx) + _slog(dLs) + _slog(dUs))
              + 0.5 * zeta_R * _dot(dR2 * (x - x_R), x - x_R))
        tau_R = torch.clamp(1.0 - mu_R, min=opt.tau_min)

        def backtrack(dxx, dss, a0, gate):
            a = a0
            jj = torch.zeros_like(j)
            ok = torch.zeros_like(run)
            th = torch.full_like(a0, torch.inf)
            active = gate
            while bool(active.any()):
                Mt, th_n = rest_merit(x + lane(a) * dxx, s + lane(a) * dss,
                                      mu_R, zeta_R)
                ok_n = Mt <= M0 - 1e-12 * torch.abs(M0)
                a = torch.where(active & ~ok_n, a * 0.5, a)
                jj = torch.where(active, jj + 1, jj)
                ok = torch.where(active, ok_n, ok)
                th = torch.where(active, th_n, th)
                active = (~ok) & (jj < 15) & gate
            return a, ok, th

        # trust-radius cap on the starting step length (``tr`` carries
        # the step scale that worked recently)
        el_len = torch.clamp(torch.amax(torch.abs(dxr), dim=-1), min=1e-30)
        a0_el = torch.minimum(
            _step_to_boundary(dLx, dUx, dLs, dUs, dxr, dsr, spec, tau_R),
            tr / el_len)
        a_el, red_el, th_el = backtrack(dxr, dsr, a0_el, run)
        use_el = fin & red_el

        # steepest-descent fallback on the same merit (its exact
        # negative gradient is (rx_rest, rhs_sR))
        dx_c = rx_rest
        ds_c = torch.where(eq, 0.0, rhs_sR)
        scale_c = 1.0 / torch.clamp(
            torch.maximum(torch.amax(torch.abs(dx_c), dim=-1),
                          torch.amax(torch.abs(ds_c), dim=-1)), min=1.0)
        dx_c = dx_c * lane(scale_c)
        ds_c = ds_c * lane(scale_c)
        a0_c = torch.minimum(
            _step_to_boundary(dLx, dUx, dLs, dUs, dx_c, ds_c, spec, tau_R),
            tr)
        a_c, red_c, th_c = backtrack(dx_c, ds_c, a0_c, run & ~use_el)

        a_use = torch.where(use_el, a_el, a_c)
        dx_use = lane_where(use_el, dxr, dx_c)
        ds_use = lane_where(use_el, dsr, ds_c)
        reduced = use_el | red_c
        x_n = lane_where(reduced, x + lane(a_use) * dx_use, x)
        s_n = lane_where(reduced, s + lane(a_use) * ds_use, s)
        theta_r = torch.where(use_el, th_el,
                              torch.where(red_c, th_c, theta_now))
        c_n = lane_where(reduced, fns.constraints(x_n), c)

        # trust-radius adaptation: accepted at the first trial grows it,
        # a backtracked acceptance sets twice the length that worked,
        # total failure quarters it
        L_taken = a_use * torch.clamp(
            torch.amax(torch.abs(dx_use), dim=-1), min=1e-30)
        first_ok = (use_el & (a_el >= 0.99 * a0_el)) \
            | ((~use_el) & red_c & (a_c >= 0.99 * a0_c))
        tr_n = torch.where(first_ok, tr * 2.5,
                           torch.where(reduced, 2.0 * L_taken, tr * 0.25))
        tr_n = torch.clamp(tr_n, 1e-9, 1e6)

        # first-order certificate of the feasibility problem: the
        # x-gradient of 0.5||c - s||^2 (s sits at its per-row optimum)
        gx = torch.where(fixed, 0.0, vjp_x(r)[0])
        feas_grad = torch.sqrt(_dot(gx, gx))
        grad_cert = (feas_grad <= 1e-6 * torch.clamp(theta_r, min=1.0)) \
            & (theta_r > theta_min)

        # -- restoration barrier ladder: shrink when the rung is solved
        # or when theta and the rung's own error both stall
        E_R = torch.maximum(
            torch.amax(torch.abs(rx_rest), dim=-1),
            torch.amax(torch.abs(torch.where(eq, 0.0, rhs_sR)), dim=-1))
        no_prog = theta_r > 0.999 * theta_now
        no_prog_E = E_R > 0.9 * E_prev_R
        do_shrink = (E_R <= opt.kappa_eps * mu_R) | (no_prog & no_prog_E)
        can_shrink = mu_R > 1.001 * mu_floor
        sharpened = do_shrink & can_shrink
        mu_R_n = torch.where(
            sharpened,
            torch.clamp(torch.minimum(0.2 * mu_R, mu_R ** 1.5),
                        min=mu_floor),
            mu_R)
        stall_n = torch.where(no_prog & ~sharpened, stall + 1,
                              torch.zeros_like(stall))
        stuck = ((~reduced) & ~sharpened) | (stall_n >= 5)
        # second certificate: the restoration NLP solved to its own
        # optimality at a small smoothing with theta still large
        ladder_cert = (E_R <= 1e-6 * rho_R) \
            & (mu_R <= 1e-3 * torch.clamp(theta_r, min=1.0)) \
            & (theta_r > theta_min)
        certified_now = grad_cert | ladder_cert

        # -- A-9 return condition: theta below the goal at a point the
        # regular filter accepts at the regular barrier
        bar_reg, okb = _log_barrier(spec, x_n, s_n)
        phi_reg = torch.where(okb, fns.objective(x_n) - mu * bar_reg,
                              torch.inf)
        acc_reg = filter_ok(f_theta, f_phi, f_count, theta_r, phi_reg)
        success_now = ((theta_r <= theta_goal) & acc_reg) \
            | (theta_r <= opt.tol)

        j_n = j + 1
        timed_out = j_n >= max_inner
        cert_exit = stuck & certified_now
        kick_now = ((stuck & ~certified_now) | timed_out) \
            & ~success_now & (theta_r > 1e2 * theta_min)
        run_n = run & ~(success_now | stuck | timed_out)

        if opt.trace or opt.debug:
            print('REST j={} muR={:.1e} th={:.3e} E_R={:.2e} a={:.1e} el={} '
                  'tr={:.1e} (lane 0)'.format(
                      int(j[0]), float(mu_R[0]), float(theta_r[0]),
                      float(E_R[0]), float(a_use[0]), bool(use_el[0]),
                      float(tr[0])))

        return (x_n, s_n, c_n, mu_R_n, tr_n, j_n, stall_n, E_R,
                theta_goal, run_n,
                success | (success_now & ~run_n & run),
                certified | (cert_exit & run),
                kick | (kick_now & run))

    no = torch.zeros_like(live)
    carry = (x0, s0, c0, mu_R0, torch.full_like(mu_R0, 1e3),
             torch.zeros(live.shape, dtype=torch.int32, device=x0.device),
             torch.zeros(live.shape, dtype=torch.int32, device=x0.device),
             torch.full_like(mu_R0, torch.inf),
             torch.full_like(mu_R0, -1.0), live, no, no, no)
    while bool(carry[9].any()):
        carry = lane_where(carry[9], body(carry), carry)
    (x_f, s_f, c_f, _, _, j_f, _, _, _, _, success, certified,
     kick) = carry
    theta_f = torch.sum(torch.abs(c_f - s_f), dim=-1)
    return RestorationOut(x=x_f, s=s_f, theta=theta_f, iters=j_f,
                          success=success, certified=certified, kick=kick)
