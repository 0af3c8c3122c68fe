"""Batched primal-dual interior-point NLP solver in PyTorch.

The counterpart of opty_tpu/nlp/ipm.py (Ipopt's filter line-search
interior-point method, Waechter & Biegler, Math. Prog. 106, 2006), with
every option of the reference: Mehrotra-probing (adaptive) or monotone
barrier updates with the stall fallback, the inertia-free
regularization ladder, the filter line search with second-order
correction, the feasibility restoration phase (an inner damped
Gauss-Newton solve, steps.restoration_solve), the least-squares
multiplier initialization, and chunked / refilled execution
(``resume_state``, ``iter_budget``, ``return_state``, ``refill``).

Every state field carries a leading lane axis B (``solve`` is B = 1).
JAX vmaps ``lax.while_loop``; here the iteration loop runs until no
lane is live, and each lane's state updates through ``torch.where``,
so each lane follows exactly the iterates it would follow alone.  A
restoration visit runs on the lanes that enter it only: they are
gathered (``IPMFunctions.take_lanes`` gathers the functions' per-lane
data), solved and scattered back.
"""

import torch
from torch.func import grad, hessian, jacrev, vjp, vmap

from . import steps
from .ipm_types import (IPMFunctions, IPMOptions, IPMResult, IPMState,
                        Spec)
from .status import (INFEASIBLE_PROBLEM_DETECTED, INVALID_NUMBER_DETECTED,
                     MAXIMUM_ITERATIONS_EXCEEDED, RESTORATION_FAILED,
                     SOLVE_SUCCEEDED, SOLVED_TO_ACCEPTABLE_LEVEL)

__all__ = ['IPMOptions', 'IPMFunctions', 'IPMResult', 'IPMState',
           'solve_ipm', 'make_nlp_functions_dense']


def _lanes(v, B, dtype, device):
    v = torch.as_tensor(v, dtype=dtype, device=device)
    return v.expand((B,) + tuple(v.shape[-1:])) if v.ndim < 2 else v


def solve_ipm(fns: IPMFunctions, x0, xl, xu, cl, cu,
              options: IPMOptions = IPMOptions(),
              y0=None, zL0=None, zU0=None,
              resume_state=None, iter_budget=None, return_state=False,
              refill=None):
    """Solve B instances of the NLP from ``x0`` (B, n).

    Bounds are (n,)/(m,) or per lane (B, n)/(B, m).  ``resume_state``
    resumes a returned state; ``iter_budget`` bounds the further
    iterations of each lane; ``refill`` ((B,) bool, with
    ``resume_state``) restarts the marked lanes fresh from ``x0`` and
    resumes the others (Problem.solve_queue)."""
    opt = options
    x0 = torch.as_tensor(x0)
    dtype, device = x0.dtype, x0.device
    B, n = x0.shape
    xl = _lanes(xl, B, dtype, device)
    xu = _lanes(xu, B, dtype, device)
    cl = _lanes(cl, B, dtype, device)
    cu = _lanes(cu, B, dtype, device)
    m = cl.shape[-1]

    inf_cut = 1e18
    has_xl = xl > -inf_cut
    has_xu = xu < inf_cut
    fixed = has_xl & has_xu & (xu - xl <= 0.0)
    mL = has_xl & ~fixed
    mU = has_xu & ~fixed
    has_sl = cl > -inf_cut
    has_su = cu < inf_cut
    eq = has_sl & has_su & (cu - cl <= 0.0)
    msL = has_sl & ~eq
    msU = has_su & ~eq
    free_row = ~eq & ~msL & ~msU

    # keep the user's bounds for the final projection, then relax all
    # working bounds (IPMOptions.bound_relax_factor)
    xl_orig, xu_orig = xl, xu
    brf = opt.bound_relax_factor
    if brf:
        relax = lambda b: brf * torch.clamp(torch.abs(b), min=1.0)
        xl = torch.where(mL, xl - relax(xl), xl)
        xu = torch.where(mU, xu + relax(xu), xu)
        cl = torch.where(msL, cl - relax(cl), cl)
        cu = torch.where(msU, cu + relax(cu), cu)
    count = lambda mk: torch.sum(mk, dim=-1).to(dtype)
    n_duals = count(mL) + count(mU) + count(msL) + count(msU)
    n_comp = torch.clamp(n_duals, min=1.0)

    spec = Spec(opt=opt, xl=xl, xu=xu, cl=cl, cu=cu, fixed=fixed,
                mL=mL, mU=mU, eq=eq, msL=msL, msU=msU,
                free_row=free_row, n_comp=n_comp, n_duals=n_duals)
    lane_vec = lambda v: torch.full((B,), v, dtype=dtype, device=device)
    lane_int = lambda v: torch.full((B,), v, dtype=torch.int32,
                                    device=device)
    lane_bool = lambda v: torch.full((B,), v, dtype=torch.bool,
                                     device=device)

    def eval_point(x, y):
        if fns.eval_point is not None:
            return fns.eval_point(x, y)
        g = fns.gradient(x)
        c, vjp_fn = vjp(fns.constraints, x)
        return g, c, vjp_fn(y)[0]

    def fresh_state():
        x_init = torch.where(fixed, xl, steps.push_inside(
            x0, xl, xu, has_xl, has_xu, opt.bound_push, opt.bound_frac))
        c0 = fns.constraints(x_init)
        s_init = torch.where(eq, cl, steps.push_inside(
            c0, cl, cu, has_sl, has_su, opt.slack_push, opt.bound_frac))
        # central-path floor for inequality slacks (see opty_tpu)
        width = torch.where(msL & msU, cu - cl, torch.inf)
        floor_d = torch.clamp(0.25 * width, max=opt.mu_init)
        s_init = torch.where(msL, torch.maximum(s_init, cl + floor_d),
                             s_init)
        s_init = torch.where(msU, torch.minimum(s_init, cu - floor_d),
                             s_init)
        one = torch.ones_like(x_init)
        zL_init = torch.where(mL, one if zL0 is None else
                              _lanes(zL0, B, dtype, device), 0.0)
        zU_init = torch.where(mU, one if zU0 is None else
                              _lanes(zU0, B, dtype, device), 0.0)
        wL_init = torch.where(msL, 1.0, torch.zeros_like(s_init))
        wU_init = torch.where(msU, 1.0, torch.zeros_like(s_init))
        if y0 is not None:
            y_init = _lanes(y0, B, dtype, device)
        else:
            # Waechter-Biegler eq (36): least-squares equality
            # multipliers from the dual-feasibility rows, solved with
            # the structured factorization ([[I, J^T], [J, -eps]]),
            # kept only for near-feasible starts with plausible size
            g0_ls = fns.gradient(x_init)
            prep0 = fns.kkt_prepare(x_init, torch.zeros_like(c0))
            sigma0 = one + torch.where(fixed, steps.BIG_SIGMA, 0.0)
            ds0 = torch.full_like(c0, 1e-8)
            rx0 = torch.where(fixed, 0.0, -(g0_ls - zL_init + zU_init))
            rc0 = torch.zeros_like(c0)
            fac0_ls = fns.kkt_factor(prep0, sigma0, ds0, True)
            _, y_ls, _ = fns.kkt_apply(fac0_ls, rx0, rc0)
            y_ok = ((torch.amax(torch.abs(y_ls), dim=-1) <= 1e3)
                    & torch.all(torch.isfinite(y_ls), dim=-1)
                    & (torch.amax(torch.abs(c0 - s_init), dim=-1) <= 1e-3))
            y_init = torch.where(y_ok[:, None], y_ls, 0.0)

        theta_init = torch.sum(torch.abs(c0 - s_init), dim=-1)
        theta_max_init = 1e4 * torch.clamp(theta_init, min=1.0)
        theta_min_init = 1e-4 * torch.clamp(theta_init, min=1.0)
        ft_i, fp_i, fc_i = steps.fresh_filter(theta_max_init, dtype)
        g_i, c_i, Jty_i = eval_point(x_init, y_init)
        return IPMState(
            x=x_init, s=s_init, y=y_init, zL=zL_init, zU=zU_init,
            wL=wL_init, wU=wU_init,
            mu=lane_vec(opt.mu_init), delta_w=lane_vec(0.0),
            delta_c=lane_vec(0.0),
            f_theta=ft_i, f_phi=fp_i, f_count=fc_i,
            rest_total=lane_int(0),
            rest_depth=lane_vec(opt.rest_reduction),
            last_rest_it=lane_int(-1000),
            theta_prev=lane_vec(torch.inf), stall_count=lane_int(0),
            theta_min=theta_min_init, theta_max=theta_max_init,
            mono=lane_bool(False), free_stall=lane_int(0),
            E_best=lane_vec(torch.inf),
            it=lane_int(0), status=lane_int(MAXIMUM_ITERATIONS_EXCEEDED),
            done=lane_bool(False), accept_count=lane_int(0),
            obj_history=torch.full((B, opt.max_iter), torch.nan,
                                   dtype=dtype, device=device),
            inf_pr=lane_vec(torch.inf), inf_du=lane_vec(torch.inf),
            alpha_last=lane_vec(0.0), E_last=lane_vec(torch.inf),
            E_prev=lane_vec(torch.inf),
            g=g_i, c=c_i, Jty=Jty_i)

    adaptive = opt.mu_strategy == 'adaptive'

    def restore(st, live, enter_rest, kappa_eff, mu, delta_w, step):
        """The restoration branch (reference ipm.py rest_branch) on the
        live lanes that enter it, gathered and scattered back; the other
        lanes keep ``step``, the regular step's (x, s, y, zL, zU, wL,
        wU, f_theta, f_phi, f_count).  Returns (step, rest_iters,
        rest_failed, mu, delta_w)."""
        rest_iters = torch.zeros_like(st.rest_total)
        rest_failed = torch.zeros_like(live)
        go = enter_rest & live
        if opt.max_rest_visit == 0 or not bool(go.any()):
            return step, rest_iters, rest_failed, mu, delta_w
        idx = torch.nonzero(go).squeeze(-1)
        take = lambda t: t[idx]
        sp = Spec(*[take(f) if isinstance(f, torch.Tensor) else f
                    for f in spec])
        sub = fns if fns.take_lanes is None else fns.take_lanes(idx)
        x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, f_theta_n, f_phi_n, \
            f_count_n = step
        mu_r = take(mu)
        # restoration starts from the current iterate with its carried
        # constraint value (the point whose search failed)
        ro = steps.restoration_solve(
            sp, sub, take(st.x), take(st.s), take(st.c), mu_r,
            torch.ones_like(idx, dtype=torch.bool), take(f_theta_n),
            take(f_phi_n), take(f_count_n), take(st.theta_min),
            kappa=take(kappa_eff))
        # exit state: equality multipliers reset, bound duals recentered
        # on the barrier kicked (capped at mu_init) where the visit
        # ended stuck, and a fresh filter whose re-admitted
        # infeasibility is capped at a multiple of the restored level
        mu_o = torch.where(
            ro.kick,
            torch.maximum(mu_r, torch.clamp(10.0 * mu_r, max=opt.mu_init)),
            mu_r)
        m_o = mu_o[:, None]
        dual = lambda mk, d: torch.where(mk, m_o / d, 0.0)
        zL_r = dual(sp.mL, torch.where(sp.mL, ro.x - sp.xl, 1.0))
        zU_r = dual(sp.mU, torch.where(sp.mU, sp.xu - ro.x, 1.0))
        wL_r = dual(sp.msL, torch.where(sp.msL, ro.s - sp.cl, 1.0))
        wU_r = dual(sp.msU, torch.where(sp.msU, sp.cu - ro.s, 1.0))
        theta_max_r = take(st.theta_max)
        ftf, fpf, fcf = steps.fresh_filter(theta_max_r, dtype)
        ftf[:, 1] = torch.minimum(
            torch.maximum(10.0 * ro.theta, 1e2 * take(st.theta_min)),
            theta_max_r)
        fpf[:, 1] = -torch.inf
        fcf = torch.full_like(fcf, 2)

        def put(full, part):
            out = full.clone()
            out[idx] = part.to(full.dtype)
            return out
        step = (put(x_n, ro.x), put(s_n, ro.s),
                put(y_n, y_n.new_zeros((idx.shape[0], y_n.shape[-1]))),
                put(zL_n, zL_r), put(zU_n, zU_r), put(wL_n, wL_r),
                put(wU_n, wU_r), put(f_theta_n, ftf), put(f_phi_n, fpf),
                put(f_count_n, fcf))
        return (step, put(rest_iters, ro.iters), put(rest_failed, ro.certified),
                put(mu, mu_o), put(delta_w, torch.zeros_like(mu_o)))

    def body(st: IPMState, live):
        x, s, y = st.x, st.s, st.y
        zL, zU, wL, wU = st.zL, st.zU, st.wL, st.wU
        theta_min = st.theta_min
        theta_max = st.theta_max
        # carried from the previous convergence check (the same point)
        g, c, Jty = st.g, st.c, st.Jty

        # -- barrier parameter update (possibly several reductions) ------
        mu_mono, tau_mono, mu_shrunk = steps.monotone_barrier_update(
            spec, st.mu, g, c, Jty, x, s, y, zL, zU, wL, wU)
        theta_now = torch.sum(torch.abs(c - s), dim=-1)

        # iteration-constant KKT data, shared by the direction retries,
        # the corrector and the SOC
        prep = fns.kkt_prepare(x, y)
        diag = steps.barrier_diagonals(spec, x, s, zL, zU, wL, wU)

        def residuals(mu):
            """(rx, rhs_s, rc) of the centered system at barrier mu."""
            m = mu[:, None]
            rx = torch.where(fixed, 0.0,
                             -(g + Jty - m * diag.iLx + m * diag.iUx))
            rhs_s = torch.where(eq, 0.0,
                                -(-y - m * diag.iLs + m * diag.iUs))
            return rx, rhs_s, -(c - s) + diag.Ds * rhs_s

        # The direction ("ladder") rhs: monotone lanes solve the centered
        # system at mu_mono; adaptive free lanes solve the affine
        # (mu = 0) predictor, the probe that picks this iteration's mu,
        # and re-solve the centered rhs on the same factorization
        if adaptive:
            free_lane = (~st.mono) & (n_duals > 0)
            mu_lad = torch.where(free_lane, 0.0, mu_mono)
        else:
            mu_lad = mu_mono
        rx_lad, rhs_s_lad, rc_lad = residuals(mu_lad)

        # -- direction with inertia-free curvature correction ---------
        (dx, dy, ds, fac_used, delta_w_used, delta_c,
         dir_ok) = steps.regularized_direction(
            spec, fns, x, y, prep, rx_lad, rc_lad,
            diag.Ds, rhs_s_lad, diag.sigma_x, diag.sigma_s,
            st.delta_w, st.alpha_last, st.E_last, st.E_prev,
            st.accept_count, st.mu, live=live)
        dir_bad = ~dir_ok

        # -- Mehrotra probing mu + centered corrector re-solve ----------
        if adaptive:
            mu_ad = steps.mehrotra_probe(spec, diag, zL, zU, wL, wU,
                                         dx, ds, st.mu, dir_bad)
            mu = torch.where(free_lane, mu_ad, mu_mono)
            tau = torch.clamp(1.0 - mu, min=opt.tau_min)
        else:
            mu, tau = mu_mono, tau_mono
        # centered residuals at the final mu (the ladder rhs on
        # monotone lanes)
        rx, rhs_s, rc = residuals(mu)
        if adaptive and bool((free_lane & live).any()):
            # corrector: centered solve on the same factorization
            dx_c, dy_c, _ = fns.kkt_apply(fac_used, rx, rc)
            dx_c = torch.where(fixed, 0.0, dx_c)
            ds_c = torch.where(eq, 0.0, diag.Ds * (dy_c + rhs_s))
            fin_c = (torch.all(torch.isfinite(dx_c), dim=-1)
                     & torch.all(torch.isfinite(dy_c), dim=-1))
            use_c = free_lane & fin_c & ~dir_bad
            dx = steps.lane_where(use_c, dx_c, dx)
            dy = steps.lane_where(use_c, dy_c, dy)
            ds = steps.lane_where(use_c, ds_c, ds)

        # filter reset on barrier change (monotone reduction; adaptive
        # lanes also on any material mu move)
        mu_reset = mu_shrunk
        if adaptive:
            mu_reset = mu_reset | (torch.abs(mu - st.mu) > 0.05 * st.mu)
        ft0, fp0, fc0 = steps.fresh_filter(theta_max, dtype)
        f_theta = torch.where(mu_reset[:, None], ft0, st.f_theta)
        f_phi = torch.where(mu_reset[:, None], fp0, st.f_phi)
        f_count = torch.where(mu_reset, fc0, st.f_count)

        # -- regular filter-IPM step -------------------------------------
        (x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, f_theta_n, f_phi_n,
         f_count_n, enter_rest, alpha, stall_count) = \
            steps.filter_line_search(
                spec, fns, x, s, y, zL, zU, wL, wU, diag, g, c,
                theta_now, theta_min, mu, tau, dx, dy, ds, dir_bad,
                fac_used, rx, rhs_s, f_theta, f_phi, f_count,
                st.theta_prev, st.stall_count, live=live)

        # -- feasibility restoration (a full inner solve; W-B A-9) -------
        # progressive visit deepening: a visit entered within 10
        # iterations of the last halves the reduction goal (floor 0.05)
        rapid = (st.it - st.last_rest_it) < 10
        kappa_eff = torch.where(
            enter_rest & rapid, torch.clamp(st.rest_depth * 0.5, min=0.05),
            torch.full_like(st.rest_depth, opt.rest_reduction))
        rest_depth = torch.where(enter_rest, kappa_eff, st.rest_depth)
        last_rest_it = torch.where(enter_rest, st.it, st.last_rest_it)
        ((x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, f_theta_n, f_phi_n,
          f_count_n), rest_iters, rest_failed, mu, delta_w) = restore(
            st, live, enter_rest, kappa_eff, mu, delta_w_used,
            (x_n, s_n, y_n, zL_n, zU_n, wL_n, wU_n, f_theta_n, f_phi_n,
             f_count_n))
        # the theta-stall counter restarts after a visit, and
        # alpha_last = 0 keeps the delta_w feedback neutral
        stall_count = torch.where(enter_rest, 0, stall_count)
        alpha = torch.where(enter_rest, 0.0, alpha)
        rest_total = st.rest_total + rest_iters
        mu_ = mu[:, None]

        # -- Ipopt kappa_sigma multiplier safeguard ----------------------
        dLx_n = torch.where(mL, x_n - xl, 1.0)
        dUx_n = torch.where(mU, xu - x_n, 1.0)
        dLs_n = torch.where(msL, s_n - cl, 1.0)
        dUs_n = torch.where(msU, cu - s_n, 1.0)
        kS = opt.kappa_sigma

        def clipz(z, d, mk):
            dd = torch.clamp(d, min=1e-30)
            lo = mu_ / (kS * dd)
            hi = kS * mu_ / dd
            return torch.where(mk, torch.minimum(torch.maximum(z, lo), hi),
                               0.0)
        zL_n = clipz(zL_n, dLx_n, mL)
        zU_n = clipz(zU_n, dUx_n, mU)
        wL_n = clipz(wL_n, dLs_n, msL)
        wU_n = clipz(wU_n, dUs_n, msU)

        # -- convergence tests -------------------------------------------
        g_n, c_n, Jty_n = eval_point(x_n, y_n)
        E0, inf_pr, inf_du = steps.optimality_error(
            spec, g_n, c_n, Jty_n, x_n, s_n, y_n, zL_n, zU_n, wL_n,
            wU_n, torch.zeros_like(mu))
        converged = E0 <= opt.tol
        acceptable = E0 <= opt.acceptable_tol
        # hysteresis on the acceptable counter (see opty_tpu)
        excursion = E0 <= 10.0 * opt.acceptable_tol
        accept_count = torch.where(
            acceptable, st.accept_count + 1,
            torch.where(excursion, st.accept_count,
                        torch.zeros_like(st.accept_count)))
        acc_done = accept_count >= opt.acceptable_iter

        # -- adaptive-mode stall fallback: a probing lane that is
        # accepted but moves nowhere drops onto the monotone ladder,
        # re-centered on its complementarity average
        if adaptive:
            free_stall, fall_now, E_best = steps.stall_fallback(
                spec, st.mono, enter_rest, alpha, E0, st.E_best,
                st.free_stall)
            comp_avg = steps.complementarity_average(
                spec, x_n, s_n, zL_n, zU_n, wL_n, wU_n)
            mu_fb = torch.clamp(comp_avg, opt.tol / 11.0, opt.mu_init)
            mu = torch.where(fall_now, mu_fb, mu)
            # stored filter entries were measured at the old mu
            ftf, fpf, fcf = steps.fresh_filter(theta_max, dtype)
            f_theta_n = torch.where(fall_now[:, None], ftf, f_theta_n)
            f_phi_n = torch.where(fall_now[:, None], fpf, f_phi_n)
            f_count_n = torch.where(fall_now, fcf, f_count_n)
            mono_next = st.mono | enter_rest | fall_now
        else:
            free_stall, E_best = st.free_stall, st.E_best
            mono_next = st.mono | enter_rest

        bad = ~(torch.all(torch.isfinite(x_n), dim=-1)
                & torch.all(torch.isfinite(y_n), dim=-1)
                & torch.all(torch.isfinite(s_n), dim=-1))
        theta_new = torch.sum(torch.abs(c_n - s_n), dim=-1)
        infeasible = rest_failed & (theta_new > theta_min)
        rest_exhausted = rest_total >= opt.max_rest_iters

        status = torch.where(
            converged, SOLVE_SUCCEEDED,
            torch.where(acc_done, SOLVED_TO_ACCEPTABLE_LEVEL,
                        torch.where(bad, INVALID_NUMBER_DETECTED,
                                    torch.where(infeasible,
                                                INFEASIBLE_PROBLEM_DETECTED,
                                                torch.where(
                                                    rest_exhausted,
                                                    RESTORATION_FAILED,
                                                    st.status))))
        ).to(torch.int32)
        done = converged | acc_done | bad | infeasible | rest_exhausted

        sel = lambda new, old: steps.lane_where(bad, old, new)

        slot = torch.clamp(st.it, max=opt.max_iter - 1).long()[:, None]
        obj_history = st.obj_history.scatter(
            1, slot, fns.objective(x_n)[:, None])

        if opt.trace or opt.debug:
            print('it={} mu={:.2e} pr={:.2e} du={:.2e} dw={:.1e} al={:.1e} '
                  'rest={} th={:.2e} E0={:.2e} (lane 0)'.format(
                      int(st.it[0]), float(mu[0]), float(inf_pr[0]),
                      float(inf_du[0]), float(delta_w[0]),
                      float(alpha[0]), int(rest_iters[0]),
                      float(theta_new[0]), float(E0[0])))

        return IPMState(
            x=sel(x_n, x), s=sel(s_n, s), y=sel(y_n, y),
            zL=sel(zL_n, zL), zU=sel(zU_n, zU),
            wL=sel(wL_n, wL), wU=sel(wU_n, wU),
            mu=mu, delta_w=delta_w, delta_c=delta_c,
            f_theta=f_theta_n, f_phi=f_phi_n, f_count=f_count_n,
            rest_total=rest_total, rest_depth=rest_depth,
            last_rest_it=last_rest_it, theta_prev=theta_now,
            stall_count=stall_count,
            theta_min=theta_min, theta_max=theta_max,
            mono=mono_next, free_stall=free_stall, E_best=E_best,
            it=st.it + 1, status=status, done=done,
            accept_count=accept_count,
            obj_history=obj_history, inf_pr=inf_pr, inf_du=inf_du,
            alpha_last=alpha, E_last=E0, E_prev=st.E_last,
            g=sel(g_n, g), c=sel(c_n, c), Jty=sel(Jty_n, Jty))

    if resume_state is None:
        st = fresh_state()
    elif refill is not None and bool(torch.as_tensor(refill).any()):
        st = steps.lane_where(torch.as_tensor(refill, device=device),
                              fresh_state(), resume_state)
    else:
        st = resume_state

    it_stop = None if iter_budget is None else st.it + int(iter_budget)
    while True:
        live = (~st.done) & (st.it < opt.max_iter)
        if it_stop is not None:
            live = live & (st.it < it_stop)
        if not bool(live.any()):
            break
        st = steps.lane_where(live, body(st, live), st)

    # honor_original_bounds: project the reported solution back
    x_out = torch.minimum(torch.maximum(st.x, xl_orig), xu_orig)
    result = IPMResult(
        x=x_out, obj_val=fns.objective(x_out), g=fns.constraints(x_out),
        mult_g=st.y, mult_x_L=st.zL, mult_x_U=st.zU,
        status=st.status, iterations=st.it, obj_history=st.obj_history,
        inf_pr=st.inf_pr, inf_du=st.inf_du, mu=st.mu,
        rest_total=st.rest_total, mono=st.mono, delta_w=st.delta_w)
    if return_state:
        return result, st
    return result


def make_nlp_functions_dense(objective, constraints):
    """Dense-KKT IPMFunctions over B lanes for small generic NLPs.

    ``objective`` (n,) -> scalar and ``constraints`` (n,) -> (m,) take
    one point as a tensor; they are vmapped over the lanes.  The
    Lagrangian Hessian comes from ``torch.func.hessian`` and the
    condensed system is solved densely (``torch.linalg.solve_ex``,
    which, like the reference's ``jnp.linalg.solve``, returns
    non-finite values on a singular matrix instead of raising).  Used
    for small problems and as an oracle of the structured path."""
    def lag_hessian(x, y):
        return hessian(lambda xx: objective(xx)
                       + torch.dot(y, constraints(xx)))(x)

    jac = vmap(jacrev(constraints))

    def kkt_prepare(x, y):
        return vmap(lag_hessian)(x, y), jac(x)

    def _assemble(H, J, sigma_x, ds):
        B, n = sigma_x.shape
        m = ds.shape[-1]
        K = sigma_x.new_zeros((B, n + m, n + m))
        K[:, :n, :n] = H + torch.diag_embed(sigma_x)
        K[:, :n, n:] = J.transpose(-1, -2)
        K[:, n:, :n] = J
        K[:, n:, n:] = -torch.diag_embed(ds)
        return K

    def kkt_factor(prep, sigma_x, ds, gn_mask=None):
        H, J = prep
        if gn_mask is not None:
            # Gauss-Newton mode (restoration lanes): drop the Hessian
            gm = torch.as_tensor(gn_mask, device=H.device)
            H = torch.where(gm.reshape(gm.shape + (1,) * (3 - gm.ndim)),
                            0.0, H)
        return _assemble(H, J, sigma_x, ds)

    def kkt_apply(K, rx, rc):
        n = rx.shape[-1]
        r = torch.cat([rx, rc], dim=-1)
        sol = torch.linalg.solve_ex(K, r)[0]
        resid = (torch.linalg.vector_norm(
            torch.einsum('bij,bj->bi', K, sol) - r, dim=-1)
            / torch.clamp(torch.linalg.vector_norm(r, dim=-1), min=1e-300))
        return sol[:, :n], sol[:, n:], resid

    def kkt_solve(prep, sigma_x, ds, rx, rc):
        return kkt_apply(kkt_factor(prep, sigma_x, ds), rx, rc)

    def kkt_solve_feasibility(prep, sigma_x, rc):
        _, J = prep
        K = _assemble(torch.zeros_like(prep[0]), J, sigma_x,
                      torch.ones_like(rc))
        sol = torch.linalg.solve_ex(
            K, torch.cat([torch.zeros_like(sigma_x), rc], dim=-1))[0]
        n = sigma_x.shape[-1]
        return sol[:, :n], sol[:, n:]

    def kkt_prepare_gn(x):
        J = jac(x)
        return x.new_zeros(x.shape + x.shape[-1:]), J

    return IPMFunctions(objective=vmap(objective), gradient=vmap(grad(objective)),
                        constraints=vmap(constraints),
                        kkt_prepare=kkt_prepare, kkt_factor=kkt_factor,
                        kkt_apply=kkt_apply, kkt_solve=kkt_solve,
                        kkt_solve_feasibility=kkt_solve_feasibility,
                        kkt_prepare_gn=kkt_prepare_gn)
