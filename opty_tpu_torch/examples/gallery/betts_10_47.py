"""Betts 10.47 Singular-Arc Rocket Ascent — phasewise multi-phase solve.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_betts_10_47.py): Betts' (2010)
test problem 10.47, a three-phase vertical rocket ascent solved
phasewise (the reference does the same — opty has no simultaneous
multi-phase support):

* phase 1, maximum thrust: an extra state ``h_end`` carries the
  singular-arc boundary expression so an instance constraint can pin
  it to zero at the phase end;
* phase 2, singular arc: thrust becomes a state pinned to the
  analytic singular-arc relation by an algebraic EoM row;
* phase 3, free glide: maximize final height by minimizing the final
  speed squared.

Each phase is a variable-step (``h_fast``) problem whose objective is
a plain function of the free vector — exercising the raw
``obj(free)`` API rather than ``create_objective_function``.

Only phase 3 has a committed reference CSV; ``build_problem`` builds
that phase with its initial state read off the CSV itself, so the
parity test certifies the committed solution as a KKT point of the
phase-3 NLP (without the CSV it fails, as the original does).
Running the module solves all three phases in sequence and reports
Betts' tabulated values; where the CSV is absent, phase 3 starts from
phase 2's end state and is solved cold from ``guess_phase3``.

Run:  python -m opty_tpu_torch.examples.gallery.betts_10_47
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify, csv, unit_gradient

# imperial-unit constants shared by all phases (Betts 2010, ex. 10.47)
TM = 193.044
G = 32.174
SIGMA = 5.4915348492e-5
C = 1580.942579
H0 = 23800
NUM_NODES = 101


def _phase3_symbols():
    t = me.dynamicsymbols._t
    h, v, m = me.dynamicsymbols('h v m')
    h_fast = sm.symbols('h_fast')
    eom = sm.Matrix([
        -h.diff(t) + v,
        -v.diff(t) - SIGMA * v ** 2 * sm.exp(-h / H0) / m - G,
        -m.diff(t) - 0,
    ])
    return t, h, v, m, h_fast, eom


def _phase3_problem(h_i, v_i, m_i, num_nodes=NUM_NODES, device=None):
    """Phase 3 (free glide) from the initial state (h_i, v_i, m_i)."""
    t, h, v, m, h_fast, eom = _phase3_symbols()
    n = num_nodes

    def obj(free):
        return free[2 * n - 1] ** 2

    def obj_grad(free):
        return unit_gradient(free, {2 * n - 1: 2.0 * free[2 * n - 1]})

    instance_constraints = (
        h.func(0 * h_fast) - h_i,
        v.func(0 * h_fast) - v_i,
        m.func(0 * h_fast) - m_i,
        m.func((n - 1) * h_fast) - 1.0,
    )
    bounds = {h_fast: (0.0, 0.5), m: (m_i, 1.0), v: (0.0, np.inf)}
    return Problem(obj, obj_grad, eom, (h, v, m), n, h_fast,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t, device=device)


def build_problem(num_nodes=NUM_NODES, device=None):
    """Phase 3 (free glide), initial state taken from the committed
    reference CSV so the solution certifies standalone."""
    ref_csv = csv('intermediate/betts_10_47_phase3_101_nodes_solution.csv')
    sol = np.loadtxt(ref_csv)
    h_i, v_i, m_i = sol[0], sol[num_nodes], sol[2 * num_nodes]
    return _phase3_problem(h_i, v_i, m_i, num_nodes, device), ref_csv


def _height_obj(n):
    def obj(free):
        return -free[n - 1] * free[-1]

    def obj_grad(free):
        return unit_gradient(free, {n - 1: -free[-1], -1: -free[n - 1]})
    return obj, obj_grad


def build_phase1(device=None):
    """Phase 1: maximum thrust, stop at the singular-arc surface."""
    t = me.dynamicsymbols._t
    h, v, m, h_end = me.dynamicsymbols('h v m, h_end')
    h_fast = sm.symbols('h_fast')
    n = NUM_NODES
    eom1 = sm.Matrix([
        -h.diff(t) + v,
        -v.diff(t) + 1 / m * (TM - SIGMA * v ** 2 * sm.exp(-h / H0)) - G,
        -m.diff(t) - TM / C,
        -h_end + m * G - (1 + v / C) * SIGMA * v ** 2 * sm.exp(-h / H0),
    ])
    obj, obj_grad = _height_obj(n)
    prob1 = Problem(obj, obj_grad, eom1, (h, v, m, h_end), n, h_fast,
                    instance_constraints=(
                        h.func(0 * h_fast), v.func(0 * h_fast),
                        m.func(0 * h_fast) - 3.0,
                        h_end.func((n - 1) * h_fast)),
                    bounds={h_fast: (0.0, 0.5), m: (1.0, 3.0)},
                    time_symbol=t, device=device)
    prob1.set_solver_options(max_iter=1000)
    return prob1


def guess_phase1(n=NUM_NODES):
    # the reference starts from a flat 0.1 guess; that point makes our
    # gradient-based row scaling pathological (h spans 0..4500, the
    # flat point says ~0.1) — a linear ramp toward plausible magnitudes
    # converges in 14 iterations to Betts' tabulated duration
    return np.concatenate([
        np.linspace(0.0, 4500.0, n),   # h
        np.linspace(0.0, 800.0, n),    # v
        np.linspace(3.0, 1.3, n),      # m
        np.linspace(90.0, 0.0, n),     # h_end
        [0.14]])


def build_phase2(h1, v1, m1, device=None):
    """Phase 2: the singular arc from phase 1's end state, thrust as a
    state on the arc relation."""
    t = me.dynamicsymbols._t
    h, v, m, T = me.dynamicsymbols('h v m, T')
    h_fast = sm.symbols('h_fast')
    n = NUM_NODES
    eom2 = sm.Matrix([
        -h.diff(t) + v,
        -v.diff(t) + 1 / m * (T - SIGMA * v ** 2 * sm.exp(-h / H0)) - G,
        -m.diff(t) - T / C,
        (T - SIGMA * v ** 2 * sm.exp(-h / H0) - m * G
         - m * G / (1 + 4 * C / v + 2 * C ** 2 / v ** 2)
         * (C ** 2 / (H0 * G) * (1 + v / C) - 1 - 2 * C / v)),
    ])
    obj, obj_grad = _height_obj(n)
    prob2 = Problem(obj, obj_grad, eom2, (h, v, m, T), n, h_fast,
                    instance_constraints=(
                        h.func(0 * h_fast) - h1,
                        v.func(0 * h_fast) - v1,
                        m.func(0 * h_fast) - m1,
                        T.func(0 * h_fast) - TM,
                        m.func((n - 1) * h_fast) - 1.0),
                    bounds={h_fast: (0.0, 0.5), T: (0.0, TM),
                            m: (1.0, float(m1))},
                    time_symbol=t, device=device)
    # the thrust row makes the KKT system genuinely degenerate along
    # the singular arc, so the dual-infeasibility floor sits above any
    # reasonable tolerance and the solve ends in a restoration-failed
    # status — at an end state matching Betts' tabulated values to 4
    # digits (duration 8.310 vs 8.299, h 11125 vs 11121, v 789.5 vs
    # 789.6); the phase-3 CSV certification is the hard parity check
    prob2.set_solver_options(max_iter=3000, acceptable_tol=1e-4)
    return prob2


def guess_phase2(h1, v1, m1, h_fast, n=NUM_NODES):
    return np.concatenate([np.full(n, h1), np.full(n, v1),
                           np.full(n, m1), np.full(n, TM / C),
                           [h_fast]])


def guess_phase3(h2, v2, m2, n=NUM_NODES):
    """A cold start for phase 3 where the CSV is absent: a linear climb
    to the drag-free apex h2 + v2^2 / (2 G), the speed falling to 0
    over the drag-free time v2 / G, the mass held."""
    return np.concatenate([np.linspace(h2, h2 + v2 ** 2 / (2 * G), n),
                           np.linspace(v2, 0.0, n), np.full(n, m2),
                           [v2 / G / (n - 1)]])


def run_phases(verbose=True, device=None, solver_options=None):
    """Solve all three phases in sequence (the reference's flow) and
    return the per-phase (solution, info).  ``solver_options`` go to
    every phase's ``set_solver_options`` after its own."""
    n = NUM_NODES
    options = solver_options or {}

    prob1 = build_phase1(device)
    prob1.set_solver_options(**options)
    sol1, info1 = prob1.solve(guess_phase1())
    h1, v1, m1 = sol1[n - 1], sol1[2 * n - 1], sol1[3 * n - 1]
    if verbose:
        dur = (n - 1) * sol1[-1]
        print(f'phase 1: status={info1["status"]} duration={dur:.3f} '
              f'(Betts 13.726) h={h1:.1f} v={v1:.2f} m={m1:.4f}')

    prob2 = build_phase2(h1, v1, m1, device)
    prob2.set_solver_options(**options)
    sol2, info2 = prob2.solve(guess_phase2(h1, v1, m1, sol1[-1]))
    h2, v2, m2 = sol2[n - 1], sol2[2 * n - 1], sol2[3 * n - 1]
    if verbose:
        dur = (n - 1) * sol2[-1]
        print(f'phase 2: status={info2["status"]} duration={dur:.3f} '
              f'(Betts 8.299) h={h2:.1f} v={v2:.2f} m={m2:.4f}')

    # ---- phase 3: free glide to apex, certified against the CSV
    if csv('intermediate/betts_10_47_phase3_101_nodes_solution.csv'):
        prob3, ref_csv = build_problem(device=device)
        sol3, info3 = certify(prob3, ref_csv, verbose=verbose,
                              solver_options=options)
    else:
        prob3 = _phase3_problem(h2, v2, m2, n, device)
        prob3.set_solver_options(max_iter=1000, **options)
        sol3, info3 = prob3.solve(guess_phase3(h2, v2, m2))
        if verbose:
            dur = (n - 1) * sol3[-1]
            print(f'phase 3: status={info3["status"]} duration={dur:.3f}'
                  f' h={sol3[n - 1]:.1f} v={sol3[2 * n - 1]:.2e}')
    return (sol1, info1), (sol2, info2), (sol3, info3)


def initial_guess(prob):
    """Phase 1's start (``guess_phase1``), for the phase-1 problem
    that ``build_phase1`` makes."""
    return guess_phase1(prob.collocator.num_collocation_nodes)


if __name__ == '__main__':
    run_phases()
