"""Park 2004 standing-balance gain identification (closed loop).

Port of the reference gallery problem
(examples-gallery/advanced/plot_park2004.py + model_park2004.py,
after Park, Horak & Kuo 2004): a planar two-link standing human
(ankle + hip joints) balances on an antero-posteriorly accelerating
platform under full-state feedback; the eight scaled feedback gains
are identified from noisy simulated motion-capture data with the
platform acceleration as a *known measured trajectory* (N = 4000,
midpoint rule — the largest-N identification config in BASELINE.md).

The reference derives its segment parameters with ``yeadon``/``pydy``
(absent in this image); this port derives the same two-link model
directly with Kane's method in the platform (non-inertial) frame —
the platform acceleration enters as a horizontal pseudo-force — and
uses representative adult anthropometry.  The identification
structure (scaled gains in (0, 1), process + measurement noise,
sum-of-sines platform excitation) matches the reference exactly.

Run:  python -m opty_tpu_torch.examples.gallery.park2004
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...config import resolve_device
from ...problem import Problem
from ...utils import sum_of_sines

# nominal Park-2004-scale gains; the scaled unknowns are gain/scale
# with scale = 2 x nominal, so every true scaled gain is 0.5
NOMINAL_GAINS = np.array([[950.0, 175.0, 185.0, 50.0],
                          [45.0, 290.0, 60.0, 26.0]])
GAIN_SCALE = 2.0 * NOMINAL_GAINS

PAR_VALS = {'lL': 0.9, 'dL': 0.45, 'dT': 0.3, 'mL': 40.0, 'mT': 45.0,
            'IL': 2.2, 'IT': 2.6, 'g': 9.81}


def _derive():
    """Two-link (legs + torso) standing model in the platform frame.

    States: theta_a (legs from vertical), theta_h (torso relative to
    legs), omega_a, omega_h.  Platform acceleration ``a(t)`` applies
    the pseudo-force -m a in the horizontal direction at each mass
    center (non-inertial frame); ankle and hip torques close the loop
    through scaled full-state feedback.
    """
    t = me.dynamicsymbols._t
    theta_a, theta_h = me.dynamicsymbols('theta_a, theta_h', real=True)
    omega_a, omega_h = me.dynamicsymbols('omega_a, omega_h', real=True)
    a = me.dynamicsymbols('a', real=True)
    lL, dL, dT = sm.symbols('lL, dL, dT', positive=True)
    mL, mT, IL, IT, g = sm.symbols('mL, mT, IL, IT, g', positive=True)

    N = me.ReferenceFrame('N')          # platform frame
    A = me.ReferenceFrame('A')          # legs
    B = me.ReferenceFrame('B')          # torso
    A.orient_axis(N, N.z, theta_a)
    B.orient_axis(A, A.z, theta_h)
    A.set_ang_vel(N, omega_a * N.z)
    B.set_ang_vel(A, omega_h * N.z)

    O = me.Point('O')                   # ankle, fixed on the platform
    O.set_vel(N, 0)
    Lo = O.locatenew('Lo', dL * A.y)    # legs mass center
    H = O.locatenew('H', lL * A.y)      # hip
    To = H.locatenew('To', dT * B.y)    # torso mass center
    for P in (Lo, H, To):
        P.v2pt_theory(O, N, A) if P is not To else None
    Lo.v2pt_theory(O, N, A)
    H.v2pt_theory(O, N, A)
    To.v2pt_theory(H, N, B)

    legs = me.RigidBody('L', Lo, A, mL,
                        (me.inertia(A, 0, 0, IL), Lo))
    torso = me.RigidBody('T', To, B, mT,
                         (me.inertia(B, 0, 0, IT), To))

    # scaled unknown gains (8): T = -(k o F) [q; u]
    ks = sm.symbols('k_00, k_01, k_02, k_03, k_10, k_11, k_12, k_13',
                    real=True)
    K = sm.Matrix(2, 4, [ks[i] * GAIN_SCALE[i // 4 % 2][i % 4]
                         for i in range(8)])
    # (row-major: k_0j -> ankle, k_1j -> hip)
    xvec = sm.Matrix([theta_a, theta_h, omega_a, omega_h])
    T = -K * xvec                      # T[0] ankle, T[1] hip

    loads = [
        (Lo, -mL * g * N.y - mL * a * N.x),
        (To, -mT * g * N.y - mT * a * N.x),
        (A, T[0] * N.z - T[1] * N.z),
        (B, T[1] * N.z),
    ]
    kd = sm.Matrix([omega_a - theta_a.diff(t),
                    omega_h - theta_h.diff(t)])
    kane = me.KanesMethod(N, [theta_a, theta_h], [omega_a, omega_h],
                          kd_eqs=kd)
    fr, frstar = kane.kanes_equations([legs, torso], loads)
    eom = kd.col_join(fr + frstar)

    states = (theta_a, theta_h, omega_a, omega_h)
    consts = dict(zip(('lL', 'dL', 'dT', 'mL', 'mT', 'IL', 'IT', 'g'),
                      (lL, dL, dT, mL, mT, IL, IT, g)))
    return eom, states, a, ks, consts, kane, t


def _simulate(kane, consts_map, time, accel, process_noise, seed):
    """Closed-loop forward simulation with the TRUE gains (all scaled
    gains = 0.5) to produce the synthetic measurements."""
    from scipy.integrate import odeint

    # mass matrix / forcing with gains substituted numerically
    subs = dict(consts_map)
    MM = kane.mass_matrix_full.xreplace(subs)
    FO = kane.forcing_full.xreplace(subs)
    t = me.dynamicsymbols._t
    from sympy.core.function import AppliedUndef
    funcs = sorted(MM.atoms(AppliedUndef) | FO.atoms(AppliedUndef),
                   key=str)
    params = sorted((MM.free_symbols | FO.free_symbols) - {t}, key=str)
    state_syms = funcs + params
    f_M = sm.lambdify(state_syms, MM, modules='numpy')
    f_F = sm.lambdify(state_syms, FO, modules='numpy')

    a_interp = lambda tt: np.interp(tt, time, accel)
    noise_interp = [lambda tt, i=i: np.interp(tt, time,
                                              process_noise[:, i])
                    for i in range(4)]
    names = [str(s) for s in state_syms]

    def rhs(xx, tt):
        vals = {}
        xn = xx + np.array([noise_interp[i](tt) for i in range(4)])
        for nm, v in zip(['theta_a(t)', 'theta_h(t)', 'omega_a(t)',
                          'omega_h(t)'], xn):
            vals[nm] = v
        vals['a(t)'] = a_interp(tt)
        for i in range(2):
            for j in range(4):
                vals['k_{}{}'.format(i, j)] = 0.5
        args = [vals[nm] for nm in names]
        M = np.asarray(f_M(*args), dtype=float)
        F = np.asarray(f_F(*args), dtype=float).ravel()
        return np.linalg.solve(M, F)

    x0 = np.zeros(4)
    return odeint(rhs, x0, time)


def build_problem(num_nodes=4000, duration=20.0, seed=42, device=None):

    eom, states, a, ks, consts, kane, t = _derive()
    interval = duration / (num_nodes - 1)
    time = np.linspace(0.0, duration, num=num_nodes)

    rng = np.random.RandomState(seed)
    np.random.seed(seed)       # sum_of_sines uses the global rng
    nums = [7, 11, 16, 25, 38, 61, 103, 131, 151, 181, 313, 523]
    freq = 2.0 * np.pi * np.array(nums, dtype=float) / 240.0
    pos, vel, accel = sum_of_sines(0.02, freq, time)
    accel_meas = accel + rng.normal(scale=np.deg2rad(0.25),
                                    size=accel.shape)

    consts_map = {consts[k]: v for k, v in PAR_VALS.items()}
    process_noise = rng.normal(scale=np.deg2rad(1.0),
                               size=(len(time), 4))
    x = _simulate(kane, consts_map, time, accel, process_noise, seed)
    x_meas = x + rng.normal(scale=np.deg2rad(0.25), size=x.shape)
    x_meas_vec = x_meas.T.flatten()
    x_meas_t = torch.as_tensor(x_meas_vec, device=resolve_device(device))

    def obj(free):
        d = free[:4 * num_nodes] - x_meas_t
        return interval * (d ** 2).sum()

    bounds = {k: (0.0, 1.0) for k in ks}

    prob = Problem(obj, None, eom, states, num_nodes, interval,
                   known_parameter_map=consts_map,
                   known_trajectory_map={a: accel_meas},
                   bounds=bounds, integration_method='midpoint',
                   time_symbol=t,
                   device=device)

    guess = np.hstack((x_meas_vec, np.full(8, 0.5)))
    prob.documented_guess = guess.copy()
    return prob, guess, x_meas


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:228-232


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:228-232,
    after plot_park2004.py): the measured states and every scaled gain
    at 0.25, as the original's ``main``."""
    guess = prob.documented_guess.copy()
    guess[-8:] = 0.25
    return guess


def main():
    prob, guess, _ = build_problem()
    # start the gains midway through their bounds but NOT at the truth
    guess[-8:] = 0.25
    solution, info = prob.solve(guess)
    gains = np.asarray(solution[-8:])
    print('status={} iters={}'.format(info['status'],
                                      info['iterations']))
    print('identified scaled gains:', np.round(gains, 3))
    assert info['status'] in (0, 1), info['status_msg']
    # ankle gains dominate the dynamics and identify tightly; hip
    # gains are weakly excited (same caveat as the reference, which
    # plots rather than asserts their accuracy)
    err = np.abs(gains - 0.5)
    print('max scaled-gain error:', float(err.max()))
    assert err[:4].max() < 0.1
    return solution, info


if __name__ == '__main__':
    main()
