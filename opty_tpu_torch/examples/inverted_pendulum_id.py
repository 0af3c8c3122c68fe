"""Closed-loop controller-gain identification for an n-link inverted
pendulum on a cart, the counterpart of examples/inverted_pendulum_id.py:
the equations of motion by Kane's method, LQR gains, a noisy
closed-loop simulation, then the gains identified by direct collocation.

Kane's method, the LQR design and the simulation stay SymPy, numpy and
scipy, so the same seeds give the same data as the original; the
identification runs on the port.

Run:  python -m opty_tpu_torch.examples.inverted_pendulum_id [--links 1]
      [--nodes 501] [--duration 5.0] [--noise 0.01]
"""

import argparse
import time

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch
from scipy.integrate import odeint
from scipy.linalg import solve_continuous_are

from opty_tpu_torch import Problem, parse_free, sum_of_sines
from opty_tpu_torch.config import resolve_device

__all__ = ['n_link_pendulum_on_cart', 'build_problem', 'main']


def n_link_pendulum_on_cart(n):
    """Equations of motion for an n-link pendulum on a laterally forced
    cart, by Kane's method.  Returns (KanesMethod, states, the specified
    force, the parameter symbols, the time symbol)."""
    q = me.dynamicsymbols('q:{}'.format(n + 1))      # cart pos + angles
    u = me.dynamicsymbols('u:{}'.format(n + 1))
    F = me.dynamicsymbols('F')
    m = sm.symbols('m:{}'.format(n + 1))
    l = sm.symbols('l:{}'.format(n))
    g = sm.Symbol('g')
    # the active dynamicsymbols time, as any earlier Problem left it
    t = me.dynamicsymbols._t

    frame = me.ReferenceFrame('I')
    origin = me.Point('O')
    origin.set_vel(frame, 0)

    cart = me.Point('P0')
    cart.set_pos(origin, q[0] * frame.x)
    cart.set_vel(frame, u[0] * frame.x)
    cart_particle = me.Particle('Pa0', cart, m[0])

    points = [cart]
    particles = [cart_particle]
    forces = [(cart, F * frame.x - m[0] * g * frame.y)]
    kindiffs = [q[0].diff(t) - u[0]]

    for i in range(n):
        Bi = frame.orientnew('B{}'.format(i), 'Axis',
                             [q[i + 1], frame.z])
        Bi.set_ang_vel(frame, u[i + 1] * frame.z)
        Pi = points[-1].locatenew('P{}'.format(i + 1), l[i] * Bi.y)
        Pi.v2pt_theory(points[-1], frame, Bi)
        Pai = me.Particle('Pa{}'.format(i + 1), Pi, m[i + 1])
        points.append(Pi)
        particles.append(Pai)
        forces.append((Pi, -m[i + 1] * g * frame.y))
        kindiffs.append(q[i + 1].diff(t) - u[i + 1])

    kane = me.KanesMethod(frame, q_ind=q, u_ind=u, kd_eqs=kindiffs)
    kane.kanes_equations(particles, forces)
    return kane, q + u, F, list(m) + list(l) + [g], t


def build_problem(links=1, nodes=501, duration=5.0, noise=0.01,
                  device=None):
    """The identification problem of the original's ``main`` with its
    data: returns (problem, initial guess, true gains).  ``device``
    is the problem's (the card when None)."""
    n = links
    kane, states, F, par_syms, t = n_link_pendulum_on_cart(n)
    num_states = len(states)

    # unit masses and lengths, g = 9.81
    par_vals = [1.0] * (n + 1) + [1.0] * n + [9.81]
    par_map = dict(zip(par_syms, par_vals))

    # LQR gains about the upright equilibrium
    eq_point = {s: 0.0 for s in states}
    linearizer = kane.to_linearizer()
    A_op, B_op = linearizer.linearize(op_point=[eq_point, {F: 0.0}],
                                      A_and_B=True)
    A_num = np.asarray(A_op.subs(par_map), dtype=float)
    B_num = np.asarray(B_op.subs(par_map), dtype=float).reshape(-1, 1)
    Q = np.eye(num_states)
    R = np.eye(1)
    S = solve_continuous_are(A_num, B_num, Q, R)
    K = (np.linalg.solve(R, B_num.T @ S)).flatten()   # true gains

    # the closed loop F = -K x + w(t): a sum-of-sines perturbation
    # excites it, without which the gains are unidentifiable
    mm = kane.mass_matrix_full
    fo = kane.forcing_full
    rhs_fn = sm.lambdify((states, F, par_syms), mm.LUsolve(fo), cse=True)

    N = nodes
    tv = np.linspace(0.0, duration, N)
    np.random.seed(4)
    w_traj, _, _ = sum_of_sines(4.0, [1.0, 2.3, 3.7, 5.1, 7.3], tv)

    def rhs(x, t_now):
        w_now = np.interp(t_now, tv, w_traj)
        force = -float(K @ x) + w_now
        return np.asarray(rhs_fn(x, force, par_vals), dtype=float).ravel()

    rng = np.random.default_rng(4)
    x_traj = odeint(rhs, np.zeros(num_states), tv)
    x_meas = x_traj + rng.normal(scale=noise, size=x_traj.shape)

    # unknown gains k0..k(2n+1) close the loop symbolically
    k = sm.symbols('k:{}'.format(num_states))
    w = sm.Function('w')(t)
    controller = -sum(ki * si for ki, si in zip(k, states)) + w
    eom = (kane.mass_matrix_full *
           sm.Matrix([s.diff(t) for s in states]) -
           kane.forcing_full).subs({F: controller})

    interval = duration / (N - 1)
    x_meas_t = torch.as_tensor(x_meas.T, device=resolve_device(device))

    def obj(free):
        X = free[:num_states * N].reshape(num_states, N)
        return interval * torch.sum((X - x_meas_t) ** 2)

    prob = Problem(obj, None, eom, states, N, interval,
                   known_parameter_map=par_map,
                   known_trajectory_map={w: w_traj},
                   time_symbol=t, device=device)
    guess = np.hstack([x_meas.T.flatten(), np.zeros(len(k))])
    return prob, guess, K


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--links', type=int, default=1)
    parser.add_argument('--nodes', type=int, default=501)
    parser.add_argument('--duration', type=float, default=5.0)
    parser.add_argument('--noise', type=float, default=0.01)
    args = parser.parse_args()

    prob, guess, K = build_problem(args.links, args.nodes, args.duration,
                                   args.noise)
    t0 = time.time()
    sol, info = prob.solve(guess)
    _, _, gains = parse_free(sol, len(K), 0, args.nodes)
    print(info['status_msg'])
    print('identified gains:', np.round(gains, 4))
    print('true gains:      ', np.round(K, 4))
    print('max error: {:.2e}   wall {:.1f}s  iters {}'.format(
        np.abs(gains - K).max(), time.time() - t0, info['iterations']))


if __name__ == '__main__':
    main()
