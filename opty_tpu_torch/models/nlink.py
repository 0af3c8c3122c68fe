"""n-link chain pendulum on a cart, the gait-scale model (the
counterpart of opty_tpu/models/nlink.py).

``num_links = 9`` gives 20 states, 10 inputs (a cart force and a torque
at every joint), equations of motion of ~477k expanded SymPy operations
(CSE in symbolics/lower.py collapses them to a few thousand), a variable
node interval ``h`` and 4(n + 1) = 40 instance constraints pinning the
initial and final states.  Its KKT node block is d = 20 + 10 + 20 = 50
and its border b = 1 + 40 = 41: the wide class of the PCR kernels
(ops/pcr_kernels.py) and of the border inverse (ops/block_kernels.py).
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

import torch

from ..problem import Problem

__all__ = ['n_link_cart_eom', 'n_link_cart_problem',
           'n_link_initial_guess']


def n_link_cart_eom(num_links, relative=True, joint_torques=True):
    """Kane's-method EoMs for a chain of ``num_links`` point-mass
    links hanging from a cart that slides along the horizontal axis
    under a control force, optionally with a torque actuator at every
    joint (the analog of gait2d's joint-torque drive).

    Returns ``(eom, state_symbols, input_symbols, par_map)`` with
    ``2 (num_links + 1)`` first-order implicit equations in the form
    ``M(q) x' - f(x, F, T) = 0``; ``input_symbols`` is ``(F, T1..Tn)``
    when ``joint_torques`` else ``(F,)``.

    ``relative=True`` measures each joint angle from its parent link
    (articulated-chain kinematics; expression size grows steeply with
    the chain length), ``False`` from the inertial vertical.
    """
    n = num_links
    t = me.dynamicsymbols._t
    q = me.dynamicsymbols('q0:{}'.format(n + 1))
    u = me.dynamicsymbols('u0:{}'.format(n + 1))
    F = me.dynamicsymbols('F')
    torques = (me.dynamicsymbols('T1:{}'.format(n + 1))
               if joint_torques else [])
    masses = sm.symbols('m0:{}'.format(n + 1))
    lengths = sm.symbols('l1:{}'.format(n + 1))
    g = sm.Symbol('g')

    inertial = me.ReferenceFrame('I')
    origin = me.Point('O')
    origin.set_vel(inertial, 0)
    cart_point = origin.locatenew('P0', q[0] * inertial.x)
    cart_point.set_vel(inertial, u[0] * inertial.x)
    bodies = [me.Particle('cart', cart_point, masses[0])]
    loads = [(cart_point, F * inertial.x - masses[0] * g * inertial.y)]
    kindiffs = [q[0].diff(t) - u[0]]

    parent_point, parent_frame = cart_point, inertial
    for i in range(n):
        frame = parent_frame.orientnew(
            'B{}'.format(i), 'Axis',
            [q[i + 1], parent_frame.z if relative else inertial.z])
        frame.set_ang_vel(parent_frame if relative else inertial,
                          u[i + 1] * (parent_frame.z if relative
                                      else inertial.z))
        point = parent_point.locatenew('P{}'.format(i + 1),
                                       lengths[i] * frame.y)
        point.v2pt_theory(parent_point, inertial, frame)
        bodies.append(me.Particle('link{}'.format(i + 1), point,
                                  masses[i + 1]))
        loads.append((point, -masses[i + 1] * g * inertial.y))
        if joint_torques:
            # actuator between link i and its parent (equal/opposite)
            loads.append((frame, torques[i] * inertial.z))
            if parent_frame is not inertial:
                loads.append((parent_frame, -torques[i] * inertial.z))
        kindiffs.append(q[i + 1].diff(t) - u[i + 1])
        parent_point, parent_frame = point, frame

    kane = me.KanesMethod(inertial, q_ind=q, u_ind=u, kd_eqs=kindiffs)
    kane.kanes_equations(bodies, loads)
    xdot = sm.Matrix([qi.diff(t) for qi in q]
                     + [ui.diff(t) for ui in u])
    eom = kane.mass_matrix_full * xdot - kane.forcing_full

    par_map = {g: 9.81}
    for mi in masses:
        par_map[mi] = 1.0
    for li in lengths:
        par_map[li] = 0.5
    states = tuple(q) + tuple(u)
    return eom, states, (F,) + tuple(torques), par_map


def n_link_cart_problem(num_links=9, num_nodes=60, task='reach',
                        force_bound=100.0, torque_bound=100.0,
                        h_bounds=(0.0, 0.2), duration_weight=0.0,
                        relative=True, joint_torques=True, device=None,
                        **problem_kwargs):
    """Variable-duration point-to-point motion of the n-link chain.

    ``task``:

    * ``'reach'`` — from a zig-zag bent configuration back to straight
      down, at rest on both ends (the sit-to-stand analog: a moderate
      fully-actuated reconfiguration);
    * ``'swing_up'`` — from hanging straight down to inverted (hard
      nonconvex control problem; use few links, and consider
      ``joint_torques=False`` for the classic underactuated variant).

    Returns ``(problem, initial_configuration)``; the problem lives on
    ``device`` (None: the card).
    """
    n = num_links
    eom, states, inputs, par_map = n_link_cart_eom(
        n, relative=relative, joint_torques=joint_torques)
    t = me.dynamicsymbols._t
    h = sm.Symbol('h', real=True)
    N = num_nodes

    if task == 'reach':
        # zig-zag bend: alternating +/- relative joint angles
        q_start = [0.0] + [0.6 * (-1) ** i for i in range(n)]
        q_end = [0.0] * (n + 1)
    elif task == 'swing_up':
        # hanging (pi from upright-defined zero) -> inverted
        q_start = [0.0, np.pi] + [0.0] * (n - 1)
        q_end = [0.0] * (n + 1)
    else:
        raise ValueError('Unknown task {!r}.'.format(task))

    instance_constraints = []
    for i, qs in enumerate(states[:n + 1]):
        instance_constraints.append(qs.subs(t, 0 * h) - q_start[i])
        instance_constraints.append(
            qs.subs(t, (N - 1) * h) - q_end[i])
    for us in states[n + 1:]:
        instance_constraints.append(us.subs(t, 0 * h))
        instance_constraints.append(us.subs(t, (N - 1) * h))

    nq = len(inputs)

    def obj(prob, free):
        _, inp_vals, _, h_val = prob.parse_free(free)
        inp_vals = torch.reshape(inp_vals, (nq, N))
        effort = h_val * torch.sum(inp_vals ** 2)
        return effort + duration_weight * h_val * (N - 1)

    bounds = {inputs[0]: (-force_bound, force_bound), h: h_bounds}
    for T in inputs[1:]:
        bounds[T] = (-torque_bound, torque_bound)
    prob = Problem(obj, None, eom, states, N, h,
                   known_parameter_map=par_map,
                   instance_constraints=tuple(instance_constraints),
                   bounds=bounds, time_symbol=t, device=device,
                   **problem_kwargs)
    return prob, np.asarray(q_start)


def n_link_initial_guess(prob, q_start, q_end=None, h_guess=None,
                         inverse_dynamics=True):
    """Dynamics-aware initial guess: cosine-ramp coordinate paths
    (zero end velocities), finite-difference-consistent velocity
    trajectories, a near-upper-bound ``h`` (the minimum-effort optimum
    slows the motion as much as the horizon allows), and — because the
    actuator inputs enter the implicit EoMs linearly — per-interval
    least-squares *inverse-dynamics* inputs that zero the collocation
    residual along the guessed path.  The resulting guess is nearly
    feasible, which keeps the nonconvex solve out of
    feasibility-restoration dead ends."""
    col = prob.collocator
    N = col.num_collocation_nodes
    n_states = col.num_states
    q = col.num_unknown_input_trajectories
    ncoord = n_states // 2
    if q_end is None:
        q_end = np.zeros(ncoord)
    if h_guess is None:
        hb = prob.bounds.get(col.time_interval_symbol, (0.0, 0.2))
        h_guess = 0.75 * float(np.asarray(hb[1]))
    guess = np.zeros(prob.num_free)
    # quintic smoothstep: zero velocity AND acceleration at both ends,
    # so the inverse-dynamics torques stay near static gravity levels
    # at the endpoints instead of spiking into the actuator bounds
    tau = np.linspace(0.0, 1.0, N)
    srange = tau ** 3 * (6.0 * tau ** 2 - 15.0 * tau + 10.0)
    for i in range(ncoord):
        path = q_start[i] + (q_end[i] - q_start[i]) * srange
        guess[i * N:(i + 1) * N] = path
        # backward-difference velocities: the BE kinematic rows
        # q_{i+1} - q_i = h u_{i+1} then hold exactly, leaving a
        # square exactly-solvable system for the inputs below
        vel = np.empty(N)
        vel[1:] = np.diff(path) / h_guess
        vel[0] = vel[1]
        guess[(ncoord + i) * N:(ncoord + i + 1) * N] = vel
    guess[-1] = h_guess

    if inverse_dynamics and q:
        # residual is affine in the inputs: r(z, u) = r0(z) + B u.
        # B = d r / d u_cur from the per-interval Jacobian blocks;
        # solve min ||r0 + B u|| per interval, assign to the current
        # node (backward Euler: node i+1), clip into the input bounds.
        free = prob._as_tensor(guess)
        r0, _ = col.constraints_nodewise(free)
        A = col.jacobian_blocks(free)[0]
        B = A[:, :, n_states:].cpu().numpy()          # (N-1, M, q)
        r0 = r0.cpu().numpy()                         # (N-1, M)
        u = np.zeros((N, q))
        for i in range(N - 1):
            sol, *_ = np.linalg.lstsq(B[i], -r0[i], rcond=None)
            u[i + 1] = sol
        u[0] = u[1]
        lb = prob.lower_bound[ncoord * 2 * N:(2 * ncoord + q) * N]
        ub = prob.upper_bound[ncoord * 2 * N:(2 * ncoord + q) * N]
        flat = np.clip(u.T.reshape(-1), lb, ub)
        guess[n_states * N:(n_states + q) * N] = flat
    return guess
