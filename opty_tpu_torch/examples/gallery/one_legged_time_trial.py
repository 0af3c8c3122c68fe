"""One-Legged Cycling Time Trial — muscle-driven, minimum time.

Port of the reference gallery problem
(examples-gallery/advanced/plot_one_legged_time_trial.py): a single
leg (foot/pedal, lower leg, upper leg + crank) drives a fixed-gear
bicycle against rolling/aero resistance through four lumped
DeGroote-2016 musculotendons (two with linear pathways, one wrapping
the knee on a circular arc, one heel cord); the closed kinematic loop
contributes two holonomic constraint rows, four first-order activation
ODEs join the EoMs, and the race is a fixed crank-revolution distance
in minimum (variable-h) time.  This is the heaviest symbolic model in
the portable gallery (musculotendon force laws + CRAMER-eliminated
loop constraints).

Run:  python -m opty_tpu_torch.examples.gallery.one_legged_time_trial
"""

import numpy as np
import sympy as sm
import sympy.physics.biomechanics as bm
import sympy.physics.mechanics as me

from ...problem import Problem


class PinArcPathway(me.PathwayBase):
    """Muscle pathway wrapping a circular arc around a pin joint
    (an extensor, e.g. quadriceps over the knee).

    Two straight tangent segments plus an arc whose subtended angle
    grows one-to-one with the joint coordinate; valid for coordinate
    >= 0.  ``parent_axis``/``child_axis`` point from the pin to the
    origin/insertion respectively.
    """

    def __init__(self, origin, insertion, pin_point, axis, parent_axis,
                 child_axis, radius, coordinate):
        super().__init__(origin, insertion)
        self.origin = origin
        self.insertion = insertion
        self._pin = pin_point
        self._axis = axis.normalize()
        self._pa = parent_axis.normalize()
        self._ca = child_axis.normalize()
        self._r = radius
        self._q = coordinate
        self._d_o = pin_point.pos_from(origin).magnitude()
        self._d_i = pin_point.pos_from(insertion).magnitude()
        self._a_o = sm.asin(radius / self._d_o)
        self._a_i = sm.asin(radius / self._d_i)

    @property
    def length(self):
        arc = self._r * (self._a_o + self._q + self._a_i)
        return (self._d_o * sm.cos(self._a_o) + arc
                + self._d_i * sm.cos(self._a_i))

    @property
    def extension_velocity(self):
        return self._r * self._q.diff(me.dynamicsymbols._t)

    def to_loads(self, force_magnitude):
        # tangency points where the straight segments meet the arc
        Tp = me.Point('Tp')
        Tc = me.Point('Tc')
        Tp.set_pos(self._pin,
                   -self._r * sm.cos(self._a_o) * self._pa.cross(self._axis)
                   + self._r * sm.sin(self._a_o) * self._pa)
        Tc.set_pos(self._pin,
                   self._r * sm.cos(self._a_i) * self._ca.cross(self._axis)
                   + self._r * sm.sin(self._a_i) * self._ca)
        f_par = force_magnitude * self.origin.pos_from(Tp).normalize()
        f_chd = force_magnitude * self.insertion.pos_from(Tc).normalize()
        return [me.Force(self.origin, f_par),
                me.Force(self._pin, -(f_par + f_chd)),
                me.Force(self.insertion, f_chd)]


def build_problem(distance=10.0, samples_per_rev=100, device=None):
    from scipy.optimize import fsolve

    t = me.dynamicsymbols._t
    q1, q2, q3, q4 = me.dynamicsymbols('q1, q2, q3, q4', real=True)
    u1, u2, u3, u4 = me.dynamicsymbols('u1, u2, u3, u4', real=True)
    q = sm.Matrix([q1, q2, q3, q4])
    u = sm.Matrix([u1, u2, u3, u4])
    qd_repl = {qi.diff(t): ui for qi, ui in zip(q, u)}

    ls, lc, lf, ll, lu = sm.symbols('ls, lc, lf, ll, lu', real=True,
                                    positive=True)
    lam, g, rk, c = sm.symbols('lam, g, rk, c', real=True,
                               nonnegative=True)
    mA, mB, mC, mD = sm.symbols('mA, mB, mC, mD', nonnegative=True)
    IAzz, IBzz, ICzz, IDzz = sm.symbols('IAzz, IBzz, ICzz, IDzz',
                                        nonnegative=True)
    J, m, rw, G, Cr, CD, rho, Ar = sm.symbols(
        'J, m, rw, G, Cr, CD, rho, Ar', nonnegative=True)

    N, A, B, C, D = sm.symbols('N, A, B, C, D', cls=me.ReferenceFrame)
    A.orient_axis(N, N.z, q1)     # crank
    B.orient_axis(A, A.z, q2)     # pedal/foot
    C.orient_axis(B, B.z, q3)     # ankle
    D.orient_axis(C, C.z, q4)     # knee
    A.set_ang_vel(N, u1 * N.z)
    B.set_ang_vel(A, u2 * A.z)
    C.set_ang_vel(B, u3 * B.z)
    D.set_ang_vel(C, u4 * C.z)

    P1, P2, P3, P4, P5, P6, P7, P8, P9 = sm.symbols(
        'P1, P2, P3, P4, P5, P6, P7, P8, P9', cls=me.Point)
    Ao, Bo, Co, Do = sm.symbols('Ao, Bo, Co, Do', cls=me.Point)

    Ao.set_pos(P1, 0 * A.x)
    P2.set_pos(P1, lc * A.x)              # pedal center
    Bo.set_pos(P2, lf / 2 * B.x)
    P3.set_pos(P2, lf * B.x)              # ankle
    P7.set_pos(P2, 3 * lf / 2 * B.x)      # heel
    Co.set_pos(P3, ll / 2 * C.x)
    P4.set_pos(P3, ll * C.x)              # knee
    Do.set_pos(P4, lu / 2 * D.x)
    P5.set_pos(P4, lu * D.x)              # hip
    P6.set_pos(P1, -ls * sm.cos(lam) * N.x + ls * sm.sin(lam) * N.y)
    P8.set_pos(P3, ll / 6 * C.x)
    P9.set_pos(P4, -2 * rk * C.x)

    P1.set_vel(N, 0)
    P6.set_vel(N, 0)
    for P, frame, base in ((Ao, A, P1), (P2, A, P1), (P7, B, P2),
                           (Bo, B, P2), (P3, B, P2), (Co, C, P3),
                           (P8, C, P3), (P9, C, P3), (P4, C, P3),
                           (Do, D, P4), (P5, D, P4)):
        P.v2pt_theory(base, N, frame)

    kindiff = sm.Matrix([ui - qi.diff(t) for ui, qi in zip(u, q)])
    holonomic = (P5.pos_from(P1) - P6.pos_from(P1)).to_matrix(N)[:2, :]
    mocon = me.msubs(holonomic.diff(t), qd_repl)

    crank = me.RigidBody('crank', masscenter=Ao, frame=A, mass=mA,
                         inertia=me.Inertia.from_inertia_scalars(
                             Ao, A, 0, 0, IAzz))
    foot = me.RigidBody('foot', masscenter=Bo, frame=B, mass=mB,
                        inertia=me.Inertia.from_inertia_scalars(
                            Bo, B, 0, 0, IBzz))
    lower_leg = me.RigidBody('lower', masscenter=Co, frame=C, mass=mC,
                             inertia=me.Inertia.from_inertia_scalars(
                                 Co, C, 0, 0, ICzz))
    upper_leg = me.RigidBody('upper', masscenter=Do, frame=D, mass=mD,
                             inertia=me.Inertia.from_inertia_scalars(
                                 Do, D, 0, 0, IDzz))

    # crank resistance: flat-ground point-mass bicycle reflected
    # through the gear ratio (forward motion assumed: u1 <= 0)
    resistance = me.Torque(
        crank,
        (-(2 * J + m * rw ** 2) * G ** 2 * u1.diff()
         + Cr * m * g * rw * G
         + rho * CD * Ar * G ** 3 * rw ** 3 * u1 ** 2 / 2) * N.z)

    knee_top_pathway = PinArcPathway(P9, P5, P4, C.z, -C.x, D.x, rk, q4)
    knee_top_act = bm.FirstOrderActivationDeGroote2016.with_defaults(
        'knee_top')
    knee_top_mus = bm.MusculotendonDeGroote2016.with_defaults(
        'knee_top', knee_top_pathway, knee_top_act)
    knee_bot_mus = bm.MusculotendonDeGroote2016.with_defaults(
        'knee_bot', me.LinearPathway(P9, P5),
        bm.FirstOrderActivationDeGroote2016.with_defaults('knee_bot'))
    ankle_top_mus = bm.MusculotendonDeGroote2016.with_defaults(
        'ankle_top', me.LinearPathway(P8, P2),
        bm.FirstOrderActivationDeGroote2016.with_defaults('ankle_top'))
    ankle_bot_mus = bm.MusculotendonDeGroote2016.with_defaults(
        'ankle_bot', me.LinearPathway(P8, P7),
        bm.FirstOrderActivationDeGroote2016.with_defaults('ankle_bot'))
    muscles = (knee_top_mus, knee_bot_mus, ankle_top_mus, ankle_bot_mus)

    kane = me.KanesMethod(
        N, (q1, q2), (u1, u2), kd_eqs=kindiff[:],
        q_dependent=(q3, q4), configuration_constraints=holonomic,
        velocity_constraints=mocon, u_dependent=(u3, u4),
        constraint_solver='CRAMER')

    loads = sum((mus.to_loads() for mus in muscles), []) + [
        me.Torque(B, c * u3 * B.z), me.Torque(C, -c * u3 * B.z),
        resistance,
        me.Force(Bo, -mB * g * N.y), me.Force(Co, -mC * g * N.y),
        me.Force(Do, -mD * g * N.y)]

    Fr, Frs = kane.kanes_equations(
        (crank, foot, lower_leg, upper_leg), loads)
    muscle_diff_eq = sm.Matrix([mus.a.diff() - mus.rhs()[0, 0]
                                for mus in muscles])
    eom = kindiff.col_join(Fr + Frs).col_join(muscle_diff_eq).col_join(
        holonomic)

    state_vars = (q1, q2, q3, q4, u1, u2, u3, u4,
                  *[mus.a for mus in muscles])

    par_map = {
        Ar: 0.55, CD: 1.15, Cr: 0.006, G: 2.0,
        IAzz: 0.0, IBzz: 0.01, ICzz: 0.101, IDzz: 0.282,
        J: 0.1524, g: 9.81, lam: np.deg2rad(75.0),
        lc: 0.175, lf: 0.08, ll: 0.611, ls: 0.8, lu: 0.424,
        m: 85.0, mB: 1.0, mC: 6.769, mD: 17.01,
        rho: 1.204, rk: 0.04, rw: 0.3, c: 30.0,
        knee_top_mus.F_M_max: 1400.0, knee_bot_mus.F_M_max: 1200.0,
        ankle_top_mus.F_M_max: 400.0, ankle_bot_mus.F_M_max: 1000.0,
    }

    # tendon slack / optimal fiber lengths from the maximally extended
    # configuration (crank aligned with the seat tube)
    p_syms = list(par_map.keys()) + [
        mus.l_T_slack for mus in muscles] + [
        mus.l_M_opt for mus in muscles]
    base_vals = list(par_map.values())
    eval_holo = sm.lambdify((q, list(par_map.keys())), holonomic)
    q1_ext, q2_ext = -par_map[lam], 3.0 * np.pi / 2.0
    q3_ext, q4_ext = fsolve(
        lambda x: eval_holo([q1_ext, q2_ext, x[0], x[1]],
                            base_vals).squeeze(),
        x0=np.deg2rad([-100.0, 20.0]))
    lens = sm.lambdify(
        (q, list(par_map.keys())),
        [mus.pathway.length.xreplace(qd_repl) for mus in muscles],
        cse=True)([q1_ext, q2_ext, q3_ext, q4_ext], base_vals)
    for mus, ln in zip(muscles, lens):
        par_map[mus.l_T_slack] = ln / 2
        par_map[mus.l_M_opt] = ln / 2 + 0.01
    del p_syms

    # initial configuration: crank forward horizontal, foot parallel
    q1_0, q2_0 = 0.0, np.pi
    q3_0, q4_0 = fsolve(
        lambda x: eval_holo([q1_0, q2_0, x[0], x[1]],
                            base_vals).squeeze(),
        x0=np.deg2rad([-90.0, 90.0]), xtol=1e-14)

    crank_revs = distance / par_map[rw] / par_map[G] / 2.0 / np.pi
    num_nodes = int(crank_revs * samples_per_rev)
    h = sm.symbols('h', real=True)
    t0, tf = 0 * h, (num_nodes - 1) * h

    instance_constraints = (
        q1.replace(t, t0) - q1_0, q2.replace(t, t0) - q2_0,
        q3.replace(t, t0) - q3_0, q4.replace(t, t0) - q4_0,
        u1.replace(t, t0), u2.replace(t, t0),
        u3.replace(t, t0), u4.replace(t, t0),
        *[mus.a.replace(t, t0) for mus in muscles],
        q1.replace(t, tf) + crank_revs * 2 * np.pi,
    )

    bounds = {
        q1: (-(crank_revs + 2) * 2 * np.pi, 0.0),
        q3: (-np.deg2rad(105.0), -np.deg2rad(30.0)),
        q4: (0.0, 3 * np.pi / 2),
        u1: (-30.0, 0.0),
        h: (0.0, 0.1),
    }
    for mus in muscles:
        bounds[mus.e] = (0.0, 1.0)

    prob = Problem(lambda free: free[-1], None, eom, state_vars,
                   num_nodes, h, known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   time_symbol=t, bounds=bounds,
                   device=device)

    guess = 0.5 * np.ones(prob.num_free)
    guess[0:num_nodes] = np.linspace(0.0, -crank_revs * 2 * np.pi,
                                     num=num_nodes)
    guess[num_nodes:2 * num_nodes] = np.linspace(
        0.0, crank_revs * 2 * np.pi, num=num_nodes)
    u1_guess = np.linspace(0.0, -40.0, num=num_nodes)
    u1_guess[num_nodes // 2:] = -20.0
    u2_guess = np.linspace(0.0, 40.0, num=num_nodes)
    u2_guess[num_nodes // 2:] = 20.0
    guess[4 * num_nodes:5 * num_nodes] = u1_guess
    guess[5 * num_nodes:6 * num_nodes] = u2_guess
    guess[-1] = 0.02
    prob.documented_guess = guess.copy()
    return prob, guess


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:235-239


def initial_guess(prob):
    """The documented ramp cold start, ``build_problem``'s guess
    (benchmarks/cold_gallery.py:235-239, after
    plot_one_legged_time_trial.py)."""
    return prob.documented_guess.copy()


def main():
    prob, guess = build_problem()
    # badly-scaled muscle dynamics from a crude guess: converges to
    # full tolerance in ~1500 iterations with several elastic-
    # restoration episodes (race time ~6.5 s; the reference gives
    # Ipopt max_iter=1000 for the same reason)
    prob.set_solver_options(max_iter=3000, max_rest_iters=400)
    solution, info = prob.solve(guess)
    h_val = float(solution[-1])
    N = prob.collocator.num_collocation_nodes
    print('status={} iters={} h={:.4f} race time={:.2f}s'.format(
        info['status'], info['iterations'], h_val, h_val * (N - 1)))
    assert info['status'] in (0, 1), info['status_msg']
    return solution, info


if __name__ == '__main__':
    main()
