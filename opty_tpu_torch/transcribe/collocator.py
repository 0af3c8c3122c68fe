"""Direct-collocation transcription: symbolic DAEs -> torch residual,
Jacobian-block and Hessian-block evaluators.

The counterpart of opty_tpu/transcribe/collocator.py, feature for
feature: backward Euler and midpoint integration, a fixed or a variable
node interval (the symbolic interval is a free variable of the border),
known and unknown parameters, known trajectories given as arrays,
callables of time or pointwise functions of a state, implicit data
tables with their derivative values, and instance constraints.  The
continuous EoM is lowered once (symbolics/lower.py); a per-interval
kernel applies the discretization stencil, ``torch.func.vmap`` runs it
over the intervals, and ``jacfwd``/``hessian`` give the Jacobian and
Lagrangian Hessian blocks.  Free-vector and constraint orderings are
the JAX package's.

The JAX package sweeps the derivatives of wide kernels (2 nz + bw > 24,
the 9-link chain) as a ``lax.scan`` over tangent directions, to keep
its compiled TPU program small.  The port runs eagerly, with no program
to keep small, so it takes ``jacfwd``/``hessian`` at every width: one
batched pass over all tangents, the same values.
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from ..config import default_dtype, resolve_device
from ..symbolics.classify import classify_parameters, classify_trajectories
from ..symbolics.lower import _as_tensor_like, lambdify_torch

__all__ = ['ConstraintCollocator']

_METHODS = ('backward euler', 'midpoint')


class ConstraintCollocator:
    """Generates torch constraint/Jacobian/Hessian evaluators for the
    direct-collocation NLP on ``device`` (None: the card; see
    config.resolve_device).

    N nodes, M equations of motion, n states, q unknown input
    trajectories, r unknown parameters, s (0/1) unknown time interval,
    o instance constraints.  Free vector (length n*N + q*N + r + s)::

        free = [x11..x1N, ..., xn1..xnN, u11..u1N, ..., uqN, p1..pr, h]

    Constraints (length M*(N-1) + o): all node residuals of eom 1, then
    eom 2, ..., then the instance constraints.
    """

    def __init__(self, equations_of_motion, state_symbols,
                 num_collocation_nodes, node_time_interval,
                 known_parameter_map=None, known_trajectory_map=None,
                 instance_constraints=None, time_symbol=None,
                 integration_method='backward euler', dtype=None,
                 device=None):
        known_parameter_map = dict(known_parameter_map or {})
        known_trajectory_map = dict(known_trajectory_map or {})

        self._eom = equations_of_motion
        self._dtype = dtype or default_dtype()
        self._device = resolve_device(device)

        if time_symbol is not None:
            self._time_symbol = time_symbol
            me.dynamicsymbols._t = time_symbol
        else:
            self._time_symbol = me.dynamicsymbols._t

        self._state_symbols = tuple(state_symbols)
        if len(self._state_symbols) != len(set(self._state_symbols)):
            raise ValueError('State symbols must be unique.')
        self._state_derivative_symbols = tuple(
            s.diff(self._time_symbol) for s in self._state_symbols)

        self._num_collocation_nodes = int(num_collocation_nodes)

        if isinstance(node_time_interval, sm.Symbol):
            self._time_interval_symbol = node_time_interval
            self._variable_duration = True
        else:
            self._time_interval_symbol = sm.Symbol('h_opty', real=True)
            self._variable_duration = False
        self._node_time_interval = node_time_interval

        self._known_parameter_map = known_parameter_map
        self._known_trajectory_map = known_trajectory_map
        self._instance_constraints = (tuple(instance_constraints)
                                      if instance_constraints else None)

        if integration_method not in _METHODS:
            raise ValueError('integration_method must be one of {}'.format(
                _METHODS))
        self._integration_method = integration_method

        self._known_parameters, self._unknown_parameters = \
            classify_parameters(self._eom, self._time_symbol,
                                self._time_interval_symbol,
                                known_parameter_map)
        self._known_input_trajectories, self._unknown_input_trajectories = \
            classify_trajectories(self._eom, self._state_symbols,
                                  self._time_symbol, known_trajectory_map)

        for traj in self._unknown_input_trajectories:
            if traj.args != (self._time_symbol,):
                raise NotImplementedError(
                    'Implicit function {} must be supplied in the known '
                    'trajectory map (as a torch pointwise function of its '
                    'argument).'.format(traj))

        self._num_constraints = (self.num_eom
                                 * (self._num_collocation_nodes - 1))
        self._num_free = ((self.num_states
                           + self.num_unknown_input_trajectories)
                          * self._num_collocation_nodes
                          + self.num_unknown_parameters
                          + int(self._variable_duration))

        self._setup_known_trajectories()

        if self._instance_constraints is not None:
            self._num_instance_constraints = len(self._instance_constraints)
            self._num_constraints += self._num_instance_constraints
            self._identify_instance_function_atoms()
            self._find_closest_free_index()
            self._lower_instance_constraints()
        else:
            self._num_instance_constraints = 0
            self.eval_instance_constraints = None
            self.eval_instance_constraints_jacobian = None

        self._lower_eom()
        self._build_node_kernel()

    # ------------------------------------------------------------------
    # read-only properties
    # ------------------------------------------------------------------
    @property
    def eom(self):
        return self._eom

    @property
    def state_symbols(self):
        return self._state_symbols

    @property
    def state_derivative_symbols(self):
        return self._state_derivative_symbols

    @property
    def num_states(self):
        return len(self._state_symbols)

    @property
    def num_eom(self):
        return self._eom.shape[0]

    @property
    def num_collocation_nodes(self):
        return self._num_collocation_nodes

    @property
    def node_time_interval(self):
        return self._node_time_interval

    @property
    def time_interval_symbol(self):
        return self._time_interval_symbol

    @property
    def time_symbol(self):
        return self._time_symbol

    @property
    def known_parameter_map(self):
        return self._known_parameter_map

    @property
    def known_trajectory_map(self):
        return self._known_trajectory_map

    @property
    def known_parameters(self):
        return self._known_parameters

    @property
    def unknown_parameters(self):
        return self._unknown_parameters

    @property
    def parameters(self):
        return self._known_parameters + self._unknown_parameters

    @property
    def num_parameters(self):
        return len(self.parameters)

    @property
    def num_known_parameters(self):
        return len(self._known_parameters)

    @property
    def num_unknown_parameters(self):
        return len(self._unknown_parameters)

    @property
    def known_input_trajectories(self):
        return self._known_input_trajectories

    @property
    def unknown_input_trajectories(self):
        return self._unknown_input_trajectories

    @property
    def input_trajectories(self):
        return self._known_input_trajectories + \
            self._unknown_input_trajectories

    @property
    def num_input_trajectories(self):
        return len(self.input_trajectories)

    @property
    def num_known_input_trajectories(self):
        return len(self._known_input_trajectories)

    @property
    def num_unknown_input_trajectories(self):
        return len(self._unknown_input_trajectories)

    @property
    def instance_constraints(self):
        return self._instance_constraints

    @property
    def num_instance_constraints(self):
        return self._num_instance_constraints

    @property
    def num_free(self):
        return self._num_free

    @property
    def num_constraints(self):
        return self._num_constraints

    @property
    def integration_method(self):
        return self._integration_method

    @property
    def variable_duration(self):
        return self._variable_duration

    # ------------------------------------------------------------------
    # symbolic discretization introspection: the per-node symbols and
    # the discretized EoMs, built on demand with the JAX package's
    # naming (x -> xp/xi/xn, u -> ui/un); the numeric kernel never
    # uses them
    # ------------------------------------------------------------------
    def _discrete_symbols(self):
        if getattr(self, '_disc_syms', None) is not None:
            return self._disc_syms

        def sym(f, suffix):
            return sm.Symbol(f.__class__.__name__ + suffix, real=True)

        def convert_input(f, lab):
            if isinstance(f, sm.Derivative):     # dr(x(t))/dx(t)
                var, (wrt, _) = f.args
                return sm.Symbol(
                    'd' + var.__class__.__name__ + lab + '_d'
                    + wrt.__class__.__name__ + lab, real=True)
            if f.args and f.args[0] != self.time_symbol:   # r(x(t))
                di = sm.Symbol(f.args[0].__class__.__name__ + lab,
                               real=True)
                return sm.Function(f.__class__.__name__ + lab,
                                   real=True)(di)
            return sym(f, lab)                   # r(t)

        xs = self.state_symbols
        d = dict(
            xp=tuple(sym(f, 'p') for f in xs),
            xi=tuple(sym(f, 'i') for f in xs),
            xn=tuple(sym(f, 'n') for f in xs),
            ki=tuple(convert_input(f, 'i')
                     for f in self.known_input_trajectories),
            kn=tuple(convert_input(f, 'n')
                     for f in self.known_input_trajectories),
            ui=tuple(sym(f, 'i')
                     for f in self.unknown_input_trajectories),
            un=tuple(sym(f, 'n')
                     for f in self.unknown_input_trajectories),
        )
        self._disc_syms = d
        return d

    @property
    def previous_discrete_state_symbols(self):
        return self._discrete_symbols()['xp']

    @property
    def current_discrete_state_symbols(self):
        return self._discrete_symbols()['xi']

    @property
    def next_discrete_state_symbols(self):
        return self._discrete_symbols()['xn']

    @property
    def current_known_discrete_specified_symbols(self):
        return self._discrete_symbols()['ki']

    @property
    def next_known_discrete_specified_symbols(self):
        return self._discrete_symbols()['kn']

    @property
    def current_unknown_discrete_specified_symbols(self):
        return self._discrete_symbols()['ui']

    @property
    def next_unknown_discrete_specified_symbols(self):
        return self._discrete_symbols()['un']

    @property
    def current_discrete_specified_symbols(self):
        d = self._discrete_symbols()
        return d['ki'] + d['ui']

    @property
    def next_discrete_specified_symbols(self):
        d = self._discrete_symbols()
        return d['kn'] + d['un']

    @property
    def discrete_eom(self):
        """The symbolically discretized equations of motion (backward
        Euler: x' -> (xi - xp)/h, x -> xi, u -> ui; midpoint:
        x' -> (xn - xi)/h, x -> (xi + xn)/2, u -> (ui + un)/2)."""
        d = self._discrete_symbols()
        x = self.state_symbols
        xd = self.state_derivative_symbols
        u = self.input_trajectories
        ui = d['ki'] + d['ui']
        un = d['kn'] + d['un']
        h = self.time_interval_symbol
        if self.integration_method == 'backward euler':
            deriv_sub = {dd: (i - p) / h
                         for dd, i, p in zip(xd, d['xi'], d['xp'])}
            func_sub = dict(zip(tuple(x) + tuple(u), d['xi'] + ui))
            return me.msubs(self.eom, deriv_sub, func_sub)
        deriv_sub = {dd: (n - i) / h
                     for dd, i, n in zip(xd, d['xi'], d['xn'])}
        x_sub = {s: (i + n) / 2 for s, i, n in zip(x, d['xi'], d['xn'])}
        u_sub = {s: (i + n) / 2 for s, i, n in zip(u, ui, un)}
        return me.msubs(self.eom, deriv_sub, x_sub, u_sub)

    # convenience sizes for the solver
    @property
    def _nz(self):
        return self.num_states + self.num_unknown_input_trajectories

    @property
    def _bw(self):
        return self.num_unknown_parameters + int(self._variable_duration)

    # ------------------------------------------------------------------
    # known trajectories
    # ------------------------------------------------------------------
    def _tensor(self, values):
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               dtype=self._dtype, device=self._device)

    def _setup_known_trajectories(self):
        """Classify the known-trajectory values, as the JAX package does:

        * an (N,) array: fixed per-node values;
        * a callable of the free vector returning (N,) values (an
          explicit function of time): known, so held constant in the
          Jacobian (``detach``);
        * for an implicit function of a state ``f(x(t))``, a pointwise
          torch function of the state, evaluated inside the per-node
          kernel and differentiated by autodiff;
        * for ``f(x(t))``, data as above (an array or a callable of the
          free vector) paired with a ``Derivative(f(x), x)`` entry of
          slope values: the value enters the kernel in the
          straight-through form ``v + dv (x - x)`` with v, dv and the
          second x detached, the chain rule of the data (first order;
          its Hessian contribution is zero).

        Callables are probed with a free vector of ones on the CPU.
        """
        N = self._num_collocation_nodes
        tmap = self._known_trajectory_map
        deriv_of = {key.expr: key for key in tmap
                    if isinstance(key, sm.Derivative)}
        specs = {}
        # on the problem's device: a callable may hold tensors there
        probe = torch.ones(self.num_free, dtype=torch.float64,
                           device=self._device)

        def shape_of(out):
            return tuple(out.shape) if isinstance(out, torch.Tensor) \
                else np.shape(out)

        def data_spec(key, val):
            """('array', tensor) or ('free_callable', fn) for (N,) data."""
            if callable(val) and not isinstance(val, np.ndarray):
                if shape_of(val(probe))[-1:] != (N,):
                    raise ValueError(
                        'The known parameter {} is not length {}.'
                        .format(key, N))
                return ('free_callable', val, None)
            arr = np.asarray(val, dtype=np.float64)
            if len(arr) != N:
                raise ValueError(
                    'The known parameter {} is not length {}.'.format(
                        key, N))
            return ('array', self._tensor(arr), None)

        def is_pointwise(val):
            """A pointwise scalar map (which maps the probe elementwise
            or refuses it) rather than a callable of the free vector."""
            if not callable(val) or isinstance(val, np.ndarray):
                return False
            try:
                shape = shape_of(val(probe))
            except Exception:
                return True
            return shape == () or shape == (self.num_free,)

        for key, val in tmap.items():
            args = getattr(key, 'args', (self._time_symbol,))
            implicit = (not isinstance(key, sm.Derivative)
                        and len(args) == 1
                        and args[0] != self._time_symbol)
            if not implicit:
                specs[key] = data_spec(key, val)
                continue
            state = key.args[0]
            if state not in self._state_symbols:
                raise ValueError(
                    'Implicit function {} must be a function of a '
                    'state.'.format(key))
            state_idx = self._state_symbols.index(state)
            if is_pointwise(val):
                specs[key] = ('pointwise', val, state_idx)
            else:
                if key not in deriv_of:
                    raise ValueError(
                        'Implicit known trajectory {} is given as data '
                        '(array or callable of the free vector); its '
                        'derivative values must also be provided under '
                        'the key Derivative({}, {}), or supply a '
                        'pointwise torch function instead.'
                        .format(key, key, state))
                specs[key] = ('implicit_table', data_spec(key, val),
                              state_idx, deriv_of[key])
        self._known_traj_specs = specs

    def _known_traj_array_values(self, free):
        """(N, k) per-node values of the array and free-callable known
        trajectories (pointwise columns are zero placeholders)."""
        N = self._num_collocation_nodes
        cols = []
        for key in self._known_input_trajectories:
            spec = self._known_traj_specs[key]
            if spec[0] == 'implicit_table':
                spec = spec[1]      # the base function's data sub-spec
            kind, val = spec[0], spec[1]
            if kind == 'array':
                cols.append(val)
            elif kind == 'free_callable':
                cols.append(torch.as_tensor(val(free)).to(
                    free.dtype).detach())
            else:
                cols.append(free.new_zeros((N,)))
        if cols:
            return torch.stack(cols, dim=1)
        return free.new_zeros((N, 0))

    # ------------------------------------------------------------------
    # instance constraints
    # ------------------------------------------------------------------
    def _identify_instance_function_atoms(self):
        all_funcs = set()
        for con in self._instance_constraints:
            all_funcs |= con.atoms(sm.Function)
        self.instance_constraint_function_atoms = all_funcs

    def _find_closest_free_index(self):
        """Map each instance function atom, e.g. ``x(0.0)`` or
        ``x(3*h)``, to its free-vector index."""
        N = self._num_collocation_nodes
        n = self.num_states

        def free_index(time_index, func_of_t):
            if func_of_t in self._state_symbols:
                return time_index + self._state_symbols.index(func_of_t) * N
            elif func_of_t in self._unknown_input_trajectories:
                return (time_index + n * N +
                        self._unknown_input_trajectories.index(func_of_t) * N)
            return None

        h = self._node_time_interval
        node_map = {}
        for func in self.instance_constraint_function_atoms:
            if self._variable_duration:
                if func.args[0] == 0:
                    time_idx = 0
                else:
                    ratio = func.args[0] / self._time_interval_symbol
                    # a numeric multiple of h that is not an integer
                    # raises, as in the JAX package
                    if getattr(ratio, 'is_number', False) \
                            and ratio != sm.Integer(int(ratio)):
                        raise TypeError(
                            'Instance constraint {} is not a correct '
                            'integer multiple of the time interval.'
                            .format(func))
                    try:
                        time_idx = int(ratio)
                    except TypeError as err:
                        raise TypeError(
                            'Instance constraint {} is not a correct '
                            'integer multiple of the time interval.'
                            .format(func)) from err
                if time_idx not in range(N):
                    raise ValueError(
                        'Instance constraint {} gives an index of {} which '
                        'is not between 0 and {}.'.format(
                            func, time_idx, N - 1))
            else:
                time_value = float(func.args[0])
                duration = h * (N - 1)
                time_vector = np.linspace(0.0, duration, num=N)
                time_idx = int(np.argmin(np.abs(time_vector - time_value)))
            idx = free_index(time_idx, func.__class__(self._time_symbol))
            if idx is None:
                raise ValueError(
                    'Instance constraint function {} is neither a state '
                    'nor an unknown input trajectory.'.format(func))
            node_map[func] = idx
        self.instance_constraints_free_index_map = node_map

    def _lower_instance_constraints(self):
        """Lower the instance constraints to a torch function of
        ``free``; its Jacobian is ``torch.func.jacrev`` of it.  With a
        variable duration the interval symbol maps to ``free[-1]``, so
        the d(instance)/dh entries are exact."""
        free = sm.DeferredVector('FREE')
        def_map = {k: free[v] for k, v in
                   self.instance_constraints_free_index_map.items()}
        if self._variable_duration:
            def_map[self._time_interval_symbol] = free[self.num_free - 1]
        subbed = [con.subs(def_map) for con in self._instance_constraints]
        kp_keys = list(self._known_parameter_map.keys())
        raw = sm.lambdify([free] + kp_keys, subbed, modules='torch',
                          docstring_limit=0)
        kp_vals = [float(v) for v in self._known_parameter_map.values()]

        def g(free_vec):
            out = raw(free_vec, *kp_vals)
            return torch.stack([_as_tensor_like(v, free_vec).to(self._dtype)
                                for v in out])

        self.eval_instance_constraints = g
        self.eval_instance_constraints_jacobian = jacrev(g)

        touched = []
        for con in self._instance_constraints:
            idxs = sorted({self.instance_constraints_free_index_map[f]
                           for f in con.atoms(sm.Function)})
            if self._variable_duration and con.has(
                    self._time_interval_symbol):
                idxs.append(self.num_free - 1)
            touched.append(idxs)
        self._instance_touched_indices = touched

    # ------------------------------------------------------------------
    # EoM lowering and the per-node kernel
    # ------------------------------------------------------------------
    def _lower_eom(self):
        """Lower the continuous EoM matrix to a torch scalar kernel
        (atoms replaced top-down by dummies, as in the JAX package, so
        nested atoms such as ``theta(x(t))`` and ``x(t)`` stay apart)."""
        atoms = (list(self._state_derivative_symbols)
                 + list(self._state_symbols)
                 + list(self._known_input_trajectories)
                 + list(self._unknown_input_trajectories)
                 + list(self._known_parameters)
                 + list(self._unknown_parameters)
                 + [self._time_symbol])
        dummies = [sm.Dummy('a{}'.format(i)) for i in range(len(atoms))]
        repl = dict(zip(atoms, dummies))
        exprs = [e.xreplace(repl) for e in self._eom]
        self._eom_fn = lambdify_torch(dummies, exprs)
        self._kp_vals = self._tensor(
            [float(v) for v in self._known_parameter_map.values()])

    def _build_node_kernel(self):
        n = self.num_states
        q = self.num_unknown_input_trajectories
        r = self.num_unknown_parameters
        var_h = self._variable_duration
        method = self._integration_method
        eom_fn = self._eom_fn
        kp_vals = self._kp_vals
        known_keys = self._known_input_trajectories
        specs = self._known_traj_specs
        h_const = None if var_h else float(self._node_time_interval)

        # column of each implicit-data function's Derivative entry
        dcol = {key: known_keys.index(spec[3])
                for key, spec in specs.items()
                if spec[0] == 'implicit_table'}

        def kt_value(key, col, x_node, kt_row):
            spec = specs[key]
            if spec[0] == 'pointwise':
                return spec[1](x_node[spec[2]])
            if spec[0] == 'implicit_table':
                # straight-through: the value from the data column, the
                # slope from the Derivative(f(x), x) column
                xs = x_node[spec[2]]
                return kt_row[col].detach() + kt_row[dcol[key]].detach() \
                    * (xs - xs.detach())
            return kt_row[col]

        def kernel(z_cur, z_adj, w, idx, kt_cur_row, kt_adj_row):
            """Residual block for one collocation interval.

            Backward Euler: current node i, adjacent node i-1;
            f((x_i - x_{i-1})/h, x_i, u_i, p, t_i).  Midpoint: current
            node i, adjacent node i+1; f((x_{i+1} - x_i)/h,
            (x_i + x_{i+1})/2, (u_i + u_{i+1})/2, p, t_i + h/2).
            """
            x_cur = z_cur[:n]
            u_cur = z_cur[n:]
            x_adj = z_adj[:n]
            u_adj = z_adj[n:]
            p_unknown = w[:r]
            h = w[r] if var_h else h_const
            idxf = idx.to(z_cur.dtype)

            if method == 'backward euler':
                xdot = (x_cur - x_adj) / h
                x_val = x_cur
                u_val = u_cur
                t_val = idxf * h
                kt_vals = [kt_value(k, c, x_cur, kt_cur_row)
                           for c, k in enumerate(known_keys)]
            else:
                xdot = (x_adj - x_cur) / h
                x_val = 0.5 * (x_cur + x_adj)
                u_val = 0.5 * (u_cur + u_adj)
                t_val = (idxf + 0.5) * h
                kt_vals = [0.5 * (kt_value(k, c, x_cur, kt_cur_row)
                                  + kt_value(k, c, x_adj, kt_adj_row))
                           for c, k in enumerate(known_keys)]

            args = ([xdot[i] for i in range(n)]
                    + [x_val[i] for i in range(n)]
                    + kt_vals
                    + [u_val[i] for i in range(q)]
                    + [kp_vals[i] for i in range(len(kp_vals))]
                    + [p_unknown[i] for i in range(r)]
                    + [t_val])
            return eom_fn(*args)

        self.node_kernel = kernel
        nz = self._nz
        self._jac_kernel = jacfwd(kernel, argnums=(0, 1, 2))

        def node_lagrangian_hessian(z_cur, z_adj, w, idx, ktc, kta, y_row):
            def scal(v):
                res = kernel(v[:nz], v[nz:2 * nz], v[2 * nz:], idx, ktc,
                             kta)
                return torch.dot(y_row, res)

            return hessian(scal)(torch.cat([z_cur, z_adj, w]))

        self._node_hessian = node_lagrangian_hessian

    # ------------------------------------------------------------------
    # layout transforms
    # ------------------------------------------------------------------
    def unpack_free(self, free):
        """free -> (Z (N, n+q) node-major, w (bw,))."""
        n = self.num_states
        q = self.num_unknown_input_trajectories
        N = self._num_collocation_nodes
        X = free[:n * N].reshape(n, N)
        U = free[n * N:(n + q) * N].reshape(q, N)
        Z = torch.cat([X.T, U.T], dim=1)
        return Z, free[(n + q) * N:]

    def pack_free(self, Z, w):
        """(Z, w) -> free vector (state-major reference layout)."""
        n = self.num_states
        q = self.num_unknown_input_trajectories
        parts = [Z[:, :n].T.reshape(-1)]
        if q:
            parts.append(Z[:, n:].T.reshape(-1))
        parts.append(w)
        return torch.cat(parts)

    def _node_indices(self):
        """(cur, adj) node indices per constraint interval."""
        N = self._num_collocation_nodes
        first = torch.arange(0, N - 1, device=self._device)
        if self._integration_method == 'backward euler':
            return first + 1, first
        return first, first + 1

    def _per_interval(self, fn, free, *extra):
        """``fn(z_cur, z_adj, w, idx, kt_cur, kt_adj, *extra)`` over the
        intervals (w shared, every other argument per interval)."""
        Z, w = self.unpack_free(free)
        KT = self._known_traj_array_values(free)
        cur, adj = self._node_indices()
        in_dims = (0, 0, None, 0, 0, 0) + (0,) * len(extra)
        return vmap(fn, in_dims=in_dims)(Z[cur], Z[adj], w, cur, KT[cur],
                                         KT[adj], *extra)

    # ------------------------------------------------------------------
    # evaluators (one free vector; vmap them over lanes)
    # ------------------------------------------------------------------
    def constraints_nodewise(self, free):
        """Returns (eom residuals (N-1, M), instance residuals (o,))."""
        res = self._per_interval(self.node_kernel, free)
        if self._num_instance_constraints:
            inst = self.eval_instance_constraints(free)
        else:
            inst = free.new_zeros((0,))
        return res, inst

    def constraints(self, free):
        """Full constraint vector (eom-major then instance constraints)."""
        res, inst = self.constraints_nodewise(free)
        return torch.cat([res.T.reshape(-1), inst])

    def jacobian_blocks(self, free):
        """Per-interval dense Jacobian blocks via forward-mode AD.

        Returns (A, B, C, G): A (N-1, M, n+q) wrt the current node, B wrt
        the adjacent node, C (N-1, M, bw) wrt [p, h] and G (o, nfree)
        dense instance rows."""
        A, B, C = self._per_interval(self._jac_kernel, free)
        if self._num_instance_constraints:
            G = self.eval_instance_constraints_jacobian(free)
        else:
            G = free.new_zeros((0, self.num_free))
        return A, B, C, G

    def hessian_blocks(self, free, y_nodes):
        """Exact EoM part of the Lagrangian Hessian, as node blocks.

        y_nodes: (N-1, M) multipliers of the eom rows.  Returns
        (Hd (N,nz,nz), Ho (N,nz,nz) block (k-1,k), Hw (N,nz,bw),
        Hww (bw,bw))."""
        nz = self._nz
        bw = self._bw
        N = self._num_collocation_nodes
        H = self._per_interval(self._node_hessian, free, y_nodes)
        cur, adj = self._node_indices()
        H_cc = H[:, :nz, :nz]
        H_aa = H[:, nz:2 * nz, nz:2 * nz]
        H_cw = H[:, :nz, 2 * nz:]
        H_aw = H[:, nz:2 * nz, 2 * nz:]
        zeros = free.new_zeros((N, nz, nz))
        Hd = zeros.index_add(0, cur, H_cc).index_add(0, adj, H_aa)
        Hw = free.new_zeros((N, nz, bw)).index_add(0, cur, H_cw) \
            .index_add(0, adj, H_aw)
        Hww = torch.sum(H[:, 2 * nz:, 2 * nz:], dim=0)
        if self._integration_method == 'backward euler':
            # block (i-1, i): rows z_adj (node i-1), cols z_cur (node i)
            Ho = zeros.index_add(0, cur, H[:, nz:2 * nz, :nz])
        else:
            # block (i, i+1): rows z_cur (node i), cols z_adj (node i+1)
            Ho = zeros.index_add(0, adj, H[:, :nz, nz:2 * nz])
        return Hd, Ho, Hw, Hww

    # ------------------------------------------------------------------
    # reference-API constraint / sparse-Jacobian functions
    # ------------------------------------------------------------------
    def generate_constraint_function(self):
        """Returns con(free) -> ndarray (M*(N-1)+o,)."""
        return lambda free: self.constraints(self._tensor(free)).cpu().numpy()

    def generate_jacobian_function(self):
        """Returns con_jac(free) -> COO values matching
        ``jacobian_indices`` (node-major blocks then instance rows)."""
        n = self.num_states
        midpoint = self._integration_method == 'midpoint'
        touched = (self._instance_touched_indices
                   if self._num_instance_constraints else [])

        def jac_values(free):
            A, B, C, G = self.jacobian_blocks(self._tensor(free))
            cols = [A[:, :, :n], B[:, :, :n], A[:, :, n:]]
            if midpoint:
                cols.append(B[:, :, n:])
            cols.append(C)
            vals = torch.cat(cols, dim=2).reshape(-1)
            inst_vals = [G[i, torch.as_tensor(ti, device=G.device)]
                         for i, ti in enumerate(touched)]
            return torch.cat([vals] + inst_vals).cpu().numpy()

        return jac_values

    def jacobian_indices(self):
        """(rows, cols) COO indices matching
        ``generate_jacobian_function``: per interval the M x W dense
        block in row-major order with columns [x_cur (n), x_adj (n),
        u_cur (q), (u_adj (q) midpoint only), p (r), h (s)], then the
        instance-constraint entries (sorted touched indices per
        constraint, the h column last where present)."""
        n = self.num_states
        q = self.num_unknown_input_trajectories
        r = self.num_unknown_parameters
        s = int(self._variable_duration)
        M = self.num_eom
        N = self._num_collocation_nodes
        cur, adj = (a.cpu().numpy() for a in self._node_indices())
        num_intervals = N - 1
        midpoint = self._integration_method == 'midpoint'

        W = 2 * n + q + (q if midpoint else 0) + r + s
        col_block = np.empty((num_intervals, W), dtype=int)
        col_block[:, :n] = cur[:, None] + np.arange(n)[None, :] * N
        col_block[:, n:2 * n] = adj[:, None] + np.arange(n)[None, :] * N
        ofs = 2 * n
        if q:
            col_block[:, ofs:ofs + q] = (n * N + cur[:, None]
                                         + np.arange(q)[None, :] * N)
            ofs += q
            if midpoint:
                col_block[:, ofs:ofs + q] = (n * N + adj[:, None]
                                             + np.arange(q)[None, :] * N)
                ofs += q
        if r:
            col_block[:, ofs:ofs + r] = (n + q) * N + np.arange(r)[None, :]
            ofs += r
        if s:
            col_block[:, ofs] = self.num_free - 1

        rows_block = (np.arange(M)[None, :] * num_intervals
                      + np.arange(num_intervals)[:, None])  # (I, M)
        rows = np.repeat(rows_block[:, :, None], W, axis=2).reshape(-1)
        cols = np.repeat(col_block[:, None, :], M, axis=1).reshape(-1)

        if self._num_instance_constraints:
            base = M * num_intervals
            irows, icols = [], []
            for i, ti in enumerate(self._instance_touched_indices):
                irows += [base + i] * len(ti)
                icols += list(ti)
            rows = np.concatenate([rows, np.array(irows, dtype=int)])
            cols = np.concatenate([cols, np.array(icols, dtype=int)])
        return rows.astype(np.int32), cols.astype(np.int32)
