"""User-facing Problem class.

The counterpart of opty_tpu/problem.py: the same constructor, free
vector and constraint ordering, bound arrays, ``solve`` result
contract (with ``respect_bounds``), ``solve_batch`` and the
lane-refilling ``solve_queue``, the free-vector utilities
(``extract_values``, ``fill_free``, ``time_vector``,
``create_linear_initial_guess``) and the ``plot_*`` methods (plotting.py,
which needs matplotlib), plus ``device`` (``None`` means the card; see
config.resolve_device).

Every solve is one batched solver (nlp/ipm.py) over B lanes; ``solve``
is B = 1.  ``chunk_iters`` sets how many iterations run between host
syncs of the solve loop (the JAX package uses the same option to keep
TPU launches short); the queue refills finished lanes at each of them.
"""

import inspect
import time

import numpy as np
import sympy as sm
import torch

from .config import default_dtype, resolve_device
from .nlp.collocation import make_collocation_nlp_functions
from .nlp.ipm import IPMOptions, IPMResult, solve_ipm
from .nlp.kkt import check_method
from .nlp.status import STATUS_MESSAGES
from .transcribe.collocator import ConstraintCollocator
from .utils import parse_free
from . import plotting

__all__ = ['Problem']

# Ipopt option names accepted by add_option (the reference's cyipopt
# passthrough) and the IPMOptions fields they set
_IPOPT_OPTION_MAP = {
    'tol': 'tol',
    'acceptable_tol': 'acceptable_tol',
    'acceptable_iter': 'acceptable_iter',
    'max_iter': 'max_iter',
    'mu_init': 'mu_init',
}


class Problem:
    """Direct collocation NLP problem (see opty_tpu.Problem for the
    free-variable and constraint ordering; both are reproduced)."""

    INF = 10e19

    def __init__(self, obj, obj_grad, equations_of_motion, state_symbols,
                 num_collocation_nodes, node_time_interval,
                 known_parameter_map={}, known_trajectory_map={},
                 instance_constraints=None, time_symbol=None,
                 integration_method='backward euler', bounds=None,
                 eom_bounds=None, dtype=None, device=None, mesh=None):
        if not equations_of_motion.has(sm.Derivative):
            raise ValueError('No time derivatives are present.'
                             ' The equations of motion must be ordinary '
                             'differential equations (ODEs) or '
                             'differential algebraic equations (DAEs).')
        self.device = resolve_device(device)
        self._dtype = dtype or default_dtype()
        self.collocator = ConstraintCollocator(
            equations_of_motion, state_symbols, num_collocation_nodes,
            node_time_interval, known_parameter_map, known_trajectory_map,
            instance_constraints, time_symbol, integration_method,
            dtype=self._dtype, device=self.device)

        self._bounds = bounds
        if eom_bounds is not None:
            bad = [k for k in eom_bounds
                   if k not in range(self.collocator.num_eom)]
            if bad:
                raise ValueError('Keys {} in eom_bounds do not correspond '
                                 'to equations of motion.'.format(bad))
        self._eom_bounds = eom_bounds
        self._wrap_objective(obj, obj_grad)

        self.num_free = self.collocator.num_free
        self.num_constraints = self.collocator.num_constraints
        self.con = self.collocator.generate_constraint_function()
        self.con_jac = self.collocator.generate_jacobian_function()
        self.con_jac_rows, self.con_jac_cols = \
            self.collocator.jacobian_indices()

        self._generate_bound_arrays()
        self._generate_constraint_bound_arrays()
        self._extraction_indices = self._extraction_indices_static()

        self._ipm_options = IPMOptions()
        self._factor_dtype = None
        self._kkt_method = None
        self._refine_steps = None
        self._chunk_iters = None
        # the node mesh of kkt_method='spike' (parallel/mesh.py)
        self._mesh = mesh
        self.obj_value = []

    # ------------------------------------------------------------------
    def _wrap_objective(self, obj, obj_grad):
        def num_args(f):
            try:
                sig = inspect.signature(f)
            except (TypeError, ValueError):
                return 1
            return len([p for p in sig.parameters.values()
                        if p.default is inspect.Parameter.empty
                        and p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)])

        if num_args(obj) not in (1, 2):
            raise ValueError('The objective function can only have one or '
                             'two arguments.')
        self.obj = obj
        self.obj_grad = obj_grad
        if num_args(obj) == 2:
            self._obj_fn = lambda free: obj(self, free)
        else:
            self._obj_fn = obj
        if obj_grad is None:
            self._obj_grad_fn = None
        elif num_args(obj_grad) == 2:
            self._obj_grad_fn = lambda free: obj_grad(self, free)
        else:
            self._obj_grad_fn = obj_grad

    @property
    def bounds(self):
        """The bounds dictionary mapping unknown variables to
        (lower, upper) tuples."""
        return self._bounds

    @property
    def eom_bounds(self):
        """The equation-of-motion bounds dictionary mapping eom row
        index to (lower, upper)."""
        return self._eom_bounds

    def _generate_bound_arrays(self):
        """Box bounds in free-vector layout: scalars or per-node (N,)
        arrays for trajectories; default (-INF, INF)."""
        lb = np.full(self.num_free, -self.INF)
        ub = np.full(self.num_free, self.INF)
        if self._bounds is not None:
            d = self._extraction_indices_static()
            for var, (low, upp) in self._bounds.items():
                if var not in d:
                    raise ValueError(
                        'Bound variable {} is not an unknown state, '
                        'trajectory, parameter, or time interval.'
                        .format(var))
                idxs = d[var]
                lb[idxs] = np.broadcast_to(np.asarray(low, dtype=float),
                                           (len(idxs),))
                ub[idxs] = np.broadcast_to(np.asarray(upp, dtype=float),
                                           (len(idxs),))
        self.lower_bound = lb
        self.upper_bound = ub

    def _generate_constraint_bound_arrays(self):
        """cl/cu rows: equality (0, 0) by default; the rows of an
        ``eom_bounds`` entry become path inequalities."""
        ni = self.collocator.num_collocation_nodes - 1
        cl = np.zeros(self.num_constraints)
        cu = np.zeros(self.num_constraints)
        if self._eom_bounds is not None:
            for idx, (low, upp) in self._eom_bounds.items():
                cl[idx * ni:(idx + 1) * ni] = low
                cu[idx * ni:(idx + 1) * ni] = upp
        self._low_con_bounds = cl
        self._upp_con_bounds = cu

    def _extraction_indices_static(self):
        d = {}
        col = self.collocator
        N = col.num_collocation_nodes
        n = col.num_states
        q = col.num_unknown_input_trajectories
        r = col.num_unknown_parameters
        for i, var in enumerate(col.state_symbols):
            d[var] = list(range(i * N, (i + 1) * N))
        for i, var in enumerate(col.unknown_input_trajectories):
            d[var] = list(range(n * N + i * N, n * N + (i + 1) * N))
        for i, var in enumerate(col.unknown_parameters):
            d[var] = [(n + q) * N + i]
        if col.variable_duration:
            d[col.time_interval_symbol] = [(n + q) * N + r]
        return d

    # ------------------------------------------------------------------
    # solver configuration
    # ------------------------------------------------------------------
    def add_option(self, name, value):
        """Sets a solver option by its Ipopt name (the reference's
        cyipopt ``add_option``): ``tol``, ``acceptable_tol``,
        ``acceptable_iter``, ``max_iter`` and ``mu_init`` map onto
        IPMOptions; any other name is ignored with a warning."""
        if name in _IPOPT_OPTION_MAP:
            field = _IPOPT_OPTION_MAP[name]
            caster = int if field in ('max_iter', 'acceptable_iter') \
                else float
            self._ipm_options = self._ipm_options._replace(
                **{field: caster(value)})
        else:
            import warnings
            warnings.warn(
                "Solver option '{}' has no IPM mapping and is ignored "
                '(output/print options have no meaning here; use '
                'set_solver_options for native options).'.format(name),
                stacklevel=2)

    def set_solver_options(self, factor_dtype=None, kkt_method=None,
                           **kwargs):
        """Directly set IPMOptions fields.

        ``factor_dtype`` selects the KKT factorization precision
        (float32 + refinement on the card, float64 on the CPU by
        default); ``kkt_method`` is 'scan' or 'cr' (default: 'cr' on
        the card, 'scan' on the CPU) or 'spike' (the factorization
        split over the slabs of ``mesh``, a parallel.mesh.NodeMesh);
        ``mesh``, ``refine_steps`` and ``chunk_iters`` are accepted as
        in opty_tpu."""
        if factor_dtype is not None:
            self._factor_dtype = _torch_dtype(factor_dtype)
        if kkt_method is not None:
            check_method(kkt_method)
            self._kkt_method = kkt_method
        if 'mesh' in kwargs:
            self._mesh = kwargs.pop('mesh')
        if 'refine_steps' in kwargs:
            self._refine_steps = kwargs.pop('refine_steps')
        if 'chunk_iters' in kwargs:
            self._chunk_iters = kwargs.pop('chunk_iters')
        self._ipm_options = self._ipm_options._replace(**kwargs)

    # ------------------------------------------------------------------
    # solving
    # ------------------------------------------------------------------
    def _warn_if_hessian_structure_violated(self, free):
        """One-time aliasing check of the structured Hessian recovery
        (transcribe/hessian.py); warns instead of failing."""
        if getattr(self, '_hessian_checked', False):
            return
        self._hessian_checked = True
        from .transcribe.hessian import check_structured_hessian
        col = self.collocator

        def phi(f):
            val = self._obj_fn(f)
            if col.num_instance_constraints:
                val = val + torch.sum(col.eval_instance_constraints(f))
            return val

        err = check_structured_hessian(
            phi, self._as_tensor(free), col.num_collocation_nodes,
            col.num_states, col.num_unknown_input_trajectories, col._bw)
        if err > 1e-6:
            import warnings
            warnings.warn(
                'The objective/instance constraints couple collocation '
                'nodes beyond the block-tridiagonal Hessian structure '
                '(relative aliasing error {:.1e}); the solver will run '
                'as an inexact-Newton method with a possibly reduced '
                'local convergence rate.'.format(err), stacklevel=3)

    def _as_tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self._dtype, device=self.device)

    def _build_solver(self):
        """(run_warm, run_cold, run_resume) over a batch of lanes: single,
        batch and queue solves all go through the batched solver."""
        options = self._ipm_options
        col = self.collocator
        obj_fn, grad_fn = self._obj_fn, self._obj_grad_fn
        lb = self._as_tensor(self.lower_bound)
        ub = self._as_tensor(self.upper_bound)
        cl = self._as_tensor(self._low_con_bounds)
        cu = self._as_tensor(self._upp_con_bounds)
        chunk = self._effective_chunk()

        def unscale(res, sf, dsc):
            """Map the scaled-NLP result back to user units."""
            sf_ = sf[:, None]
            return res._replace(
                obj_val=res.obj_val / sf, g=res.g / dsc,
                mult_g=res.mult_g * dsc / sf_,
                mult_x_L=res.mult_x_L / sf_, mult_x_U=res.mult_x_U / sf_,
                obj_history=res.obj_history / sf_)

        def run(free, **kw):
            fns, (sf, dsc) = make_collocation_nlp_functions(
                col, obj_fn, grad_fn, scale_from=free,
                factor_dtype=self._factor_dtype,
                refine_steps=self._refine_steps,
                kkt_method=self._kkt_method, mesh=self._mesh)
            warm = kw.pop('warm', None)
            if warm is not None:
                y0, zl0, zu0 = warm
                kw.update(y0=y0 * sf[:, None] / dsc, zL0=zl0 * sf[:, None],
                          zU0=zu0 * sf[:, None])
            res, state = solve_ipm(fns, free, lb, ub, cl * dsc, cu * dsc,
                                   options=options, iter_budget=chunk,
                                   return_state=True, **kw)
            return unscale(res, sf, dsc), state

        def run_warm(free, y0, zl0, zu0):
            return run(free, warm=(y0, zl0, zu0))

        def run_cold(free):
            return run(free)

        def run_resume(free, state, fresh=None):
            return run(free, resume_state=state, refill=fresh)

        return run_warm, run_cold, run_resume

    def solve(self, free, lagrange=[], zl=[], zu=[], respect_bounds=False):
        """Returns the optimal solution and an info dictionary with keys
        ``x``, ``g``, ``obj_val``, ``mult_g``, ``mult_x_L``,
        ``mult_x_U``, ``status``, ``status_msg`` (the reference
        contract) plus iteration telemetry.  ``respect_bounds`` first
        checks the guess and the bounds (``check_bounds_conflict``)."""
        if respect_bounds:
            self.check_bounds_conflict(free)
        self._warn_if_hessian_structure_violated(free)
        run_warm, run_cold, run_resume = self._build_solver()
        x = self._as_tensor(free)[None]
        if len(lagrange):
            zl = zl if len(zl) else np.ones(self.num_free)
            zu = zu if len(zu) else np.ones(self.num_free)
            res, state = run_warm(x, self._as_tensor(lagrange)[None],
                                  self._as_tensor(zl)[None],
                                  self._as_tensor(zu)[None])
        else:
            res, state = run_cold(x)
        res, state = self._drain(run_resume, x, res, state)
        return self._package_result(res)

    def solve_batch(self, free_batch, devices=None):
        """Solve a batch of instances, one lane each: rows of
        ``free_batch`` are independent initial guesses.  Returns the
        IPMResult with a leading batch axis (tensors on the device).
        ``devices`` is accepted and not read, as in opty_tpu (whose
        solve_batch takes it and never reads it); a batch split over
        devices is parallel.solve_batch_sharded's."""
        _, run_cold, run_resume = self._build_solver()
        free_batch = self._as_tensor(free_batch)
        res, state = run_cold(free_batch)
        res, state = self._drain(run_resume, free_batch, res, state)
        return res

    def solve_queue(self, free_queue, batch_size=None, progress=None):
        """Solve a queue of instances on ``batch_size`` lanes, refilling
        each finished lane with the next queued instance.

        ``free_queue`` has shape (Q, num_free).  Returns an IPMResult of
        numpy arrays with a leading axis in queue order.
        ``progress(n_done, n_total, chunk_seconds)`` is called after
        every chunk (the chunk time ends with a device sync)."""
        free_queue = np.asarray(free_queue, dtype=np.float64)
        Q = free_queue.shape[0]
        B = min(batch_size or 32, Q)
        _, run_b, refill_b = self._build_solver()
        max_iter = self._ipm_options.max_iter

        lane_inst = np.arange(B)           # queue index per lane
        next_inst = B
        results = [None] * Q
        free_host = free_queue[:B].copy()
        free_batch = self._as_tensor(free_host)

        def host(t):
            return t.detach().cpu().numpy()

        t0 = time.time()
        res, state = run_b(free_batch)
        done = host(state.done) | (host(state.it) >= max_iter)
        if progress is not None:
            progress(0, Q, time.time() - t0)

        n_retired = 0
        while True:
            if np.any(done):
                # fetch only the finished lanes: one gather on the
                # device, then one host transfer
                done_lanes = np.where(done)[0]
                take = torch.as_tensor(done_lanes, device=self.device)
                res_host = [host(a[take]) for a in res]
                fresh = np.zeros(B, dtype=bool)
                for li, lane in enumerate(done_lanes):
                    inst = lane_inst[lane]
                    if inst >= 0 and results[inst] is None:
                        results[inst] = [a[li] for a in res_host]
                        n_retired += 1
                    if next_inst < Q:
                        lane_inst[lane] = next_inst
                        free_host[lane] = free_queue[next_inst]
                        fresh[lane] = True
                        next_inst += 1
                    else:
                        lane_inst[lane] = -1   # parked
                free_batch = self._as_tensor(free_host)
                if n_retired >= Q:
                    break
                if not np.any(fresh) and np.all(done):
                    break  # all lanes parked
                t0 = time.time()
                res, state = refill_b(
                    free_batch, state,
                    torch.as_tensor(fresh, device=self.device))
            else:
                t0 = time.time()
                res, state = refill_b(free_batch, state, None)
            done = host(state.done) | (host(state.it) >= max_iter)
            # parked lanes count as done so the loop can finish
            done = done | (lane_inst < 0)
            if progress is not None:
                progress(n_retired, Q, time.time() - t0)

        return IPMResult(*[np.stack(field) for field in zip(*results)])

    def _effective_chunk(self):
        """Iterations between host syncs of the solve loop (None = run
        every lane to its end in one call)."""
        return self._chunk_iters or None

    def _drain(self, run_resume, free, res, state):
        """Host loop finishing a chunked solve."""
        if self._effective_chunk() is None:
            return res, state
        max_iter = self._ipm_options.max_iter
        while True:
            if bool(state.done.all()) or \
                    int(state.it.max()) >= max_iter:
                return res, state
            res, state = run_resume(free, state)

    def _package_result(self, res):
        res = IPMResult(*[np.asarray(a.detach().cpu().numpy())[0]
                          for a in res])
        hist = res.obj_history
        self.obj_value = list(hist[np.isfinite(hist)])
        status = int(res.status)
        info = {
            'x': res.x,
            'g': res.g,
            'obj_val': float(res.obj_val),
            'mult_g': res.mult_g,
            'mult_x_L': res.mult_x_L,
            'mult_x_U': res.mult_x_U,
            'status': status,
            'status_msg': STATUS_MESSAGES.get(
                status, b'Unknown status.').decode(),
            'iterations': int(res.iterations),
            'inf_pr': float(res.inf_pr),
            'inf_du': float(res.inf_du),
            'rest_iterations': int(res.rest_total),
            'mono_fallback': bool(res.mono),
            'delta_w': float(res.delta_w),
        }
        return res.x, info

    def check_bounds_conflict(self, free):
        """Raises ValueError if the initial guess violates any bound or
        a lower bound exceeds an upper bound, reversed eom_bounds
        included."""
        if self._eom_bounds is not None:
            rev = [k for k, (lo, hi) in self._eom_bounds.items() if lo > hi]
            if rev:
                raise ValueError(
                    'The lower bound(s) for eom_bounds {} is (are) '
                    'greater than the upper bound(s).'.format(rev))
        lb, ub = self.lower_bound, self.upper_bound
        free = np.asarray(free)
        if np.any(lb > ub):
            bad = np.where(lb > ub)[0]
            raise ValueError('Lower bound(s) greater than upper bound(s) '
                             'at free indices {}.'.format(bad.tolist()))
        viol = (free < lb) | (free > ub)
        if np.any(viol):
            names = self._names_for_indices(np.where(viol)[0])
            raise ValueError(
                'Initial guess violates bounds for: {}.'.format(names))

    def _names_for_indices(self, idxs):
        inv = {}
        for var, ind in self._extraction_indices.items():
            for i in ind:
                inv[i] = var
        return sorted({str(inv.get(i, i)) for i in idxs})

    # ------------------------------------------------------------------
    # free-vector utilities and callbacks
    # ------------------------------------------------------------------
    def parse_free(self, free):
        """Parses the free vector into (states (n, N), specifieds,
        constants[, h])."""
        col = self.collocator
        return parse_free(free, col.num_states,
                          col.num_unknown_input_trajectories,
                          col.num_collocation_nodes,
                          col.variable_duration)

    def _indices_of(self, variables):
        idxs = []
        for var in variables:
            try:
                idxs += self._extraction_indices[var]
            except KeyError:
                raise ValueError(
                    '{} not an unknown in this problem.'.format(var))
        return idxs

    def extract_values(self, free, *variables):
        """Returns the numerical values of the given unknown variables
        from the free vector."""
        return np.asarray(free)[self._indices_of(variables)]

    def fill_free(self, free, values, *variables):
        """Replaces values in a free-shaped vector for the given
        unknown variables (in place)."""
        free[self._indices_of(variables)] = values

    def time_vector(self, solution=None, start_time=0.0):
        """The array of node times."""
        col = self.collocator
        N = col.num_collocation_nodes
        if col.variable_duration:
            if solution is None:
                raise ValueError('Solution vector must be provided for '
                                 'variable duration.')
            h = float(np.asarray(solution)[-1])
            if h <= 0.0:
                raise ValueError('Time interval must be strictly greater '
                                 'than zero.')
            if start_time >= h * (N - 1):
                raise ValueError('Start time must be less than the final '
                                 'time.')
        else:
            h = col.node_time_interval
        return np.linspace(start_time, start_time + h * (N - 1), num=N)

    def create_linear_initial_guess(self, end_time=1.0):
        """Linear-interpolation initial guess: state trajectories
        interpolate linearly between the values of single-state instance
        constraints; unknown inputs, parameters and the node interval
        take their bounds' midpoints (a one-sided bound its finite end);
        everything else is zero."""
        col = self.collocator
        N = col.num_collocation_nodes
        n = col.num_states
        guess = np.zeros(self.num_free)

        # (node index, value) of instance constraints state(time) - value
        per_state = {s: [] for s in col.state_symbols}
        if col.instance_constraints is not None:
            par_map = col.known_parameter_map
            for con in col.instance_constraints:
                con = sm.sympify(con).subs(par_map)
                funcs = list(con.atoms(sm.Function))
                if len(funcs) != 1:
                    continue  # multi-instance constraints are ignored
                func = funcs[0]
                base = func.__class__(col.time_symbol)
                if base not in col.state_symbols:
                    continue
                val = sm.solve(con, func)
                if not val:
                    continue
                try:
                    value = float(val[0])
                except TypeError:
                    continue
                if col.variable_duration:
                    time_idx = int(sm.sympify(func.args[0]).subs(
                        col.time_interval_symbol, 1))
                else:
                    duration = col.node_time_interval * (N - 1)
                    tv = np.linspace(0.0, duration, num=N)
                    time_idx = int(np.argmin(np.abs(
                        tv - float(func.args[0]))))
                per_state[base].append((time_idx, value))

        for i, state in enumerate(col.state_symbols):
            pts = sorted(per_state[state])
            if not pts:
                continue
            if len(pts) == 1:
                guess[i * N:(i + 1) * N] = pts[0][1]
            else:
                guess[i * N:(i + 1) * N] = np.interp(
                    np.arange(N), [p[0] for p in pts], [p[1] for p in pts])

        def midpoint_of(bound):
            low, upp = (np.asarray(b, dtype=float) for b in bound)
            if np.any(low <= -self.INF):
                return upp
            if np.any(upp >= self.INF):
                return low
            return 0.5 * (low + upp)

        if self._bounds is not None:
            q = col.num_unknown_input_trajectories
            for j, sym in enumerate(col.unknown_input_trajectories):
                if sym in self._bounds:
                    guess[n * N + j * N:n * N + (j + 1) * N] = \
                        midpoint_of(self._bounds[sym])
            for j, sym in enumerate(col.unknown_parameters):
                if sym in self._bounds:
                    guess[(n + q) * N + j] = midpoint_of(self._bounds[sym])

        if col.variable_duration:
            hsym = col.time_interval_symbol
            if self._bounds is not None and hsym in self._bounds:
                guess[-1] = midpoint_of(self._bounds[hsym])
            else:
                guess[-1] = end_time / (N - 1)
        return guess

    # ------------------------------------------------------------------
    # plotting (plotting.py; matplotlib is imported there, at the call)
    # ------------------------------------------------------------------
    def plot_trajectories(self, vector, axes=None, show_bounds=False):
        return plotting.plot_trajectories(self, vector, axes=axes,
                                          show_bounds=show_bounds)

    def plot_constraint_violations(self, vector, axes=None, subplots=False,
                                   show_bounds=False):
        return plotting.plot_constraint_violations(
            self, vector, axes=axes, subplots=subplots,
            show_bounds=show_bounds)

    def plot_objective_value(self):
        return plotting.plot_objective_value(self)

    def plot_jacobian_sparsity(self, axes=None):
        return plotting.plot_jacobian_sparsity(self, axes=axes)

    def objective(self, free):
        """Objective value at ``free``."""
        return float(self._obj_fn(self._as_tensor(free)))

    def gradient(self, free):
        """Objective gradient at ``free``."""
        grad_fn = self._obj_grad_fn or torch.func.grad(self._obj_fn)
        return grad_fn(self._as_tensor(free)).cpu().numpy()

    def constraints(self, free):
        """Constraint values at ``free``."""
        return self.con(free)

    def jacobian(self, free):
        """Sparse-Jacobian values at ``free`` (COO order of
        ``con_jac_rows``/``con_jac_cols``)."""
        return self.con_jac(free)

    def jacobianstructure(self):
        """COO (rows, cols) of the constraint Jacobian."""
        return self.con_jac_rows, self.con_jac_cols


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
