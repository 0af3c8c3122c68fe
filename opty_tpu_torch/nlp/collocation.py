"""Wires a ConstraintCollocator into the interior-point solver.

The counterpart of opty_tpu/nlp/collocation.py for ``kkt_method``
``'scan'``, ``'cr'`` and ``'spike'`` (the node axis split over the slabs
of a mesh, parallel/spike.py).  Builds the ``IPMFunctions`` over a leading
lane axis B: the transcription (one free vector at a time, either
integration method, with the unknown parameters and a variable node
interval as border variables w) is vmapped over the lanes with
``torch.func.vmap``; the KKT assembly, factorization and refined
solve (nlp/kkt.py) take the lane axis directly.  The Lagrangian Hessian
is exact: per-interval EoM blocks from the collocator plus the
objective/instance part from colored Hessian-vector products
(transcribe/hessian.py).

Gradient-based NLP scaling (Ipopt's ``nlp_scaling_method=
gradient-based``, ``scaling_max_gradient`` 100) is computed per lane
from its initial point.

``kkt_prepare_gn`` (the Jacobian-only prep of the restoration's
Gauss-Newton steps), ``kkt_apply_soc`` (the second-order correction's
one-round re-solve) and ``kkt_solve_feasibility`` complete the
``IPMFunctions`` contract; ``take_lanes`` narrows the functions to a
subset of the lanes (a restoration visit runs on the entering lanes
only).

On the card an iteration's derivative passes are many small operations
dispatched from the host (the 9-link chain's Hessian blocks and
curvature product are tens of thousands, most of them through torch's
Python path for the zero tangents of forward-over-reverse).  So there
``kkt_prepare``, ``lagrangian_hvp``, ``eval_point`` and the plain
evaluations of the objective, its gradient and the constraints run as
CUDA graphs (``_graphed``), captured at their first call for each lane
count (kept on the collocator, so later solves of the problem replay
them); the same kernels run, so the values do not change.  The CPU and
calls inside a torch.func transform run eagerly.
"""

import gc

import torch
from torch.func import jvp, vjp, vmap

from ..config import default_factor_dtype, default_kkt_method
from ..parallel.spike import spike_apply, spike_factor
from ..transcribe.hessian import make_structured_scalar_hessian
from .ipm_types import IPMFunctions
from .kkt import (KKTBlocks, _assemble_node_blocks, _equilibrate,
                  check_method, factor_kkt, factor_kkt_cr, kkt_matvec,
                  matvec_assembled_nl, solve_factored, solve_factored_cr_nl)

__all__ = ['make_collocation_nlp_functions', 'compute_scaling']

_MAX_GRADIENT = 100.0


class _graphed:
    """``fn(*tensors)`` (a tensor, a tuple or a dict of tensors out) replayed
    from a CUDA graph captured for each input signature at its first
    call; on the CPU ``fn`` itself.  Inputs are copied into the captured
    buffers and outputs cloned out of them, so a later replay changes
    no result already returned."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}

    def __call__(self, *args):
        if args[0].device.type != 'cuda':
            return self.fn(*args)
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        if key not in self.graphs:
            static = [a.clone() for a in args]
            if not self.graphs:
                # warm-up outside the first capture (lazy initialisation
                # of handles and kernels); later lane counts reuse it
                side = torch.cuda.Stream(args[0].device)
                side.wait_stream(torch.cuda.current_stream(args[0].device))
                with torch.cuda.stream(side):
                    self.fn(*static)
                torch.cuda.current_stream(args[0].device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # no cyclic garbage collection inside the capture: a dead
            # problem's graphs freed there would invalidate it (the
            # capture no longer collects before it begins)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    out = self.fn(*static)
            finally:
                if collecting:
                    gc.enable()
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for buf, a in zip(static, args):
            buf.copy_(a)
        graph.replay()
        if isinstance(out, dict):
            return {k: v.clone() for k, v in out.items()}
        if isinstance(out, tuple):
            return tuple(v.clone() for v in out)
        return out.clone()


def _outside_transforms(eager, graphed):
    """``graphed`` where no torch.func transform is active (the solver's
    plain evaluations), ``eager`` inside one (a vjp through the
    function): a graph's replay is not differentiable."""
    def call(*args):
        if torch._C._are_functorch_transforms_active():
            return eager(*args)
        return graphed(*args)
    return call


def compute_scaling(col, gradient, x0):
    """Ipopt-style gradient-based scaling factors at one point ``x0``.

    Returns (sf, dsc_nodes (N-1, M), dsc_inst (o,), dsc_full (m,)).
    Each constraint row j gets  min(1, gmax / ||grad c_j(x0)||_inf);
    the objective gets  min(1, gmax / ||grad f(x0)||_inf).
    """
    A0, B0, C0, G0 = col.jacobian_blocks(x0)
    row_norm = torch.amax(torch.abs(torch.cat([A0, B0, C0], dim=2)),
                          dim=2)                             # (N-1, M)
    one = torch.ones_like(row_norm)
    dsc_nodes = torch.where(row_norm > 1e-12,
                            torch.minimum(one, _MAX_GRADIENT / row_norm),
                            one)
    o = col.num_instance_constraints
    if o:
        gnorm = torch.amax(torch.abs(G0), dim=1)
        onei = torch.ones_like(gnorm)
        dsc_inst = torch.where(gnorm > 1e-12,
                               torch.minimum(onei, _MAX_GRADIENT / gnorm),
                               onei)
    else:
        dsc_inst = x0.new_zeros((0,))
    g0 = gradient(x0)
    gmax = torch.amax(torch.abs(g0))
    one0 = torch.ones_like(gmax)
    sf = torch.where(gmax > 1e-12, torch.minimum(one0, _MAX_GRADIENT / gmax),
                     one0)
    dsc_full = torch.cat([dsc_nodes.T.reshape(-1), dsc_inst])
    return sf, dsc_nodes, dsc_inst, dsc_full


def make_collocation_nlp_functions(col, objective, gradient=None,
                                   factor_dtype=None, refine_steps=None,
                                   scale_from=None, kkt_method=None,
                                   mesh=None, node_axis='node'):
    """IPMFunctions over B lanes for a collocation problem.

    Parameters
    ----------
    col : ConstraintCollocator
    objective : callable free -> scalar (one free vector)
    gradient : optional callable free -> (nfree,); default
        ``torch.func.grad(objective)``.
    scale_from : optional (B, nfree) initial points for gradient-based
        scaling, one per lane.  When given, the returned functions
        define the *scaled* NLP; the second return value carries
        (sf (B,), dsc_full (B, m)) for unscaling results.
    kkt_method : 'scan' (sequential block elimination, the CPU default),
        'cr' (parallel cyclic reduction, the card's default) or 'spike'
        (the factorization split over the node slabs of ``mesh``,
        parallel/spike.py); 'spike' requires ``mesh``.
    mesh : parallel.mesh.NodeMesh with a ``node_axis`` axis ('spike'
        only).
    """
    n = col.num_states
    q = col.num_unknown_input_trajectories
    nz = col._nz
    bw = col._bw
    M = col.num_eom
    N = col.num_collocation_nodes
    o = col.num_instance_constraints
    ni = N - 1
    be = col.integration_method == 'backward euler'
    dtype = col._dtype
    device = col._device
    if kkt_method is None:
        kkt_method = default_kkt_method(device)
    check_method(kkt_method)
    if factor_dtype is None:
        factor_dtype = default_factor_dtype(device)
    if kkt_method == 'spike' and mesh is None:
        raise ValueError("kkt_method='spike' requires a mesh with a '%s' "
                         'axis' % node_axis)
    if refine_steps is None:
        # a mixed-precision factorization needs more refinement rounds
        # (the JAX package measured 6 to recover float64-factorization
        # iteration counts on the pendulum, nlp/collocation.py there)
        refine_steps = 1 if factor_dtype == dtype else 6

    struct_hess = make_structured_scalar_hessian(N, n, q, bw, dtype)
    grad_fn = gradient if gradient is not None else \
        torch.func.grad(objective)

    if scale_from is not None:
        sf, dsc_nodes, dsc_inst, dsc_full = vmap(
            lambda x0: compute_scaling(col, grad_fn, x0))(scale_from)
    else:
        sf = torch.ones((1,), dtype=dtype, device=device)
        dsc_nodes = torch.ones((1, ni, M), dtype=dtype, device=device)
        dsc_inst = torch.ones((1, o), dtype=dtype, device=device)
        dsc_full = torch.ones((1, col.num_constraints), dtype=dtype,
                              device=device)

    def lanes(t, B):
        """A per-lane scale for B lanes (broadcasts an unscaled one)."""
        return t.expand((B,) + tuple(t.shape[1:]))

    def split_free(vec):
        """(B, nfree) -> (node part (B, N, nz), border part (B, bw))."""
        X = vec[..., :n * N].reshape(vec.shape[:-1] + (n, N))
        U = vec[..., n * N:nz * N].reshape(vec.shape[:-1] + (q, N))
        nodes = torch.cat([X.transpose(-1, -2), U.transpose(-1, -2)],
                          dim=-1)
        return nodes, vec[..., nz * N:]

    def join_free(nodes, border):
        lead = nodes.shape[:-2]
        parts = [nodes[..., :n].transpose(-1, -2).reshape(lead + (-1,))]
        if q:
            parts.append(nodes[..., n:].transpose(-1, -2)
                         .reshape(lead + (-1,)))
        parts.append(border)
        return torch.cat(parts, dim=-1)

    def split_con(vec):
        """(B, m) -> ((B, ni, M) eom part, (B, o) instance part)."""
        eom = vec[..., :M * ni].reshape(vec.shape[:-1] + (M, ni))
        return eom.transpose(-1, -2), vec[..., M * ni:]

    def join_con(eom_nodes, inst):
        lead = eom_nodes.shape[:-2]
        return torch.cat([eom_nodes.transpose(-1, -2).reshape(lead + (-1,)),
                          inst], dim=-1)

    def split_instance_jac(G):
        if o:
            GX = G[:, :n * N].reshape(o, n, N)
            GU = G[:, n * N:nz * N].reshape(o, q, N)
            Gz = torch.cat([GX.transpose(1, 2), GU.transpose(1, 2)], dim=2)
            Gw = G[:, nz * N:]
        else:
            Gz = G.new_zeros((0, N, nz))
            Gw = G.new_zeros((0, bw))
        return Gz, Gw

    def jacobian_one(x, dn, di):
        """The scaled Jacobian as KKT blocks for one lane, shared by
        kkt_prepare and kkt_prepare_gn."""
        A, B, C, G = col.jacobian_blocks(x)
        A = A * dn[:, :, None]
        B = B * dn[:, :, None]
        C = C * dn[:, :, None]
        if o:
            G = G * di[:, None]
        # constraint block k couples z_{k-1}, z_k (k = 1..N-1): backward
        # Euler interval i: cur = i+1 (= k), adj = i (= k-1); midpoint
        # interval i: cur = i (= k-1), adj = i+1 (= k)
        if not be:
            A, B = B, A
        zM = A.new_zeros((1, M, nz))
        Gz, Gw = split_instance_jac(G)
        return dict(P=torch.cat([zM, A], dim=0), Q=torch.cat([zM, B], dim=0),
                    Cn=torch.cat([A.new_zeros((1, M, bw)), C], dim=0),
                    Gz=Gz, Gw=Gw)

    def prepare_one(x, y, sf1, dn, di):
        """kkt_prepare for one lane (vmapped over the lanes)."""
        y_nodes, y_inst = split_con(y)
        prep = jacobian_one(x, dn, di)

        # Lagrangian Hessian of the scaled constraints: row-scaled
        # multipliers into the exact per-node Hessian
        Hd, Ho, Hw, Hww = col.hessian_blocks(x, y_nodes * dn)

        def phi(f):
            val = sf1 * objective(f)
            if o:
                val = val + torch.dot(y_inst * di,
                                      col.eval_instance_constraints(f))
            return val

        Hd2, Ho2, Hw2, Hww2 = struct_hess(phi, x)
        prep.update(Hd=Hd + Hd2, Ho=Ho + Ho2, Hw=Hw + Hw2, Hww=Hww + Hww2)
        return prep

    def prepare_gn_one(x, dn, di):
        """kkt_prepare_gn for one lane: the Jacobian blocks with zero
        Hessian blocks (the restoration's Gauss-Newton iteration never
        uses the Lagrangian Hessian)."""
        prep = jacobian_one(x, dn, di)
        z_nn = x.new_zeros((N, nz, nz))
        prep.update(Hd=z_nn, Ho=z_nn, Hw=x.new_zeros((N, nz, bw)),
                    Hww=x.new_zeros((bw, bw)))
        return prep

    def _blocks_with(Hd, Ho, Hw, Hww, prep, ds):
        ds_nodes, ds_inst = split_con(ds)
        Ds = torch.cat([torch.ones_like(ds_nodes[:, :1]), ds_nodes], dim=1)
        return KKTBlocks(Hd=Hd, Ho=Ho, Hw=Hw, Hww=Hww, P=prep['P'],
                         Q=prep['Q'], C=prep['Cn'], Ds=Ds,
                         Gz=prep['Gz'], Gw=prep['Gw'], Di=ds_inst)

    def _split_rhs(rx, rc):
        rz, rw = split_free(rx)
        rc_nodes, rc_inst = split_con(rc)
        ry = torch.cat([torch.zeros_like(rc_nodes[:, :1]), rc_nodes], dim=1)
        return (torch.cat([rz, ry], dim=-1),
                torch.cat([rw, rc_inst], dim=-1))

    def _join_sol(u, beta):
        return (join_free(u[..., :nz], beta[..., :bw]),
                join_con(u[:, 1:, nz:], beta[..., bw:]))

    def _factor_spike(blocks):
        """The SPIKE factorization over the mesh's node slabs, with the
        JAX package's equilibration (in the working precision) and then
        the cast to ``factor_dtype``."""
        D, E, F, Kbb, sn, sb = _equilibrate(*_assemble_node_blocks(blocks))
        D, E, F, Kbb = (a.to(factor_dtype) for a in (D, E, F, Kbb))
        return spike_factor(D, E, F, Kbb, mesh, node_axis), sn, sb

    def _spike_solve_one(facsc, rn, rb):
        fac, sn, sb = facsc
        fd = fac.S_inv.dtype
        u, beta = spike_apply(fac, (rn * sn).to(fd), (rb * sb).to(fd), mesh,
                              node_axis)
        return u * sn, beta * sb

    def kkt_factor(prep, sigma_x, ds, gn_mask=None):
        """Factor the KKT matrix once for a given regularization; the
        (blocks, factorization) pair serves ``kkt_apply`` for any rhs.

        ``gn_mask`` (bool, or per-lane (B,) bool) zeroes the Lagrangian
        Hessian blocks, turning the matrix into the damped Gauss-Newton
        system [[sigma, J^T], [J, -ds]] (the least-squares multiplier
        initialization and the restoration's inner steps use it)."""
        sz, sw = split_free(sigma_x)
        Hd, Ho, Hw, Hww = (prep['Hd'], prep['Ho'], prep['Hw'],
                           prep['Hww'])
        if gn_mask is not None:
            gm = torch.as_tensor(gn_mask, device=Hd.device)

            def drop(H):
                return torch.where(
                    gm.reshape(gm.shape + (1,) * (H.ndim - gm.ndim)),
                    0.0, H)
            Hd, Ho, Hw, Hww = drop(Hd), drop(Ho), drop(Hw), drop(Hww)
        Hd = Hd + torch.diag_embed(sz)
        Hww = Hww + torch.diag_embed(sw)
        blocks = _blocks_with(Hd, Ho, Hw, Hww, prep, ds)
        if kkt_method == 'spike':
            return blocks, _factor_spike(blocks)
        factor = factor_kkt_cr if kkt_method == 'cr' else factor_kkt
        return blocks, factor(blocks, factor_dtype=factor_dtype)

    def _resid(Ku, Kb, r_nodes, r_border):
        num = torch.sqrt(torch.sum((Ku - r_nodes) ** 2, dim=(-2, -1))
                         + torch.sum((Kb - r_border) ** 2, dim=-1))
        den = torch.sqrt(torch.sum(r_nodes ** 2, dim=(-2, -1))
                         + torch.sum(r_border ** 2, dim=-1))
        return num / torch.clamp(den, min=1e-300)

    def _apply_with_refinement(blocks_fac, r_nodes, r_border, n_refine,
                               with_resid=True):
        """Solve, refine ``n_refine`` rounds against the float64
        operator and (``with_resid``) measure the relative KKT residual.
        The residual is shared with the last refinement round when there
        are >= 2 rounds (after a single round it would be the raw factor
        residual); otherwise it takes a dedicated operator pass."""
        blocks, fac = blocks_fac
        if kkt_method == 'cr':
            # node-last end to end; transposed back only at _join_sol
            r_nodes = r_nodes.transpose(-1, -2)
            solve = lambda rn, rb: solve_factored_cr_nl(fac, rn, rb)
            apply = lambda u, beta: matvec_assembled_nl(fac, u, beta)
        elif kkt_method == 'spike':
            solve = lambda rn, rb: _spike_solve_one(fac, rn, rb)
            apply = lambda u, beta: kkt_matvec(blocks, u, beta)
        else:
            solve = lambda rn, rb: solve_factored(fac, rn, rb)
            apply = lambda u, beta: kkt_matvec(blocks, u, beta)
        u, beta = solve(r_nodes, r_border)
        u = u.to(dtype)
        beta = beta.to(dtype)
        resid = None
        for i in range(n_refine):
            Ku, Kb = apply(u, beta)
            if with_resid and n_refine >= 2 and i == n_refine - 1:
                resid = _resid(Ku, Kb, r_nodes, r_border)
            du, dbeta = solve(r_nodes - Ku, r_border - Kb)
            u = u + du.to(dtype)
            beta = beta + dbeta.to(dtype)
        if with_resid and resid is None:
            Ku, Kb = apply(u, beta)
            resid = _resid(Ku, Kb, r_nodes, r_border)
        if kkt_method == 'cr':
            u = u.transpose(-1, -2)
        dx, dy = _join_sol(u, beta)
        return (dx, dy, resid) if with_resid else (dx, dy)

    def kkt_apply(blocks_fac, rx, rc):
        """Solve a factored system; returns (dx, dy, rel_resid (B,))."""
        r_nodes, r_border = _split_rhs(rx, rc)
        return _apply_with_refinement(blocks_fac, r_nodes, r_border,
                                      refine_steps)

    def kkt_apply_soc(blocks_fac, rx, rc):
        """Light re-solve for the second-order correction: one
        refinement round and no residual (the filter judges the SOC
        step on actual constraint evaluations)."""
        r_nodes, r_border = _split_rhs(rx, rc)
        return _apply_with_refinement(blocks_fac, r_nodes, r_border,
                                      min(refine_steps, 1),
                                      with_resid=False)

    def kkt_solve(prep, sigma_x, ds, rx, rc):
        return kkt_apply(kkt_factor(prep, sigma_x, ds), rx, rc)

    def kkt_solve_feasibility(prep, sigma_x, rc):
        """Damped Gauss-Newton feasibility step: the Hessian replaced by
        the diagonal ``sigma_x``, the Jacobian blocks reused from
        ``prep``, a unit slack diagonal on every row and a zero primal
        rhs ((J^T J + lam) dx = -J^T r in augmented form), one
        refinement round.  Returns (dx, dy)."""
        fac = kkt_factor(prep, sigma_x, torch.ones_like(rc), True)
        return kkt_apply_soc(fac, torch.zeros_like(sigma_x), rc)

    def prepare_lanes(x, y, sfB, dn, di):
        """kkt_prepare at (x, y), (B, ·) each, with the lanes' scales."""
        return vmap(prepare_one)(x, y, sfB, dn, di)

    def objective_lanes(free, sfB):
        return sfB * vmap(objective)(free)

    def gradient_lanes(free, sfB):
        return sfB[:, None] * vmap(grad_fn)(free)

    def constraints_lanes(free, dn, di):
        res, inst = vmap(col.constraints_nodewise)(free)
        return join_con(res * dn, inst * di)

    def point_lanes(x, y, sfB, dn, di):
        """(gradient, constraints, J^T y) at x: the solver's evaluation
        of a new iterate."""
        c, vjp_fn = vjp(lambda f: constraints_lanes(f, dn, di), x)
        return gradient_lanes(x, sfB), c, vjp_fn(y)[0]

    def hvp_lanes(x, y, dx, sfB, dn, di):
        """The curvature test's product: the jvp of the Lagrangian
        gradient, as steps.regularized_direction forms it."""
        def lag_grad(xx):
            _, vjp_fn = vjp(lambda f: constraints_lanes(f, dn, di), xx)
            return gradient_lanes(xx, sfB) + vjp_fn(y)[0]
        return jvp(lag_grad, (x,), (dx,))[1]

    # one capture per problem, objective and lane count: the graphs take
    # the lanes' scales as inputs, so every build reuses them
    cache = col.__dict__.setdefault('_graphs', {})
    key = (id(objective), id(gradient))
    if key not in cache:
        cache[key] = [_graphed(f) for f in (
            prepare_lanes, hvp_lanes, point_lanes, objective_lanes,
            gradient_lanes, constraints_lanes)]
    prepare_lanes, hvp_lanes, point_lanes, g_obj, g_grad, g_con = cache[key]
    objective_call = _outside_transforms(objective_lanes, g_obj)
    gradient_call = _outside_transforms(gradient_lanes, g_grad)
    constraints_call = _outside_transforms(constraints_lanes, g_con)

    def build(sf, dsc_nodes, dsc_inst):
        """The IPMFunctions whose per-lane data are these scales."""
        def objective_s(free):
            return objective_call(free, lanes(sf, free.shape[0]))

        def gradient_s(free):
            return gradient_call(free, lanes(sf, free.shape[0]))

        def constraints_s(free):
            B = free.shape[0]
            return constraints_call(free, lanes(dsc_nodes, B),
                                    lanes(dsc_inst, B))

        def eval_point(x, y):
            B = x.shape[0]
            return point_lanes(x, y, lanes(sf, B), lanes(dsc_nodes, B),
                               lanes(dsc_inst, B))

        def kkt_prepare(x, y):
            """Per-iteration block construction at (x, y), (B, ·) each:
            scaled Jacobian blocks plus the exact Lagrangian Hessian
            blocks.  Shared by the direction trials, the corrector and
            the SOC re-solve."""
            B = x.shape[0]
            return prepare_lanes(x, y, lanes(sf, B), lanes(dsc_nodes, B),
                                 lanes(dsc_inst, B))

        def kkt_prepare_gn(x):
            """Jacobian-only prep for the restoration's inner solver."""
            B = x.shape[0]
            return vmap(prepare_gn_one)(x, lanes(dsc_nodes, B),
                                        lanes(dsc_inst, B))

        def lagrangian_hvp(x, y, dx):
            B = x.shape[0]
            return hvp_lanes(x, y, dx, lanes(sf, B), lanes(dsc_nodes, B),
                             lanes(dsc_inst, B))

        def take_lanes(idx):
            pick = lambda t: t if t.shape[0] == 1 else t[idx]
            return build(pick(sf), pick(dsc_nodes), pick(dsc_inst))

        return IPMFunctions(
            objective=objective_s, gradient=gradient_s,
            constraints=constraints_s, kkt_prepare=kkt_prepare,
            kkt_factor=kkt_factor, kkt_apply=kkt_apply,
            kkt_apply_soc=kkt_apply_soc, kkt_solve=kkt_solve,
            kkt_solve_feasibility=kkt_solve_feasibility,
            kkt_prepare_gn=kkt_prepare_gn, take_lanes=take_lanes,
            lagrangian_hvp=lagrangian_hvp, eval_point=eval_point)

    return build(sf, dsc_nodes, dsc_inst), (sf, dsc_full)
