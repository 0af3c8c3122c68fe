"""Diagnostic plots, the counterpart of opty_tpu/plotting.py: the same
figures from the same problem.

matplotlib is optional: it is imported inside each function, so the
package imports where it is absent (the machine with the card).
"""

import numpy as np

__all__ = ['plot_trajectories', 'plot_constraint_violations',
           'plot_objective_value', 'plot_jacobian_sparsity']


def _require_plt():
    try:
        import matplotlib.pyplot as plt
    except ImportError as err:
        raise ImportError('matplotlib must be installed for plotting.') \
            from err
    return plt


def plot_trajectories(prob, vector, axes=None, show_bounds=False):
    """Plot state and unknown-input trajectories from a free vector."""
    plt = _require_plt()
    col = prob.collocator
    parsed = prob.parse_free(vector)
    states = parsed[0]
    specifieds = parsed[1]
    time = prob.time_vector(solution=vector)

    n = col.num_states
    q = col.num_unknown_input_trajectories
    num = n + q
    if axes is None:
        fig, axes = plt.subplots(num, 1, sharex=True,
                                 figsize=(6.4, 0.8 * num),
                                 layout='compressed')
    axes = np.atleast_1d(axes)

    syms = list(col.state_symbols) + list(col.unknown_input_trajectories)
    trajs = [states[i] for i in range(n)]
    if q == 1:
        trajs.append(np.atleast_2d(specifieds)[0])
    elif q > 1:
        trajs += [specifieds[i] for i in range(q)]

    bounds = prob.bounds or {}
    for ax, sym, traj in zip(axes, syms, trajs):
        ax.plot(time, traj)
        ax.set_ylabel(str(sym))
        if show_bounds and sym in bounds:
            low, upp = bounds[sym]
            for b in (low, upp):
                b = np.broadcast_to(np.asarray(b, dtype=float), time.shape)
                ax.plot(time, b, color='C1', linestyle='--')
    axes[-1].set_xlabel('Time')
    return axes


def _instance_bars_layout(o):
    """Split the instance-constraint bars into plots of 6..10 bars so
    every plot holds about the same number; returns (bars_per_plot,
    num_plots)."""
    if o == 0:
        return 0, 0
    bars_per_plot = None
    for i in range(6, 11):
        if o % i == 0:
            bars_per_plot = i
    if bars_per_plot is None:
        # pick the count whose last plot is least empty
        best = min(range(6, 11), key=lambda i: (i - o % i) % i)
        bars_per_plot = best
    num_plots = max(1, int(np.ceil(o / bars_per_plot)))
    return bars_per_plot, num_plots


def plot_constraint_violations(prob, vector, axes=None, subplots=False,
                               show_bounds=False):
    """Plot EoM constraint violations versus node number and instance
    constraints as bar charts.

    ``subplots=True`` gives one plot per equation of motion; with
    ``show_bounds=True`` bounded equations plot their *values* with
    the eom_bounds overlaid as dashed lines, otherwise the violation
    (distance outside [lower, upper], zero inside) is plotted.
    Instance constraints are split over bar charts of 6-10 bars each.
    """
    plt = _require_plt()
    col = prob.collocator
    con_values = np.asarray(prob.con(np.asarray(vector)))
    M = col.num_eom
    N = col.num_collocation_nodes
    o = col.num_instance_constraints
    ni = N - 1

    cl = prob._low_con_bounds[:M * ni]
    cu = prob._upp_con_bounds[:M * ni]
    eomv = con_values[:M * ni]
    viol = np.where(eomv < cl, eomv - cl,
                    np.where(eomv > cu, eomv - cu, 0.0))
    eom_bounds = prob.eom_bounds or {}

    bars_per_plot, num_bar_plots = _instance_bars_layout(o)
    num_eom_plots = M if (subplots and M > 1) else 1
    figsize = 1.25 if (subplots and M > 1) else 1.75
    if axes is None:
        fig, axes = plt.subplots(
            num_eom_plots + num_bar_plots, 1,
            figsize=(6.4, figsize * (num_eom_plots + num_bar_plots)),
            layout='constrained')
    axes = np.asarray(axes).ravel()
    needed = num_eom_plots + num_bar_plots
    if len(axes) < needed:
        raise ValueError('{} axes are needed, {} were given.'.format(
            needed, len(axes)))

    con_nodes = np.arange(1, N)
    if num_eom_plots == 1:
        if not eom_bounds:
            for j in range(M):
                axes[0].plot(con_nodes, eomv[j * ni:(j + 1) * ni])
            axes[0].set_title('Constraint violations')
        elif M == 1 and show_bounds:
            axes[0].plot(con_nodes, eomv[:ni])
            axes[0].set_title('Value of Bounded EoM')
            axes[0].axhline(eom_bounds[0][0], color='C1', lw=1.0,
                            linestyle='--')
            axes[0].axhline(eom_bounds[0][1], color='C1', lw=1.0,
                            linestyle='--')
        else:
            for j in range(M):
                axes[0].plot(con_nodes, viol[j * ni:(j + 1) * ni])
            axes[0].set_title('Constraint violations')
        axes[0].set_xlabel('Node Number')
        axes[0].set_ylabel('EoM violation')
    else:
        for j in range(M):
            ax = axes[j]
            if j in eom_bounds and show_bounds:
                ax.plot(con_nodes, eomv[j * ni:(j + 1) * ni])
                ax.axhline(eom_bounds[j][0], color='C1', lw=1.0,
                           linestyle='--')
                ax.axhline(eom_bounds[j][1], color='C1', lw=1.0,
                           linestyle='--')
                ax.set_ylabel('EoM {} value'.format(j),
                              fontsize='small')
            else:
                ax.plot(con_nodes, viol[j * ni:(j + 1) * ni])
                ax.set_ylabel('EoM {} violation'.format(j),
                              fontsize='small')
        axes[num_eom_plots - 1].set_xlabel('Node Number')
        axes[0].set_title('Constraint violations')

    if o:
        inst = con_values[M * ni:]
        labels = [str(c) for c in col.instance_constraints]
        for b in range(num_bar_plots):
            ax = axes[num_eom_plots + b]
            lo, hi = b * bars_per_plot, min((b + 1) * bars_per_plot, o)
            idx = np.arange(lo, hi)
            ax.bar(idx, inst[lo:hi])
            ax.set_ylabel('Instance', fontsize='small')
            ax.set_xticks(idx)
            ax.set_xticklabels(labels[lo:hi], rotation=-45,
                               fontsize='x-small', ha='left')
    return axes


def plot_objective_value(prob):
    """Objective value per solver iteration."""
    plt = _require_plt()
    fig, ax = plt.subplots(1, layout='compressed')
    ax.set_title('Objective Value')
    ax.set_xlabel('Iteration Number')
    ax.set_ylabel('Objective value')
    ax.plot(prob.obj_value)
    return ax


def plot_jacobian_sparsity(prob, axes=None):
    """Spy plot of the COO constraint Jacobian."""
    plt = _require_plt()
    from scipy.sparse import coo_matrix
    rows, cols = prob.jacobianstructure()
    vals = np.ones_like(rows, dtype=float)
    jac = coo_matrix((vals, (rows, cols)),
                     shape=(prob.num_constraints, prob.num_free))
    if axes is None:
        fig, axes = plt.subplots(1, 1, layout='constrained')
    axes.spy(jac)
    return axes
