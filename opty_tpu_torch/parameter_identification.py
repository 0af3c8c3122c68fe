"""Parameter-identification helpers, the counterpart of
opty_tpu/parameter_identification.py: a least-squares tracking objective
between measured and model outputs, the measurements resampled onto the
collocation grid, and its gradient.

``objective_function`` and ``objective_function_gradient`` take and
return numpy arrays, as there; ``make_tracking_objective`` returns torch
functions of the free vector, ready for ``Problem`` (its gradient by
``torch.func.grad``), which compose with ``torch.func.vmap`` over
batches of free vectors.
"""

import numpy as np
import torch

from .config import default_dtype, resolve_device

__all__ = ['output_equations', 'objective_function',
           'objective_function_gradient', 'wrap_objective',
           'make_tracking_objective']


def output_equations(x):
    """Returns the outputs of the system: the generalized coordinates,
    assumed to be the first half of the state vector (x: (N, n))."""
    return x[:, :x.shape[1] // 2]


def _resample(time_measured, y_measured, model_time):
    """Linear interpolation of measurements (M, o) onto the model grid.

    The model grid must lie inside the measured time range: np.interp
    would hold the edge values outside it, so it raises there."""
    time_measured = np.asarray(time_measured)
    model_time = np.asarray(model_time)
    if (model_time[0] < time_measured[0]
            or model_time[-1] > time_measured[-1]):
        raise ValueError(
            'Model time grid [{}, {}] extends outside the measured time '
            'range [{}, {}].'.format(model_time[0], model_time[-1],
                                     time_measured[0], time_measured[-1]))
    y_measured = np.asarray(y_measured)
    cols = [np.interp(model_time, time_measured,
                      y_measured[:, i]) for i in range(y_measured.shape[1])]
    return np.stack(cols, axis=1)


def _outputs_and_data(free, N, n, dis_period, time_measured, y_measured):
    model_time = np.linspace(0.0, (N - 1) * dis_period, num=N)
    states = np.asarray(free)[:n * N].reshape((n, N))
    return (np.asarray(output_equations(states.T)),
            _resample(time_measured, y_measured, model_time))


def objective_function(free, num_dis_points, num_states, dis_period,
                       time_measured, y_measured):
    """dis_period times the squared norm of the difference between the
    measured outputs, resampled onto the grid, and the model's."""
    outputs, resampled = _outputs_and_data(
        free, num_dis_points, num_states, dis_period, time_measured,
        y_measured)
    return dis_period * float(
        np.sum((resampled.flatten() - outputs.flatten()) ** 2))


def objective_function_gradient(free, num_dis_points, num_states,
                                dis_period, time_measured, y_measured):
    """The gradient of :func:`objective_function` in closed form (the
    outputs are the first coordinates of the free vector)."""
    N = num_dis_points
    outputs, resampled = _outputs_and_data(
        free, N, num_states, dis_period, time_measured, y_measured)
    grad = np.zeros_like(np.asarray(free))
    grad[:N * resampled.shape[1]] = 2.0 * dis_period * (
        outputs - resampled).T.flatten()
    return grad


def wrap_objective(obj_func, *args):
    """``obj_func`` as a function of the free vector alone."""
    def wrapped_func(free):
        return obj_func(free, *args)
    return wrapped_func


def make_tracking_objective(num_dis_points, num_states, dis_period,
                            time_measured, y_measured, dtype=None,
                            device=None):
    """``(obj, obj_grad)``: :func:`objective_function` as a torch
    function of the free vector and its gradient, ``torch.func.grad``
    of it.  The measurements are resampled once, here, onto ``device``
    (the card when None, see config.resolve_device)."""
    dtype = dtype or default_dtype()
    N, n = num_dis_points, num_states
    model_time = np.linspace(0.0, (N - 1) * dis_period, num=N)
    resampled = torch.as_tensor(
        _resample(time_measured, y_measured, model_time), dtype=dtype,
        device=resolve_device(device))
    o = resampled.shape[1]

    def obj(free):
        outputs = free[:n * N].reshape((n, N))[:o].T
        return dis_period * torch.sum((outputs - resampled) ** 2)

    return obj, torch.func.grad(obj)
