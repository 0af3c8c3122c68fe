"""The JAX package's gallery, ported: 25 problems of the reference
opty gallery, each a module with ``build_problem`` (the original's
keyword arguments plus ``device``, the card when None), the
original's ``main`` / ``check`` / ``run_phases``, the documented cold
start ``initial_guess(prob)`` and its iteration budget
``COLD_MAX_ITER``.  Run one with
``python -m opty_tpu_torch.examples.gallery.<name>`` (on the card).

``NAMES`` lists the problems; ``COLD_SET`` the ones whose cold solve
(``initial_guess``, ``use_soc=False``, ``COLD_MAX_ITER``, kkt_method='cr'
with a float64 factorization) converges within 100 iterations in the
JAX package's run on the CPU (scripts/reference_gallery.py; betts2003
ends at status -1 and crane_load takes 113 there)."""

NAMES = (
    'ball_on_disc', 'betts2003', 'betts_10_103_104', 'betts_10_47',
    'betts_10_50', 'betts_10_7', 'car_around_pylons', 'car_in_garage',
    'car_on_racecourse', 'countersteer', 'crane_load',
    'double_pendulum_cart', 'drone', 'friction_slack', 'hilly_race',
    'light_diffraction', 'non_contiguous_id', 'one_legged_time_trial',
    'parallel_park', 'park2004', 'particle_in_tube', 'path_constraints',
    'quarter_car', 'sliding_block', 'steamboat',
)

COLD_SET = (
    'non_contiguous_id', 'park2004', 'betts_10_50', 'path_constraints',
    'betts_10_103_104', 'betts_10_7', 'particle_in_tube', 'countersteer',
    'sliding_block',
)


def build(name, device=None, **kwargs):
    """(problem, documented cold start) of gallery problem ``name`` at
    its defaults (``kwargs`` go to ``build_problem``): ``build_problem`` and
    ``initial_guess``; for betts_10_47, whose ``build_problem`` needs
    the reference's CSV, its first phase (``build_phase1``)."""
    import importlib
    mod = importlib.import_module(__name__ + '.' + name)
    if name == 'betts_10_47':
        prob = mod.build_phase1(device=device)
    else:
        out = mod.build_problem(device=device, **kwargs)
        prob = out[0] if isinstance(out, tuple) else out
    return prob, mod.initial_guess(prob)
