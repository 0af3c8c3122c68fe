from .nlink import n_link_cart_eom, n_link_cart_problem, n_link_initial_guess
from .pendulum import swing_up_problem
from .spring_damper import spring_damper_problem

__all__ = ['swing_up_problem', 'spring_damper_problem', 'n_link_cart_eom',
           'n_link_cart_problem', 'n_link_initial_guess']
