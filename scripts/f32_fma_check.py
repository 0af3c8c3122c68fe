#!/usr/bin/env python3
"""Why a float32-factor step of the port can part from the JAX
package's on the CPU where both compute the same thing: XLA's CPU code
generator contracts every ``a * b + c`` of a jitted program into one
fused multiply-add (one rounding), while the port's float32 arithmetic
(torch's CPU operations, and the card kernels written to match them)
rounds the product and the sum apart, as the JAX package itself does
when it runs op by op.  Runs on the CPU, after
scripts/reference_f32_states.py has written a problem's states:

    JAX_PLATFORMS=cpu python3 scripts/f32_fma_check.py \
        build/betts_p2_f32.npz betts_10_47 --phase 2 89

1. The contraction: ``a * b + c`` on 100,000 float32 triples, jitted
   and op by op, against the fused result (computed in float64 and
   rounded once) and against the separately rounded one.
2. At each JAX state k given: the port takes its float32 step from the
   state (scripts/f32_crossover.py's crossing) and records two systems:
   the direction's last solve and, where the step has one, its
   second-order correction (the factorization the direction used and
   the correction's right-hand side).  Each is then solved with a
   float32 factor and 0 or 6 float64 refinement rounds (the direction
   takes 6) or 0 or 1 (the correction takes 1) by the port, by the JAX
   package op by op and by the JAX package jitted, each against the JAX
   package's float64 solve.  Beside them the port's step lengths with
   float32 and with float64 factors.

Prints one JSON object and writes it to ``--out``.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'scripts'))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def contraction():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(100000).astype(np.float32)
               for _ in range(3))
    f = lambda a, b, c: a * b + c
    jit = np.asarray(jax.jit(f)(a, b, c))
    eager = np.asarray(f(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    apart = a * b + c
    return dict(jit_equals_fused=float(np.mean(jit == fused)),
                jit_equals_apart=float(np.mean(jit == apart)),
                op_by_op_equals_apart=float(np.mean(eager == apart)))


def soc_system(prob, ref, k, options):
    """The port's float32 step from JAX state k with the systems of its
    second-order correction (None without one) and of its last direction
    solve recorded, each as (kkt_factor's arguments, rx, rc), and the
    step lengths with float32 and float64 factors."""
    import torch
    from opty_tpu_torch import interop, problem as problem_mod
    from opty_tpu_torch.nlp.ipm_types import IPMState
    real = problem_mod.make_collocation_nlp_functions
    seen = {}

    def recording(*args, **kwargs):
        fns, scale = real(*args, **kwargs)

        def kkt_factor(*a):
            seen['factor'] = a
            return fns.kkt_factor(*a)

        def kkt_apply(fac, rx, rc):
            seen['apply'] = (seen['factor'], rx, rc)
            return fns.kkt_apply(fac, rx, rc)

        def kkt_apply_soc(fac, rx, rc):
            seen['soc'] = (seen['factor'], rx, rc)
            return fns.kkt_apply_soc(fac, rx, rc)
        return fns._replace(kkt_factor=kkt_factor, kkt_apply=kkt_apply,
                            kkt_apply_soc=kkt_apply_soc), scale

    problem_mod.make_collocation_nlp_functions = recording
    try:
        prob.set_solver_options(factor_dtype=torch.float32, **options)
        resume = prob._build_solver()[2]
        state = interop.state_from_numpy(
            {f: ref['s%d_%s' % (k, f)] for f in IPMState._fields}, 'cpu')
        free = torch.as_tensor(ref['free'])[None]
        _, nxt32 = resume(free, state)
        prob.set_solver_options(factor_dtype=torch.float64)
        _, nxt64 = resume(free, state)
    finally:
        problem_mod.make_collocation_nlp_functions = real
    return seen.get('soc'), seen['apply'], float(nxt32.alpha_last[0]), \
        float(nxt64.alpha_last[0])


def solve_errors(prob, jprob, free, x, y, system, rounds, soc):
    """The recorded system solved with a float32 factor and each of
    ``rounds`` refinement rounds by the port, the JAX package op by op
    and jitted, against the JAX package's float64 solve (relative
    errors), and the port's against the JAX package's op by op."""
    import jax
    import jax.numpy as jnp
    import torch
    from opty_tpu.nlp.collocation import \
        make_collocation_nlp_functions as jax_functions
    from opty_tpu_torch.nlp.collocation import \
        make_collocation_nlp_functions as torch_functions
    (prep, sigma, ds, gn), rx, rc = system
    np_ = lambda t: t[0].detach().numpy()
    pick = lambda out: out[:2]
    sols = {}
    for n in rounds:
        tf = torch_functions(
            prob.collocator, prob._obj_fn, prob._obj_grad_fn,
            scale_from=torch.as_tensor(free)[None],
            factor_dtype=torch.float32, kkt_method='cr', refine_steps=n)[0]
        apply = tf.kkt_apply_soc if soc else tf.kkt_apply
        dx, dy = pick(apply(tf.kkt_factor(prep, sigma, ds, gn), rx, rc))
        sols['port', n] = np.concatenate([np_(dx), np_(dy)])
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(np_(sigma)),
            jnp.asarray(np_(ds)), jnp.asarray(np_(rx)), jnp.asarray(np_(rc)))
    for fdt, ns in ((jnp.float64, (max(rounds),)), (jnp.float32, rounds)):
        for n in ns:
            jf = jax_functions(
                jprob.collocator, jprob._obj_fn, jprob._obj_grad_fn,
                scale_from=jnp.asarray(free), factor_dtype=fdt,
                kkt_method='cr', refine_steps=n)[0]

            def solve(x, y, sigma, ds, rx, rc, jf=jf):
                fac = jf.kkt_factor(jf.kkt_prepare(x, y), sigma, ds,
                                    None if gn is None else bool(gn))
                apply = jf.kkt_apply_soc if soc else jf.kkt_apply
                return jnp.concatenate(pick(apply(fac, rx, rc)))
            tag = 'float64' if fdt == jnp.float64 else 'float32'
            sols['op by op', tag, n] = np.asarray(solve(*args))
            sols['jitted', tag, n] = np.asarray(jax.jit(solve)(*args))
    exact = sols['jitted', 'float64', max(rounds)]
    return {'rounds_%d' % n: dict(
        port=rel(sols['port', n], exact),
        jax_op_by_op=rel(sols['op by op', 'float32', n], exact),
        jax_jitted=rel(sols['jitted', 'float32', n], exact),
        port_vs_jax_op_by_op=rel(sols['port', n],
                                 sols['op by op', 'float32', n]))
        for n in rounds}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('states')
    parser.add_argument('name')
    parser.add_argument('ks', nargs='+', type=int)
    parser.add_argument('--phase', type=int, default=None)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    import jax.numpy as jnp
    import opty_tpu  # noqa: F401  (enables x64)
    import f32_crossover as fc
    import reference_f32_states as rfs
    import reference_gallery as rg

    ref = np.load(args.states)
    prob = fc.port_problem(args.name, ref, args.phase)
    options = dict(kkt_method='cr', chunk_iters=1,
                   **({} if args.phase else {'use_soc': False}))
    if args.phase == 2:
        jprob = rfs.betts_phase2(dict(kkt_method='cr',
                                      factor_dtype=jnp.float32))[0]
    else:
        jprob = rg.jax_cold_problem(args.name)[0]
    out = dict(name=args.name, phase=args.phase, contraction=contraction(),
               states={})
    free = ref['free']
    for k in args.ks:
        soc, direction, alpha32, alpha64 = soc_system(prob, ref, k, options)
        row = dict(alpha_float32=alpha32, alpha_float64=alpha64)
        for label, system, rounds in (('direction', direction, (0, 6)),
                                      ('soc', soc, (0, 1))):
            if system is not None:
                row[label] = solve_errors(
                    prob, jprob, free, ref['s%d_x' % k], ref['s%d_y' % k],
                    system, rounds, label == 'soc')
        out['states'][k] = row
        print(k, json.dumps(row), flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(line + '\n')


if __name__ == '__main__':
    main()
