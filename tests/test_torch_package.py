"""Package rules of opty_tpu_torch: no JAX and nothing of opty_tpu in
its import graph, the card by default, the JAX package's default solver
options accepted, and its refusals (kkt_method='spike' without a
mesh)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opty_tpu_torch
from opty_tpu_torch.models import swing_up_problem

ROOT = Path(__file__).resolve().parents[1]


def test_imports_no_jax_and_no_reference():
    """Every module of the port (the identification library, the plots
    and the examples included), and chip_smoke.py, imported in a fresh
    interpreter, leave jax and opty_tpu out of sys.modules, and
    matplotlib too: the card's machine has none, and the plots import
    it at the call."""
    modules = [m.name for m in pkgutil.walk_packages(
        opty_tpu_torch.__path__, 'opty_tpu_torch.')]
    for name in ('ops.pcr_kernels', 'parameter_identification', 'plotting',
                 'utils', 'models.spring_damper',
                 'examples.inverted_pendulum_id',
                 'examples.vyasarayani2011'):
        assert 'opty_tpu_torch.' + name in modules
    code = ('import sys, importlib\n'
            'sys.path.insert(0, {root!r})\n'
            'for m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'import chip_smoke\n'
            'bad = [m for m in sys.modules\n'
            '       if m.split(".")[0] in ("jax", "jaxlib", "opty_tpu",\n'
            '                               "matplotlib")]\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n').format(
                root=str(ROOT), mods=['opty_tpu_torch'] + modules)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_never_name_jax():
    sources = list((ROOT / 'opty_tpu_torch').rglob('*.py'))
    assert ROOT / 'opty_tpu_torch' / 'examples' / 'vyasarayani2011.py' \
        in sources
    for path in sources + [ROOT / 'chip_smoke.py']:
        for line in path.read_text().splitlines():
            words = line.replace('.', ' ').split()
            if words[:1] in (['import'], ['from']):
                assert words[1] not in ('jax', 'jaxlib', 'opty_tpu'), \
                    '{}: {}'.format(path, line)


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is usable')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        swing_up_problem(num_nodes=11)


def test_default_options_run_and_spike_raises():
    """No solver option set: adaptive mu, the second-order correction
    and restoration run through solve, solve_batch and solve_queue on
    the CPU; the Ipopt-name options of add_option map onto IPMOptions;
    the node-split 'spike' KKT method raises the JAX package's ValueError
    without a mesh (opty_tpu/nlp/collocation.py) and solves with one."""
    from opty_tpu_torch.parallel.mesh import NodeMesh
    prob = swing_up_problem(num_nodes=11, torque_bound=20.0, device='cpu')
    opt = prob._ipm_options
    assert opt.mu_strategy == 'adaptive' and opt.use_soc
    assert opt.max_rest_visit > 0
    prob.set_solver_options(mu_strategy='adaptive', use_soc=True)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=prob.num_free)
    x, info = prob.solve(x0)
    assert info['status'] == 0 and info['iterations'] > 0
    assert 'terminated successfully' in info['status_msg']
    assert set(info) >= {'rest_iterations', 'mono_fallback'}
    batch = prob.solve_batch(rng.normal(size=(2, prob.num_free)))
    assert batch.status.shape == (2,)
    queue = prob.solve_queue(rng.normal(size=(3, prob.num_free)),
                             batch_size=2)
    assert queue.status.shape == (3,)
    assert np.all(np.isin(np.asarray(batch.status), (0, 1)))
    assert np.all(np.isin(queue.status, (0, 1)))
    prob.set_solver_options(kkt_method='spike')
    with pytest.raises(ValueError, match="'spike' requires a mesh"):
        prob.solve(x0)
    prob.set_solver_options(mesh=NodeMesh(2))
    _, info_spike = prob.solve(x0)
    assert info_spike['status'] == 0
    assert abs(info_spike['obj_val'] - info['obj_val']) \
        <= 1e-6 * abs(info['obj_val'])
    prob.add_option('max_iter', 7)
    prob.add_option('tol', 1e-6)
    assert (prob._ipm_options.max_iter, prob._ipm_options.tol) == (7, 1e-6)
    with pytest.warns(UserWarning, match='print_level'):
        prob.add_option('print_level', 0)


def test_cpu_defaults():
    from opty_tpu_torch import config
    assert config.default_kkt_method('cpu') == 'scan'
    assert config.default_kkt_method('cuda') == 'cr'
    assert config.default_factor_dtype('cpu') == torch.float64
    assert config.default_factor_dtype('cuda') == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == 'highest'
