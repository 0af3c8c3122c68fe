"""Two CPU processes joined by torch.distributed (gloo) through
opty_tpu_torch.parallel.multihost: a data-parallel split batch solves to
the single-process solve (as tests/test_multihost.py asks of the JAX
package's jax.distributed path), and a node mesh over the two processes
(one slab a rank) solves a KKT system to the one-process spike solve."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

WORKER = r'''
import sys
rank, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
import numpy as np
import torch
import torch.distributed as dist
from opty_tpu_torch.models import spring_damper_problem
from opty_tpu_torch.parallel import multihost, solve_batch_sharded
from opty_tpu_torch.parallel.mesh import NodeMesh
from opty_tpu_torch.parallel.spike import spike_solve

multihost.initialize('127.0.0.1:' + port, nproc, rank, device='cpu')
assert dist.get_world_size() == nproc
prob = spring_damper_problem(num_nodes=21, device='cpu')
batch = np.random.default_rng(5).normal(size=(2 * nproc, prob.num_free))
batch *= 0.1
mesh = multihost.global_batch_mesh()
local = multihost.host_local_batch_to_global(batch[2 * rank:2 * rank + 2],
                                             mesh)
res = solve_batch_sharded(prob, local)
sysm = np.load(out + '.system.npz')
args = [torch.as_tensor(sysm[k]) for k in ('D', 'E', 'F', 'Kbb', 'r', 'rb')]
u, beta = spike_solve(*args, NodeMesh(group=dist.group.WORLD))
np.savez(out + '.%d.npz' % rank, x=res.x.numpy(),
         status=res.status.numpy(), u=u.numpy(), beta=beta.numpy())
dist.destroy_process_group()
print('MULTIHOST_OK', rank, flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_solves(tmp_path):
    from opty_tpu_torch.models import spring_damper_problem
    from opty_tpu_torch.parallel.mesh import NodeMesh
    from opty_tpu_torch.parallel.spike import spike_solve
    from test_torch_spike import system

    _, D, E, F, Kbb, r, rb = system(21, 30, 2, 1, 1, 1)
    out = str(tmp_path / 'result')
    np.savez(out + '.system.npz', D=D.numpy(), E=E.numpy(), F=F.numpy(),
             Kbb=Kbb.numpy(), r=r.numpy(), rb=rb.numpy())
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    env['OMP_NUM_THREADS'] = '1'
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), '2', port, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail('multihost workers timed out:\n' + '\n'.join(outs))
    for i, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker {} failed:\n{}'.format(i, text)
        assert 'MULTIHOST_OK {}'.format(i) in text, text

    prob = spring_damper_problem(num_nodes=21, device='cpu')
    batch = np.random.default_rng(5).normal(size=(4, prob.num_free)) * 0.1
    ref = prob.solve_batch(batch)
    u_ref, beta_ref = spike_solve(D, E, F, Kbb, r, rb, NodeMesh(2))
    for i in range(2):
        got = np.load(out + '.{}.npz'.format(i))
        np.testing.assert_array_equal(got['status'], ref.status.numpy())
        assert np.all(got['status'] == 0)
        np.testing.assert_allclose(got['x'], ref.x.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got['u'], u_ref.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got['beta'], beta_ref.numpy(), rtol=0,
                                   atol=1e-12)
