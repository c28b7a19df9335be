"""The port's ``parallel.multihost`` across real process boundaries (CPU).

Two processes join a ``gloo`` group on a free localhost port, each with a
mesh of two CPU devices; each feeds its own two pairs of a four-pair batch
(velocity from the GLOBAL pair index, so a placement mistake changes the
answer) and holds its flow ``torch.equal`` to the single-process flow of
the whole batch.  This file is also the worker:

    python tests/test_torch_multihost.py <process_id> <num_processes> <port>

The error messages are held to the JAX module's.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(offset: int, n: int):
    """n pairs whose velocity is 1 + the global pair index."""
    from cuda_optical_flow_2_torch.utils import io

    frames = [io.synthetic_sequence(2, 32, 48, velocity=(1.0 + offset + j, 0.0), noise=0.0)
              for j in range(n)]
    return (np.stack([f[0] for f in frames]).astype(np.float32),
            np.stack([f[1] for f in frames]).astype(np.float32))


def worker(pid: int, nproc: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch import parallel
    from cuda_optical_flow_2_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", nproc, pid, backend="gloo")
    multihost.initialize()  # idempotent: a second call is a no-op
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    cpu2 = [torch.device("cpu")] * 2

    mesh = multihost.make_global_mesh(devices=cpu2)
    assert mesh.shape == {"batch": 2 * nproc}, mesh.shape
    mesh2 = multihost.make_global_mesh(space_axis="space", devices=cpu2)
    assert mesh2.shape == {"batch": nproc, "space": 2}, mesh2.shape
    # a process whose device count does not divide the global count
    odd = [torch.device("cpu")] * (1 if pid == 0 else 3)
    if pid == 0:
        assert multihost.make_global_mesh(space_axis="space", devices=odd).shape == {
            "batch": 4, "space": 1}
    else:
        try:
            multihost.make_global_mesh(space_axis="space", devices=odd)
            raise AssertionError("no error for 4 devices over a local count of 3")
        except ValueError as e:  # JAX's message (multihost.py:96-98)
            assert str(e) == "4 devices not divisible by local count 3", str(e)

    global_batch = 2 * nproc
    per, off = multihost.host_local_batch(global_batch, mesh)
    assert (per, off) == (2, 2 * pid), (per, off)

    cfg = of.LKConfig(levels=1, window=9, iterations=2, use_pallas=False)
    local_prev, local_nxt = _frames(off, per)
    for m in (mesh, mesh2):
        flow = multihost.sharded_flow_from_local(local_prev, local_nxt, cfg, m)
        assert tuple(flow.shape) == (per, 32, 48, 2), tuple(flow.shape)
        gp, gn = _frames(0, global_batch)
        want = parallel.sharded_flow(torch.from_numpy(gp), torch.from_numpy(gn), cfg,
                                     parallel.make_mesh(devices=[torch.device("cpu")] * 4))
        assert torch.equal(flow, want[off:off + per])
        assert torch.equal(flow, of.pyramidal_lk(torch.from_numpy(local_prev),
                                                 torch.from_numpy(local_nxt), cfg))
    ok = torch.ones(())
    dist.all_reduce(ok)  # both processes got here
    assert int(ok) == nproc
    dist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_dp():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=REPO)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST_OK" in out, out


def test_error_messages_match_jax():
    """host_local_batch's divisibility error word for word, and the
    single-process global mesh's shapes, against the JAX module (the
    suite's eight virtual CPU devices)."""
    import jax
    import torch

    from cuda_optical_flow_2_tpu.parallel import multihost as jmultihost
    from cuda_optical_flow_2_torch.parallel import Mesh, multihost

    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("batch",))
    with pytest.raises(ValueError) as want:
        jmultihost.host_local_batch(3, jmesh)
    with pytest.raises(ValueError) as got:
        multihost.host_local_batch(3, Mesh([torch.device("cpu")] * 2, ("batch",)))
    assert str(got.value) == str(want.value) == "batch 3 not divisible by 2"
    assert multihost.host_local_batch(4, Mesh([torch.device("cpu")] * 2, ("batch",))) == (
        jmultihost.host_local_batch(4, jmesh))

    cpus = [torch.device("cpu")] * len(jax.devices())
    for space in (None, "space"):
        assert multihost.make_global_mesh(space_axis=space, devices=cpus).shape == dict(
            jmultihost.make_global_mesh(space_axis=space).shape)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
