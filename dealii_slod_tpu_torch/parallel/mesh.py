"""Device meshes over ``torch.distributed`` (counterpart of
``dealii_slod_tpu/parallel/mesh.py``): the reference's MPI patch
partitioning (source/LOD.cc:116-118), with the communication written out.

JAX shards an array over a ``jax.sharding.Mesh`` and lets XLA insert the
halo gathers and the ``psum``s.  PyTorch has no partitioner, so the port
runs one process per rank and the communication is written out:

- ``make_mesh`` / ``shard_patches`` / ``replicate``: a 1-D
  ``DeviceMesh`` and the ``DTensor`` placements of JAX's
  ``NamedSharding``;
- ``spawn``: the launcher (JAX ran every device from one process);
- ``all_gather_rows``, ``exchange_rows``: the coarse CG's gathered
  vector and the stencil build's halo (its dot products are
  ``dist.all_reduce``s, in ``ops/solvers.py: cg``);
- ``full_tensor``: a ``DTensor``'s global array.

Backends: ``"nccl"`` when every rank has a card of its own, ``"gloo"`` on
the CPU or when ranks share a card (NCCL refuses two ranks on one device).
Gloo takes CUDA tensors in ``all_reduce`` and ``all_gather_into_tensor``,
but DTensor's own gather (``DTensor.full_tensor``) ends the process with
a segmentation fault on CUDA tensors over gloo (torch 2.11, an H100), and
gloo's point-to-point ops are not relied on for CUDA tensors: those two
(``GLOO_HOST_OPS``) are staged through host memory, in the gloo branch
only, and say so once.  No basis or kernel work ever moves to the CPU."""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

# the ops staged through host memory on CUDA tensors over gloo
GLOO_HOST_OPS = frozenset({"exchange_rows", "full_tensor"})
_staged_said: set = set()
# ``all_gather_into_tensor`` under the name that newer releases give it
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def _backend(device, n: int) -> str:
    """"nccl" when ``n`` ranks on ``device`` each get a card of their own,
    else "gloo"."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= n):
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, axis: str = "patches",
              device="cuda") -> DeviceMesh:
    """1-D ``DeviceMesh`` over the ranks of the process group, its one
    dimension named ``axis`` (``jax.sharding.Mesh``'s counterpart).
    ``n_devices=None`` means the world size; another count than the world
    size raises ``ValueError``.  Rank r drives cuda:{r % device_count}
    (the CPU only when ``device`` says so).  Without a process group, one
    is made from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ...); with neither, the ranks must be started by ``spawn``."""
    device = torch.device(device)
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("make_mesh needs a process group: start the "
                               "ranks with parallel.mesh.spawn or torchrun")
        dist.init_process_group(
            _backend(device, int(os.environ["WORLD_SIZE"])),
            init_method="env://")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{n} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, (n,), mesh_dim_names=(axis,))


def check_mesh(mesh, axis: str, device: torch.device) -> None:
    """Refuse what a sharded step cannot run on: a ``mesh`` that is not a
    ``DeviceMesh`` (``TypeError``), one without the dimension ``axis`` or
    on another device type than the solver's ``device`` (``ValueError``)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel."
                        f"make_mesh), not {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no dimension {axis!r} (it has "
                         f"{mesh.mesh_dim_names})")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the solver "
                         f"on {torch.device(device).type}")


def shard_patches(mesh: DeviceMesh, x: torch.Tensor,
                  axis: str = "patches") -> DTensor:
    """``x`` (the whole array, on every rank) as a ``DTensor`` with its
    leading axis sharded over the mesh (``Shard(0)``): rank r keeps rows
    [r n0 / n, (r + 1) n0 / n).  Replicates when the leading dim does not
    divide the mesh, as the reference does."""
    n = mesh.size()
    if x.shape[0] % n:
        return replicate(mesh, x)
    r = mesh.get_local_rank(axis)
    rows = x.shape[0] // n
    return DTensor.from_local(x[r * rows:(r + 1) * rows], mesh, [Shard(0)],
                              run_check=False)


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    return DTensor.from_local(x, mesh, [Replicate()], run_check=False)


def _staged(op: str, x: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``x`` goes through host memory: gloo, a CUDA
    tensor and one of ``GLOO_HOST_OPS`` (said once per op)."""
    if (not x.is_cuda or op not in GLOO_HOST_OPS
            or dist.get_backend(group) != "gloo"):
        return False
    if op not in _staged_said:
        _staged_said.add(op)
        print(f"parallel.mesh: {op} of CUDA tensors over gloo goes "
              "through host memory")
    return True


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank
    order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def full_tensor(x: DTensor) -> torch.Tensor:
    """``x.full_tensor()`` of a 1-D mesh's ``DTensor`` (``Shard(0)`` in
    equal shards, or ``Replicate()``), on every rank; over gloo on a card
    the shards are gathered through host memory."""
    local = x.to_local()
    group = x.device_mesh.get_group()
    if not _staged("full_tensor", local, group):
        return x.full_tensor()
    if isinstance(x.placements[0], Replicate):
        return local
    return all_gather_rows(local.cpu(), group).to(local.device)


def _overlap(a: tuple, b: tuple) -> tuple:
    return max(a[0], b[0]), min(a[1], b[1])


def exchange_rows(local: torch.Tensor, owned: list, needed: list,
                  group=None) -> tuple:
    """Rows ``needed[r]`` = [lo, hi) of a global array whose rank t holds
    rows ``owned[t]`` as its ``local``, for this rank r: each rank sends
    the rows of its own range that another rank needs, point to point, and
    nothing else.  Returns (rows (hi - lo, ...), bytes received)."""
    me = dist.get_rank(group)
    lo, hi = needed[me]
    a, b = owned[me]
    out = local.new_empty((hi - lo,) + local.shape[1:])
    s0, s1 = _overlap((lo, hi), (a, b))
    if s0 < s1:
        out[s0 - lo:s1 - lo] = local[s0 - a:s1 - a]
    host = _staged("exchange_rows", local, group)
    ops, recvs = [], []
    for t in range(len(owned)):
        if t == me:
            continue
        g = dist.get_global_rank(group, t) if group is not None else t
        s0, s1 = _overlap((a, b), needed[t])
        if s0 < s1:
            send = local[s0 - a:s1 - a]
            ops.append(dist.P2POp(
                dist.isend, send.cpu() if host else send.contiguous(), g,
                group=group))
        r0, r1 = _overlap(owned[t], (lo, hi))
        if r0 < r1:
            buf = local.new_empty((r1 - r0,) + local.shape[1:],
                                  device="cpu" if host else local.device)
            ops.append(dist.P2POp(dist.irecv, buf, g, group=group))
            recvs.append((r0, r1, buf))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    n_bytes = 0
    for r0, r1, buf in recvs:
        out[r0 - lo:r1 - lo] = buf
        n_bytes += buf.numel() * buf.element_size()
    return out, n_bytes


class RankResult(NamedTuple):
    """What one spawned rank gave back: ``fn``'s value (its tensors on the
    CPU) and the rank's kernel launches (``utils.kernels.launches``)."""
    value: object
    launches: Counter


def _to_cpu(value):
    from torch.utils._pytree import tree_map
    return tree_map(lambda v: v.detach().cpu()
                    if isinstance(v, torch.Tensor) else v, value)


def _rank_main(rank, n, backend, device_type, rendezvous, queue, fn, args):
    from dealii_slod_tpu_torch.utils import kernels
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            # the host's cores shared out: more threads than cores spin
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                world_size=n, rank=rank)
        try:
            kernels.reset_launch_counts()
            # pickled here, by value: torch's queue would share the
            # tensors' memory, which ends with this process
            value = pickle.dumps(_to_cpu(fn(*args)))
            queue.put((rank, None, value, Counter(kernels.launches)))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:                    # reported to the parent
        queue.put((rank, traceback.format_exc(), None, None))
        raise


def spawn(fn, n: int, device="cuda", *args) -> list:
    """Run ``fn(*args)`` on ``n`` ranks, one process each (the ``spawn``
    start method; CUDA does not survive ``fork``), in a process group
    rendezvousing through a file in a temporary directory (no TCP port, so
    parallel test workers cannot clash).  ``fn`` must be importable by
    name.  The backend is ``_backend(device, n)``, and is printed.
    Returns a ``RankResult`` per rank, in rank order; a rank's exception
    ends the other ranks and raises here, with every failed rank's
    traceback.  Build the kernels
    (``utils.kernels.library()``) before calling this on the card, so that
    the ranks do not all run nvcc."""
    device = torch.device(device)
    backend = _backend(device, n)
    print(f"parallel.spawn: {n} rank(s) on {device.type} over {backend}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, n, backend, device.type, os.path.join(tmp, "rendezvous"),
            queue, fn, args)) for r in range(n)]
        for p in procs:
            p.start()
        results, errors, deadline = {}, {}, None
        try:
            while len(results) + len(errors) < n and (
                    deadline is None or time.monotonic() < deadline):
                try:
                    rank, tb, value, counts = queue.get(timeout=1)
                except queue_mod.Empty:      # a rank that died unheard
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in results:
                            errors.setdefault(
                                r, f"exited with code {p.exitcode}")
                else:
                    if tb is None:
                        results[rank] = RankResult(pickle.loads(value),
                                                   counts)
                    else:
                        errors[rank] = f"failed:\n{tb}"
                if errors and deadline is None:
                    # a failure ends the others' collectives too: hear
                    # what they say for a moment before ending them
                    deadline = time.monotonic() + 3
        finally:
            for p in procs:
                if errors and p.is_alive():
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("parallel.spawn: " + "\n".join(
            f"rank {r} {errors[r]}" for r in sorted(errors)))
    return [results[r] for r in range(n)]
