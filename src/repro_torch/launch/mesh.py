"""Production and test meshes over PyTorch's ``fake`` process group.

Functions only: importing this module touches no process-group state.  A
mesh needs the world that ``launch.dryrun`` (or a test's own process)
starts first, ``fake`` ranks that run no collective and move no byte,
so that DTensors on the ``meta`` device trace a step at 256 or 512 ranks in
one process (:func:`init_fake_world`).
"""
from __future__ import annotations

__all__ = ["init_fake_world", "make_production_mesh", "make_test_mesh",
           "make_mesh", "fold_pod"]


def init_fake_world(world_size: int) -> None:
    """Start the process's ``fake`` group of ``world_size`` ranks, this
    process rank 0; once a process (a running group of another size
    raises)."""
    import torch.distributed as dist

    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world_size:
            raise RuntimeError(f"a group of {have} ranks is running; "
                               f"{world_size} were asked for")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over the running group (its size must
    be the mesh's); its tensors' local shards live on the ``meta`` device,
    the mesh's device type is the CPU's."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The target deployment mesh.

    Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x 256
    as (pod=2, data=16, model=16); the 'pod' dim carries data parallelism
    over the slowest links.
    """
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0):
    """A small mesh: (data, model), or (pod, data, model) with ``pod``."""
    if pod:
        return make_mesh((pod, n_data, n_model), ("pod", "data", "model"))
    return make_mesh((n_data, n_model), ("data", "model"))


def fold_pod(mesh):
    """A (pod, data, model) mesh as the 2-d (data, model) mesh over the same
    ranks, pod and data folded into one data dim of pod x data; any other
    mesh as it is.

    Both dims carry data parallelism only (the rules shard no weight over
    them), so a rank's shards and the operand bytes of its collectives are
    the same on either mesh.  The dry run runs its multi-pod cells on the
    folded mesh: DTensor's search for a redistribution plan over a 3-d mesh
    stalls some backward products (strided shards of a folded batch
    dim).
    """
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    pod, data, model = (dict(zip(names, tuple(mesh.shape)))[n]
                        for n in ("pod", "data", "model"))
    ranks = mesh.mesh.permute([names.index(n) for n in
                               ("pod", "data", "model")])
    return DeviceMesh(mesh.device_type,
                      ranks.reshape(pod * data, model).to(torch.int64),
                      mesh_dim_names=("data", "model"))
