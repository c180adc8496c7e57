"""Production mesh, as an abstract description (``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 cards over ("data", "model"); multi-pod: 2 x
16 x 16 = 512 cards with the outer "pod" axis as one more data-parallel
dimension.  The sizes are the reference's, so the sharding specs
(``runtime/sharding.py``) agree with its ``PartitionSpec``s cell for
cell.  A mesh here is only axis names and sizes: building one touches no
device and starts no process group.

Pricing on H100s (``launch/dryrun.py``).  Cards are laid out row-major
over the axes, the last axis innermost, and ``HardwareSpec.chips_per_node``
(8) cards share one NVLink board.  A collective over some axes runs over
NVLink (``ici_bandwidth``) when the block of cards it spans lies on one
board, i.e. the sizes of its outermost axis and every axis inside it
multiply to at most ``chips_per_node``; otherwise over the network
(``dcn_bandwidth``).  On the production meshes a 16-wide ``model`` axis
already spans two boards, and the ``data`` and ``pod`` axes span many,
so every collective there is priced at ``dcn_bandwidth``.  The
reference divides every byte by its TPU's interconnect rate; that figure
does not carry over.

The reference's ``make_mesh_compat`` and ``cost_analysis_dict`` only
absorb JAX API drift (mesh axis types, the shape of
``Compiled.cost_analysis()``); they have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

from repro_torch.utils.hw import H100, HardwareSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, outermost first."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axes)}")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def mesh_chips(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


def axes_of(axis) -> Tuple[str, ...]:
    """A spec entry (a name, a tuple of names or None) as a tuple."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def group_size(mesh, axis) -> int:
    """Cards in one collective group over ``axis`` (a name, a tuple of
    names or None)."""
    n = 1
    for a in axes_of(axis):
        n *= mesh.shape[a]
    return n


def group_bandwidth(mesh, axis, hw: HardwareSpec = H100) -> float:
    """Bytes/s a collective over ``axis`` runs at (module docstring):
    NVLink when the cards it spans lie on one board, else the network."""
    axes = axes_of(axis)
    if not axes:
        return hw.ici_bandwidth
    names = list(mesh.shape)
    outer = min(names.index(a) for a in axes)
    span = 1
    for a in names[outer:]:
        span *= mesh.shape[a]
    return hw.ici_bandwidth if span <= hw.chips_per_node else hw.dcn_bandwidth


# ----------------------------------------------------------------------
# A mesh over real processes
# ----------------------------------------------------------------------
def world_backend(device, world: int) -> str:
    """The process-group backend a layout needs: ``nccl`` when every rank
    has a card of its own, ``gloo`` when ranks share one card or run on
    the CPU (NCCL puts one rank on a device at most)."""
    import torch
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


class ProcessMesh:
    """The mesh over the ranks of the initialised default process group,
    with ``AbstractMesh``'s ``.shape`` dict, so every spec function takes
    it unchanged.

    Ranks are laid out row-major over the axes, the last axis innermost
    (the layout the dry-run prices): rank r has the coordinates
    ``numpy.unravel_index(r, axis_sizes)``.  One process group is made
    per combination of axes and per coset of it (``dist.new_group`` is
    collective: every rank builds every group in the same order); the
    group over all axes is the default group.  A group's members are its
    ranks in ascending order, i.e. row-major over the combination's axes
    in mesh order, which is the order ``axis_index`` counts in.
    ``transport`` (``runtime/collectives.py``) moves the tensors."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int]):
        import itertools
        import numpy as np
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised default "
                               "process group (launch/mesh.py::init_world)")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        world = dist.get_world_size()
        if int(np.prod(self.axis_sizes)) != world:
            raise ValueError(f"mesh {self.shape} needs "
                             f"{np.prod(self.axis_sizes)} ranks; the process "
                             f"group has {world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords = self.coords_of(self.rank)
        grid = np.arange(world).reshape(self.axis_sizes)
        self._groups: Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                inner = [self.axis_names.index(a) for a in axes]
                outer = [i for i in range(len(self.axis_names))
                         if i not in inner]
                cosets = np.transpose(grid, outer + inner).reshape(
                    -1, int(np.prod([self.axis_sizes[i] for i in inner])))
                for ranks in cosets:
                    ranks = tuple(int(r) for r in ranks)
                    pg = (dist.group.WORLD if len(ranks) == world
                          else dist.new_group(list(ranks)))
                    if self.rank in ranks:
                        self._groups[axes] = (pg, ranks)
        from repro_torch.runtime.collectives import Transport
        self.transport = Transport(self.backend)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axes(self, axis) -> Tuple[str, ...]:
        """``axis`` (a name, a tuple of names or None) as a tuple of
        names; a tuple must list its axes in mesh order."""
        axes = axes_of(axis)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        return axes

    def size(self, axis) -> int:
        return group_size(self, self.axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``, row-major over a tuple."""
        return self.index_of(self.rank, axis)

    def group(self, axis) -> Tuple[Any, Tuple[int, ...]]:
        """(process group, its ranks) of this rank's coset over ``axis``."""
        return self._groups[self.axes(axis)]

    def coords_of(self, rank: int) -> Dict[str, int]:
        import numpy as np
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, self.axis_sizes))))

    def index_of(self, rank: int, axis) -> int:
        """``rank``'s index along ``axis`` (row-major over a tuple)."""
        c, i = self.coords_of(rank), 0
        for a in self.axes(axis):
            i = i * self.shape[a] + c[a]
        return i


_WORLD_ENV = "REPRO_WORLD"


def init_world(device) -> "torch.device":
    """In a process started by ``spawn_world``: join its process group
    (the address, size, rank and backend come from the environment) and
    return the device this rank computes on: its own card under NCCL,
    the shared card or the CPU under gloo."""
    import json
    import os
    import torch
    import torch.distributed as dist
    cfg = json.loads(os.environ[_WORLD_ENV])
    dist.init_process_group(cfg["backend"], init_method=cfg["init_method"],
                            rank=cfg["rank"], world_size=cfg["world"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", cfg["rank"] if cfg["backend"] == "nccl"
                           else 0)
        torch.cuda.set_device(dev)
    return dev


def _rank_main() -> None:
    """Entry of a rank process: run ``module:function(**kwargs)`` and
    save what it returns (``spawn_world``)."""
    import importlib
    import json
    import os
    import torch
    import torch.distributed as dist
    cfg = json.loads(os.environ[_WORLD_ENV])
    torch.set_num_threads(1)
    mod, fn = cfg["fn"].split(":")
    kwargs = torch.load(os.path.join(cfg["dir"], "kwargs.pt"),
                        weights_only=False)
    out = getattr(importlib.import_module(mod), fn)(**kwargs)
    torch.save(out, os.path.join(cfg["dir"], f"rank{cfg['rank']}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_world(fn: str, world: int, kwargs: Dict[str, Any], *,
                device="cuda", timeout: float = 900.0,
                paths: Sequence[str] = ()) -> list:
    """Run ``fn`` (``"module:function"``) in ``world`` fresh interpreters
    (``subprocess.Popen``, never a fork of a CUDA process), each calling
    ``fn(**kwargs)`` (``init_world`` joins the group there); return each
    rank's result in rank order.  The backend is chosen from the layout
    (``world_backend``) and rides in the environment with a free
    ``tcp://localhost`` port; each rank runs torch on one host thread
    (the ranks share the host's cores).  On the card the kernel library
    is built here first, so the ranks load it and never run nvcc at
    once.  A rank that fails raises here with the tail of its stderr,
    after every rank is stopped; so does a world that outlives
    ``timeout``."""
    import json
    import os
    import shutil
    import socket
    import subprocess
    import sys
    import tempfile
    import time
    import torch
    import repro_torch
    from repro_torch.kernels import autotune
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.library()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    backend = world_backend(device, world)
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    procs, errs = [], []
    try:
        torch.save(kwargs, os.path.join(tmp, "kwargs.pt"))
        for r in range(world):
            # no tuning, this process's table: every rank resolves alike
            env = autotune.child_env()
            env["PYTHONPATH"] = os.pathsep.join(
                [src, *paths, env.get("PYTHONPATH", "")])
            env[_WORLD_ENV] = json.dumps({
                "backend": backend, "init_method": f"tcp://localhost:{port}",
                "rank": r, "world": world, "fn": fn, "dir": tmp})
            err = open(os.path.join(tmp, f"rank{r}.err"), "wb")
            errs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "from repro_torch.launch.mesh import "
                 "_rank_main; _rank_main()"], env=env, stderr=err))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        if failed or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            r = (failed or late)[0]
            with open(os.path.join(tmp, f"rank{r}.err"), "rb") as f:
                tail = f.read()[-4000:].decode(errors="replace")
            what = (f"exited {procs[r].returncode}" if failed
                    else f"outlived {timeout:.0f}s")
            raise RuntimeError(f"world of {world} ({backend}) running {fn}: "
                               f"rank {r} {what}\n{tail}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for e in errs:
            e.close()
        shutil.rmtree(tmp, ignore_errors=True)
