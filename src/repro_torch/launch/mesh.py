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
from typing import Dict, Sequence, Tuple

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


def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def group_size(mesh, axis) -> int:
    """Cards in one collective group over ``axis`` (a name, a tuple of
    names or None)."""
    n = 1
    for a in _axes(axis):
        n *= mesh.shape[a]
    return n


def group_bandwidth(mesh, axis, hw: HardwareSpec = H100) -> float:
    """Bytes/s a collective over ``axis`` runs at (module docstring):
    NVLink when the cards it spans lie on one board, else the network."""
    axes = _axes(axis)
    if not axes:
        return hw.ici_bandwidth
    names = list(mesh.shape)
    outer = min(names.index(a) for a in axes)
    span = 1
    for a in names[outer:]:
        span *= mesh.shape[a]
    return hw.ici_bandwidth if span <= hw.chips_per_node else hw.dcn_bandwidth
