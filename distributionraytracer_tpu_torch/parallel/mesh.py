"""Intersectors, losses, and pixel-row sharding over ``torch.distributed``.

Counterpart of ``distributionraytracer_tpu.parallel.mesh``.

**Gradients.**  The CUDA kernels are forward-only (their wrappers refuse
tensors that require a gradient), and the traversals' discrete decisions
(visit order, early exits) carry no gradient.  So a gradient step takes its
intersectors from :func:`accel_intersectors` with ``differentiable=True``:
the base picks each lane's winner under ``torch.no_grad()`` on a detached
copy of the scene and of the tables, and the winning hits are recomputed
in plain torch from the gradient-carrying scene
(:func:`integrator.whitted.differentiable_intersectors`)::

    scene = dataclasses.replace(scene, mat_cd=mat_cd)  # requires_grad
    inter = accel_intersectors(scene, cfg, tables, differentiable=True)
    loss = l2_render_loss(scene, cfg, samples, target, inter=inter)
    loss.backward()

The tables stay as they were built during a geometry step: winners are
picked on them, and hits are recomputed from the updated leaves.  By table
type, on CUDA tensors (their plain versions on CPU ones or with
``kernels='off'``):

- None (accel NONE): K1/K2;
- :class:`PacketTables` (a BVH scene's): K7 (grouped) or K8 (threaded);
- :class:`CudaGrid` (a grid scene's emulation tables): K7 in grid shadow
  mode with the grid's gates;
- :class:`GridArrays`: the plain torch 3D-DDA on any device;
- :class:`ThreadedBVH`: the plain torch stackless walk on any device.

**Sharding.**  The reference parallelises its pixel loop with OpenMP
(main.cpp:538, 603); here each process of a ``torch.distributed`` group
renders a slab of pixel rows with the scene and tables replicated, and
:func:`render_image_sharded` gathers the slabs on every process.
:func:`make_sharded_train_step` all-reduces the loss and the gradients.
A group is NCCL for CUDA devices, gloo for the CPU; one process a card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from distributionraytracer_tpu_torch.accel.bvh import (
    PacketTables, ThreadedBVH, make_threaded_intersectors,
)
from distributionraytracer_tpu_torch.accel.cuda_bvh import packet_intersectors
from distributionraytracer_tpu_torch.accel.cuda_grid import (
    CudaGrid, make_cuda_grid_intersectors,
)
from distributionraytracer_tpu_torch.accel.grid import (
    GridArrays, make_grid_intersectors,
)
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet, TileGraphs, make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    Intersectors, brute_intersectors, differentiable_intersectors,
)
from distributionraytracer_tpu_torch.scene.types import SceneData
from distributionraytracer_tpu_torch.utils import spans


def detached(scene: SceneData) -> SceneData:
    """``scene`` with every leaf detached from the autograd graph: the
    tables built from it never trip the kernels' gradient guard."""
    return SceneData(**{n: getattr(scene, n).detach()
                        for n in SceneData._LEAF_NAMES}, static=scene.static)


def _detached_tables(tables):
    """Accel tables (a NamedTuple of tensors, arrays and nested tables)
    with every tensor detached."""
    if isinstance(tables, torch.Tensor):
        return tables.detach()
    if isinstance(tables, tuple) and hasattr(tables, "_fields"):
        return type(tables)(*(_detached_tables(x) for x in tables))
    return tables


def accel_intersectors(scene: SceneData, cfg: RenderConfig, accel,
                       grid_unroll: Optional[int] = None,
                       differentiable: bool = False
                       ) -> Optional[Intersectors]:
    """Intersectors for any accel tables (module docstring), or None for
    brute force.  ``grid_unroll`` is the DDA's objects an iteration
    (``accel.grid._pick_unroll`` of the cells when None).

    Without ``differentiable``, brute force returns None (the render's own
    route).  With it, the base is built from ``detached`` scene and tables
    and wrapped by :func:`differentiable_intersectors`.  Raises TypeError
    on tables of any other type.
    """
    if differentiable:
        if accel is None:
            base = brute_intersectors(detached(scene), cfg)
        else:
            base = accel_intersectors(detached(scene), cfg,
                                      _detached_tables(accel), grid_unroll)
        return differentiable_intersectors(scene, cfg, base)
    if accel is None:
        return None
    mb, plain = cfg.motion_blur, cfg.kernels == "off"
    if isinstance(accel, PacketTables):
        return packet_intersectors(scene, accel, mb, plain=plain)
    if isinstance(accel, CudaGrid):
        return make_cuda_grid_intersectors(scene, accel, mb, plain=plain)
    if isinstance(accel, GridArrays):
        return make_grid_intersectors(scene, accel, mb, unroll=grid_unroll)
    if isinstance(accel, ThreadedBVH):
        return make_threaded_intersectors(scene, accel, mb)
    raise TypeError(f"unknown accel tables: {type(accel)}")


def l2_render_loss(scene: SceneData, cfg: RenderConfig, samples: SampleSet,
                   target: torch.Tensor, row_offset=0,
                   inter: Optional[Intersectors] = None) -> torch.Tensor:
    """Mean squared error of the render of ``samples`` against ``target``
    (H, W, 3)."""
    with spans.span("grad.loss"):
        img = render_from_samples(scene, cfg, samples, row_offset=row_offset,
                                  inter=inter)
        return torch.mean((img - target) ** 2)


# ------------------------------------------------------------ process groups
def backend_for(device) -> str:
    """The collective backend for ``device``: NCCL for CUDA, gloo for the
    CPU.  Raises where NCCL is missing: there is no fallback to gloo."""
    if torch.device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend")
        return "nccl"
    return "gloo"


def init_file_group(device, store: str, rank: int = 0,
                    world: int = 1) -> None:
    """Join a group through a ``file://`` store (``store`` a path on a
    file system every process sees); the backend from ``device``."""
    dist.init_process_group(backend_for(device), init_method=f"file://{store}",
                            rank=rank, world_size=world)


def maybe_init_distributed(device, verbose: bool = False) -> bool:
    """Join a process group when the environment asks for one, before the
    first device query; returns True when a group is up.  Safe to call
    twice.

    The same variables as the JAX package's: ``DRT_COORDINATOR`` (host:port
    of rank 0) with ``DRT_NUM_PROCESSES`` and ``DRT_PROCESS_ID``; or
    ``DRT_DISTRIBUTED=1`` with torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``.  The backend follows ``device``
    (:func:`backend_for`); on CUDA each process takes the card of its
    ``LOCAL_RANK`` (else of its rank).
    """
    if dist.is_initialized():
        return True
    coord = os.environ.get("DRT_COORDINATOR")
    if coord:
        rank = int(os.environ["DRT_PROCESS_ID"])
        dist.init_process_group(
            backend_for(device), init_method=f"tcp://{coord}", rank=rank,
            world_size=int(os.environ["DRT_NUM_PROCESSES"]))
    elif os.environ.get("DRT_DISTRIBUTED") == "1":
        rank = int(os.environ["RANK"])
        dist.init_process_group(backend_for(device))
    else:
        return False
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if verbose:
        print(f"torch.distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()}, backend {dist.get_backend()}")
    return True


class RowMesh(NamedTuple):
    """This process's place in the row sharding: ``rank`` of ``world``
    processes, rendering on ``device``.  The counterpart of the JAX
    package's ``make_device_mesh``; its ``ensure_devices`` (which switches
    XLA to virtual CPU devices) has none: a torch group of CPU processes
    is the CPU mesh."""

    rank: int
    world: int
    device: torch.device


def make_row_mesh(device) -> RowMesh:
    """The RowMesh of the current process group (world size 1 without
    one); ``"cuda"`` resolves to this process's current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        return RowMesh(dist.get_rank(), dist.get_world_size(), dev)
    return RowMesh(0, 1, dev)


def _pad_rows(samples: SampleSet, ndev: int):
    """``samples`` with zero rows appended up to a multiple of ``ndev``,
    and the original height."""
    H = samples.time.shape[0]
    pad = (-H) % ndev
    if pad == 0:
        return samples, H
    f = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return SampleSet(f(samples.pixel), f(samples.light), f(samples.lens),
                     f(samples.time)), H


def _all_rows(part: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """Every rank's slab of rows, in rank order, on every rank."""
    if mesh.world == 1 and not dist.is_initialized():
        return part
    out = part.new_empty((mesh.world * part.shape[0],) + part.shape[1:])
    dist.all_gather_into_tensor(out, part.contiguous())
    return out


def render_image_sharded(scene: SceneData, cfg: RenderConfig, mesh: RowMesh,
                         generator: Optional[torch.Generator] = None,
                         samples: Optional[SampleSet] = None, accel=None,
                         grid_unroll: Optional[int] = None,
                         graphs: Optional[TileGraphs] = None) -> torch.Tensor:
    """The full image with its rows sharded over the group: each rank
    renders its ``rows_per`` rows at ``row_offset = rank * rows_per``
    through :func:`accel_intersectors` (so accel tables take their packet,
    DDA or walk route, never brute force), the padded image is gathered on
    every rank, and the ``[:H]`` crop returned: (H, W, 3), as
    ``render_image``.  Every rank must pass the same scene, tables and
    samples (or a generator in the same state).  ``graphs``, this rank's
    own, keeps the tile graphs of the fused-level route across frames
    (``render_from_samples``)."""
    if samples is None:
        samples = make_samples(scene, cfg, generator)
    samples, H = _pad_rows(samples, mesh.world)
    rows_per = samples.time.shape[0] // mesh.world
    off = mesh.rank * rows_per
    inter = accel_intersectors(scene, cfg, accel, grid_unroll)
    part = render_from_samples(scene, cfg, samples.rows(off, off + rows_per),
                               row_offset=off, inter=inter, graphs=graphs)
    return _all_rows(part, mesh)[:H]


def make_sharded_train_step(cfg: RenderConfig, mesh: RowMesh, rows_per: int,
                            lr: float = 1e-2, update_leaves=None, accel=None,
                            grid_unroll: Optional[int] = None):
    """An inverse-rendering step: the L2 loss of this rank's ``rows_per``
    rows, its gradient in the float leaves ``update_leaves`` names (every
    float leaf when None), the loss and gradients all-reduced and divided
    by the world size, and an SGD step on those leaves; every other leaf
    passes through.  Only the updated leaves require a gradient, so no
    graph is kept for the others.

    ``step(scene, samples, target) -> (loss, scene)`` takes the padded
    frame's samples and target (``_pad_rows``), the same on every rank.
    The intersectors come from ``accel_intersectors(..., accel,
    differentiable=True)`` with the tables given: on CUDA tensors K1/K2
    (None) or K7 (a BVH's :class:`PacketTables`, a grid's
    :class:`CudaGrid`) under ``no_grad``; the plain traversals on
    :class:`GridArrays` / :class:`ThreadedBVH`.  (The JAX package's step
    forces its XLA traversals instead.)
    """
    names = tuple(SceneData._LEAF_NAMES if update_leaves is None
                  else update_leaves)

    def step(scene: SceneData, samples: SampleSet, target: torch.Tensor):
        off = mesh.rank * rows_per
        xs = {n: getattr(scene, n).detach().requires_grad_(True)
              for n in names if getattr(scene, n).is_floating_point()}
        sc = dataclasses.replace(scene, **xs)
        inter = accel_intersectors(sc, cfg, accel, grid_unroll,
                                   differentiable=True)
        loss = l2_render_loss(sc, cfg, samples.rows(off, off + rows_per),
                              target[off:off + rows_per], row_offset=off,
                              inter=inter)
        grads = torch.autograd.grad(loss, list(xs.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs.values(), grads)]
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        if dist.is_initialized():
            dist.all_reduce(flat)
            flat = flat / mesh.world
        parts = torch.split(flat[1:], [g.numel() for g in grads])
        new = {n: x.detach() - lr * p.reshape(x.shape)
               for (n, x), p in zip(xs.items(), parts)}
        return flat[0], dataclasses.replace(scene, **new)

    return step
