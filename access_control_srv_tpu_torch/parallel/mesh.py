"""The process mesh, batch-axis sharding and the collectives of the port's
multi-device kernels.

The JAX package drives every device from one process: a
``jax.sharding.Mesh`` names the devices, ``NamedSharding`` places arrays
and XLA inserts the collectives.  The port runs one process per rank
(SPMD): ``Mesh`` is this rank's view of a ``(data, model)`` process grid,
with its coordinates and one ``torch.distributed`` process group per axis,
and every rank is handed the same request list, encodes the whole batch on
the host, decides its own slice and gathers the rest.  The same object
serves three set-ups: gloo on the CPU, gloo with every rank on one CUDA
device (the collectives are then staged through the host explicitly, see
``_host_staged``), and NCCL with one rank per card.

``ShardedDecisionKernel`` is the data-parallel dense kernel (K6): each
rank runs ``decide_dense`` (``ops/csrc/decide_dense.cu``) on its row
slice and the three int32 outputs (four in explain mode) are all-gathered
over the ``data`` group, so ``materialize()`` returns the whole batch on
every rank.

The JAX module's ``resolve_shard_map`` / ``wrap_shard_map`` are shims over
JAX versions' ``shard_map`` spellings and have no counterpart here.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.carry import _tensor, pad_cols, pow2_bucket, tables_from_numpy
from ..ops.compile import CompiledPolicies
from ..ops.encode import RequestBatch
from ..ops.kernel import (
    ORIG_TABLE,
    ROW_ARRAYS,
    TABLE_ARRAYS,
    decide_dense,
    readback,
    resolve_device,
    tree_needs_hr,
    tree_needs_rel,
)

# collectives issued by this process: calls and bytes per op (what
# PERF.md's per-batch collective counts are read from)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


@dataclass(frozen=True)
class Mesh:
    """This rank's view of an ``axis_names`` process grid: ``shape`` and
    ``coords`` map each axis to its size and this rank's coordinate,
    ``groups`` to the axis's process group (None on a size-1 axis, whose
    collectives are the identity).  Ranks are laid out row-major, so the
    last axis (``model``) holds adjacent ranks."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    backend: Optional[str]
    device: torch.device
    # False on a rank outside a layout smaller than the process group
    # (``coords`` then empty): it runs no kernel of this mesh
    member: bool = True


def default_device(device=None) -> torch.device:
    """``None`` means this rank's card, ``cuda:{local_rank %
    device_count}`` (``LOCAL_RANK``, else the global rank); the CPU only
    when asked for."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _grid_mesh(sizes: dict, device, timeout=None) -> Mesh:
    names = tuple(sizes)
    need = math.prod(sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(
            f"mesh {dict(sizes)} needs {need} ranks; the process group has "
            f"{world}"
        )
    rank = dist.get_rank() if dist.is_initialized() else 0
    # a layout smaller than the world takes its first ranks, as a JAX
    # mesh of n devices takes the first n
    grid = np.arange(need).reshape(tuple(sizes.values()))
    member = rank < need
    coords = dict(zip(names, (int(c) for c in np.argwhere(grid == rank)[0]))
                  ) if member else {}
    groups = {}
    for axis, name in enumerate(names):
        mine = None
        # every rank creates every group of the axis, in the same order
        lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[name])
        for line in lines:
            if sizes[name] == 1:
                break
            group = dist.new_group([int(x) for x in line], timeout=timeout)
            if rank in line:
                mine = group
        groups[name] = mine
    return Mesh(axis_names=names, shape=dict(sizes), coords=coords,
                groups=groups,
                backend=dist.get_backend() if dist.is_initialized() else None,
                device=default_device(device), member=member)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None, timeout=None) -> Mesh:
    """One-axis mesh over the whole process group, or over its first
    ``n_devices`` ranks (the others get a mesh with ``member`` False); a
    process without a process group is a 1-rank mesh.  ``timeout`` (a
    ``timedelta``) bounds each collective of the axis groups (None: the
    backend's default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _grid_mesh({axis: world if n_devices is None else n_devices},
                      device, timeout)


def make_mesh2(n_data: int, n_model: int, data_axis: str = "data",
               model_axis: str = "model", device=None,
               timeout=None) -> Mesh:
    """Two-axis (data x model) mesh for the sharded kernels: requests
    shard over ``data_axis``, the compiled tables over ``model_axis``
    (parallel/rule_shard.py, parallel/pod_shard.py); adjacent ranks land
    on the model axis.  A grid smaller than the process group takes its
    first ranks, as ``make_mesh`` does; ``timeout`` as there."""
    return _grid_mesh({data_axis: n_data, model_axis: n_model}, device,
                      timeout)


def pad_batch(arrays: dict, B: int, multiple: int) -> tuple[dict, int]:
    """Pad the leading batch axis up to a multiple (repeating row 0) so it
    shards evenly; returns (padded arrays, padded size)."""
    if B % multiple == 0:
        return arrays, B
    pad = multiple - (B % multiple)
    out = {}
    for k, v in arrays.items():
        pad_rows = np.repeat(v[:1], pad, axis=0)
        out[k] = np.concatenate([v, pad_rows], axis=0)
    return out, B + pad


def shard_bucket(B: int, n_data: int) -> int:
    """The padded batch of a data-sharded launch: ``n_data *
    pow2_bucket(ceil(B / n_data))``, stable shapes and even slices."""
    return n_data * pow2_bucket(-(-B // n_data))


def row_slice(batch: RequestBatch, device, keys, n_data: int, index: int
              ) -> tuple[int, dict]:
    """Rank ``index``'s slice of a batch padded to ``shard_bucket`` rows
    (pad rows repeat row 0, as the JAX package pads) -> (real row count,
    device tensors): the per-row arrays ``keys``, the condition columns
    ``[C, rows]`` and the regex matrices padded to the entity bucket."""
    arrays = {k: np.asarray(batch.arrays[k]) for k in keys}
    for name in ("cond_true", "cond_abort", "cond_code"):
        arrays[name] = np.asarray(getattr(batch, name)).T
    bucket = shard_bucket(batch.B, n_data)
    arrays, _ = pad_batch(arrays, batch.B, bucket)
    per = bucket // n_data
    lo, hi = index * per, (index + 1) * per
    out = {}
    for k, v in arrays.items():
        part = v[lo:hi]
        out[k] = _tensor(part.T if k.startswith("cond_") else part, device)
    e_bucket = pow2_bucket(batch.rgx_set.shape[1])
    out["rgx_set"] = _tensor(pad_cols(batch.rgx_set, e_bucket), device)
    out["pfx_neq"] = _tensor(pad_cols(batch.pfx_neq, e_bucket), device)
    return batch.B, out


def _host_staged(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """gloo has no CUDA path for every collective: its operand is copied
    to the host explicitly (and the result back by the caller); NCCL and
    CPU tensors run in place."""
    if mesh.backend == "gloo" and t.device.type == "cuda":
        return t.cpu()
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               op=dist.ReduceOp.MIN) -> torch.Tensor:
    """``op`` over the ``axis`` group -> the reduced tensor on ``t``'s
    device (``t`` itself when it ran in place)."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    x = _host_staged(t, mesh)
    dist.all_reduce(x, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    return x if x is t else x.to(t.device)


def all_gather_cols(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' ``t`` [k, n] concatenated along the last axis in
    ``axis``-coordinate order -> [k, n * size]."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    x = _host_staged(t, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size() * len(parts)
    return torch.cat(parts, dim=-1).to(t.device)


class ShardedDecisionKernel:
    """The dense decision kernel with the batch sharded over the mesh's
    ``axis``: each rank decides its row slice with ``decide_dense`` and the
    outputs are all-gathered (K6); ``explain=True`` gathers the provenance
    codes as a fourth row."""

    def __init__(self, compiled: CompiledPolicies, mesh: Mesh,
                 axis: str = "data", explain: bool = False):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported by kernel: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.mesh = mesh
        self.axis = axis
        self.explain = bool(explain)
        self.explain_strides = (compiled.KP, compiled.KR)
        self._explain_kw = {"explain": True} if explain else {}
        self.n_devices = mesh.shape[axis]
        self.device = mesh.device
        self.with_hr = tree_needs_hr(compiled.arrays)
        self.with_rel = tree_needs_rel(compiled.arrays)
        self._c = tables_from_numpy(compiled.arrays, self.device,
                                    keys=TABLE_ARRAYS,
                                    optional=(ORIG_TABLE,))

    def evaluate(self, batch: RequestBatch):
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch: RequestBatch):
        """Launch this rank's slice and gather the outputs; returns the
        thunk that materializes (decision, cacheable, status, and the
        provenance codes in explain mode) numpy [B] for the whole
        batch."""
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        b, r = row_slice(batch, self.device, ROW_ARRAYS, self.n_devices,
                         self.mesh.coords[self.axis])
        out = decide_dense(self._c, r, with_acl, self.with_hr, self.with_rel,
                           **self._explain_kw)
        return readback(all_gather_cols(out, self.mesh, self.axis), b)
