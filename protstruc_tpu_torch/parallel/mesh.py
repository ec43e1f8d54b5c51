"""Process groups, device meshes and StructureBatch sharding (port of
``protstruc_tpu/parallel/mesh.py``).

Axes, as in the JAX package:

* ``dp``: data parallel over the structure batch B;
* ``sp``: sequence parallel over the residue axis L (pair maps shard their
  first residue axis; the j side is gathered, ``L * A * 3`` floats);
* ``tp``: tensor parallel over hidden and head dims (used by the models).

The JAX package names devices in a ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives; here a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of an initialised process group (one rank a card), and each
function works on THIS rank's blocks and issues its collectives by hand.
:func:`init_distributed` starts the group: NCCL for CUDA, gloo for the CPU,
never gloo on a card.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "make_mesh", "make_multislice_mesh", "batch_pspecs",
           "shard_batch", "featurize_sharded", "mesh_coords", "ModelShard", "UNSHARDED",
           "model_shard", "shard_feats", "cut", "cut_params"]

#: How long a collective may wait before the group gives up (a hung peer
#: fails the run rather than holding it).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None, store=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Initialise the default process group for ``device`` and return the
    rank's device: NCCL and ``cuda:LOCAL_RANK`` for a CUDA device, gloo and
    the CPU for a CPU device.  ``rank``/``world_size`` default to the
    ``RANK``/``WORLD_SIZE`` environment (``torchrun``); ``store`` (e.g. a
    ``FileStore``) replaces the ``env://`` rendezvous.  An initialised group
    is kept if its backend fits the device, and refused if not."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA process group needs a card; pass device='cpu' for gloo")
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have}, but {dev.type} tensors need "
                               f"{backend}")
        rank = dist.get_rank()
    else:
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if dev.type == "cuda":  # one card a rank: LOCAL_RANK under torchrun
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = dict(backend=backend, rank=rank, world_size=world_size, timeout=timeout)
        if dev.type == "cuda":
            kw["device_id"] = dev
        if store is not None:
            kw["store"] = store
        elif "MASTER_ADDR" not in os.environ:
            if world_size != 1:
                raise RuntimeError("no rendezvous: run under torchrun (MASTER_ADDR, MASTER_PORT) "
                                   "or pass a store")
            kw["store"] = dist.HashStore()
        dist.init_process_group(**kw)
    return dev


def _factor3(n: int) -> Tuple[int, int, int]:
    """Factor n ranks into (dp, sp, tp) with dp >= sp >= tp: powers of two
    split their exponent about evenly, the surplus to dp (8 -> 2x2x2, 4 ->
    2x2x1, 16 -> 4x2x2); other counts are pure data parallelism."""
    if n & (n - 1):
        return (n, 1, 1)
    k = n.bit_length() - 1
    k_tp = k // 3
    k_sp = (k - k_tp) // 2
    return (1 << (k - k_tp - k_sp), 1 << k_sp, 1 << k_tp)


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_distributed)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_shapes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "sp", "tp")):
    """A ``DeviceMesh`` over every rank of the process group with dims
    ``axis_names``: ``axis_shapes`` fixes the factorization, e.g. ``(2, 2,
    1)``, else :func:`_factor3`.  ``n_devices``, when given, must be the
    world size (a rank is a device)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev_type = _device_type()
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices} but the process group has {n} ranks")
    shape = _factor3(n) if axis_shapes is None else tuple(int(a) for a in axis_shapes)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"axis shapes {tuple(shape)} != {n} devices")
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axis_names))


def make_multislice_mesh(n_slices: int, axis_shapes: Optional[Sequence[int]] = None,
                         axis_names: Sequence[str] = ("dcn", "dp", "sp", "tp")):
    """A mesh with a leading ``dcn`` data axis over ``n_slices`` groups of
    consecutive ranks (hosts), each factored ``(dp, sp, tp)``: only the batch
    axis crosses between groups."""
    from torch.distributed.device_mesh import DeviceMesh

    dev_type = _device_type()
    n = dist.get_world_size()
    if n_slices < 1 or n % n_slices:
        raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    per = n // n_slices
    shape = _factor3(per) if axis_shapes is None else tuple(int(a) for a in axis_shapes)
    if math.prod(shape) != per:
        raise ValueError(f"axis shapes {tuple(shape)} != {per} devices/slice")
    return DeviceMesh(dev_type, torch.arange(n).reshape((n_slices,) + shape),
                      mesh_dim_names=tuple(axis_names))


def mesh_coords(mesh, name: Optional[str]) -> Tuple[int, int]:
    """``(index, size)`` of this rank along mesh dim ``name``; ``(0, 1)``
    where the mesh has no such dim (or ``name`` is None)."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 0, 1
    return mesh.get_local_rank(name), mesh.size(names.index(name))


def _data_axes(mesh) -> Tuple[str, ...]:
    return ("dcn", "dp") if "dcn" in (mesh.mesh_dim_names or ()) else ("dp",)


def _data_coords(mesh) -> Tuple[int, int]:
    """This rank's index and the count along the (merged) data axes."""
    idx, size = 0, 1
    for a in _data_axes(mesh):
        i, n = mesh_coords(mesh, a)
        idx, size = idx * n + i, size * n
    return idx, size


def batch_pspecs(data_axes: Sequence[str] = ("dp",)) -> Dict[str, tuple]:
    """How each array field of a StructureBatch is split: per axis, the mesh
    dims it shards over (B over the data axes merged, L over sp)."""
    b = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return {"xyz": (b, "sp", None, None), "atom_mask": (b, "sp", None),
            "chain_idx": (b, "sp"), "residue_idx": (b, "sp"), "mu": (b, None),
            "std": (b, None)}


def shard_batch(batch, mesh, axes: Sequence[str] = ("dp", "sp")):
    """This rank's ``(B / dp, L / sp)`` block of a (global) StructureBatch.

    B must divide by the data axes (``dcn`` x ``dp`` on a multi-slice mesh)
    and L by ``sp`` (pad to a bucket first, ``utils/buckets.py``).  ``mu`` and
    ``std`` split along B; the host metadata (``chain_ids``, ``seq``) keeps
    this rank's structures whole.  ``axes`` names the cuts to make: ``("dp",)``
    keeps every residue, ``("sp",)`` every structure.
    """
    bi, nb = _data_coords(mesh) if "dp" in axes else (0, 1)
    si, ns = mesh_coords(mesh, "sp") if "sp" in axes else (0, 1)
    B, L = batch.batch_size, batch.n_residues
    if B % nb or L % ns:
        raise ValueError(f"batch (B={B}, L={L}) does not split over data axes {nb} and sp {ns}")
    b = slice(bi * B // nb, (bi + 1) * B // nb)
    l = slice(si * L // ns, (si + 1) * L // ns)

    def cut(name, x):
        if x is None:
            return None
        spec = batch_pspecs(_data_axes(mesh))[name]
        return x[b, l] if spec[1] == "sp" else x[b]

    meta = {k: (None if getattr(batch, k) is None else getattr(batch, k)[b])
            for k in ("chain_ids", "seq")}
    return batch.replace(**{k: cut(k, getattr(batch, k)) for k in
                            ("xyz", "atom_mask", "chain_idx", "residue_idx", "mu", "std")},
                         **meta)


def _gather_sp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (B, L/sp, ...) gathered along dim 1 over the sp group (a group
    of one rank gathers too; a mesh without an sp dim has nothing to gather)."""
    if "sp" not in (mesh.mesh_dim_names or ()):
        return x
    _, ns = mesh_coords(mesh, "sp")
    parts = [torch.empty_like(x) for _ in range(ns)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("sp"))
    return torch.cat(parts, dim=1)


_MASK_ATOMS = {"d_ca_mask": ("CA", "CA"), "d_cb_mask": ("CB", "CB"), "d_no_mask": ("N", "O")}


def featurize_sharded(batch, mesh, use_kernel: bool = True):
    """The featurization of this rank's block ``batch`` (from
    :func:`shard_batch`): ``(maps, dihedrals, dihedral_mask, frames)``, the
    9-key inter-residue geometry dict of the local rows against every
    column, ``(B/dp, L/sp, L)``, and the local rows' backbone dihedrals,
    their mask ``(B/dp, L/sp, 3)`` and frames ``(B/dp, L/sp, 3, 3)``.

    Each rank all-gathers the j-side atoms, atom mask and chain index over
    ``sp`` (``L * A * 3`` floats).  ``use_kernel=True`` runs K1's rectangular
    mode on the local rows against the gathered columns (its plain version
    on CPU tensors) and builds the three masks from local rows x gathered
    columns; ``use_kernel=False`` is the plain path, the arccos-form
    geometry of the gathered batch cut to the local rows (the JAX package's
    pjit path).  The dihedrals read the neighbours across the block edges
    from the gathered atoms.  The JAX package returns global sharded
    arrays; here each rank holds its blocks.
    """
    from protstruc_tpu_torch import geometry as geom
    from protstruc_tpu_torch.batch import _backbone_dihedrals, _inter_residue_geometry
    from protstruc_tpu_torch.ops.pair_maps import pairwise_maps_forward
    from protstruc_tpu_torch.vocab import ATOM

    si, ns = mesh_coords(mesh, "sp")
    Lq = batch.n_residues
    rows = slice(si * Lq, (si + 1) * Lq)
    xyz_full = _gather_sp(batch.xyz, mesh)
    am_full = _gather_sp(batch.atom_mask.to(torch.uint8), mesh).bool()
    ci_full = _gather_sp(batch.chain_idx, mesh)
    if use_kernel:
        maps = dict(pairwise_maps_forward(batch.xyz.contiguous(), xyz_j=xyz_full.contiguous()))
        for key, (ai, aj) in _MASK_ATOMS.items():
            mi = batch.atom_mask[:, :, int(ATOM[ai])]
            mj = am_full[:, :, int(ATOM[aj])]
            maps[key] = mi[:, :, None] & mj[:, None, :]
    else:
        maps = {k: v[:, rows] for k, v in _inter_residue_geometry(xyz_full, am_full).items()}
    d, m = _backbone_dihedrals(xyz_full, ci_full, am_full)
    x = batch.xyz
    frames = geom.gram_schmidt(x[:, :, 0], x[:, :, 1], x[:, :, 2])
    return maps, d[:, rows], m[:, rows], frames


# ---------------------------------------------------------------------------
# model parallelism: this rank's groups and blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in a ``(dp, sp, tp)`` mesh, for a sharded model.

    ``sp_group``/``tp_group``: this rank's sequence- and tensor-parallel
    groups (tp is the innermost mesh dim); ``dp_group``: its data-parallel
    group; ``data_group``: the dp x sp ranks of its tp coordinate, which hold
    distinct residues and structures (masked-mean counts and gradient shares
    are summed over it).  ``dp``/``sp``/``tp``: ``(index, size)`` along each
    axis.  :data:`UNSHARDED` is an unsharded model's: no groups (the
    collectives are then the identity), one rank on every axis.
    """

    mesh: Any
    dp_group: Any
    sp_group: Any
    tp_group: Any
    data_group: Any
    dp: Tuple[int, int]
    sp: Tuple[int, int]
    tp: Tuple[int, int]

    def rows(self, n_local: int) -> Tuple[int, int]:
        """``(offset, count)``: the global residue rows of this rank's block
        of ``n_local`` rows."""
        return self.sp[0] * n_local, n_local


#: The :class:`ModelShard` of a model without a mesh.
UNSHARDED = ModelShard(None, None, None, None, None, (0, 1), (0, 1), (0, 1))


def model_shard(mesh) -> ModelShard:
    """The :class:`ModelShard` of this rank on ``mesh`` (a ``(dp, sp, tp)``
    ``DeviceMesh``), built once per mesh: every rank must call it, since it
    creates the dp x sp groups."""
    cached = getattr(mesh, "_protstruc_model_shard", None)
    if cached is not None:
        return cached
    dims = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if dims != ("dp", "sp", "tp"):
        raise ValueError(f"a sharded model needs a (dp, sp, tp) mesh (parallel.mesh.make_mesh), "
                         f"got {mesh!r}")
    ranks = mesh.mesh.permute(2, 0, 1).reshape(mesh.size(2), -1).tolist()
    data_group, _ = dist.new_subgroups_by_enumeration(ranks)
    shard = ModelShard(mesh, mesh.get_group("dp"), mesh.get_group("sp"), mesh.get_group("tp"),
                       data_group, *(mesh_coords(mesh, a) for a in ("dp", "sp", "tp")))
    mesh._protstruc_model_shard = shard
    return shard


def cut(x: torch.Tensor, spec: Sequence[Optional[str]], mesh) -> torch.Tensor:
    """This rank's block of a whole tensor ``x``: dim ``d`` split over mesh
    axis ``spec[d]`` (None, or past the spec's end: kept whole), as a
    ``NamedSharding`` places it; a dim that does not divide raises
    ``ValueError``, as JAX's placement does."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        i, n = mesh_coords(mesh, axis)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split over {axis}={n}")
        x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
    return x


def cut_params(params: Dict[str, torch.Tensor], specs: Dict[str, tuple], mesh
               ) -> Dict[str, torch.Tensor]:
    """Every leaf of a whole parameter dict cut to this rank's block by its
    spec (``models.ipa.ipa_param_shardings``, ``models.moe.moe_param_shardings``)."""
    return {k: cut(v, specs.get(k, ()), mesh).contiguous() for k, v in params.items()}


def shard_feats(feats: Dict[str, torch.Tensor], mesh, axes: Sequence[str] = ("dp", "sp")
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of every feature of ``featurize_for_model``'s dict,
    cut by ``models.trfold.feats_shardings`` (B over dp, the first residue
    axis over sp) along the mesh ``axes`` named (the trainer featurizes its
    dp block whole and passes ``("sp",)``).  ``L % sp != 0`` raises
    ``ValueError``."""
    from protstruc_tpu_torch.models.trfold import feats_shardings

    specs = feats_shardings(mesh)
    out = {}
    for k, v in feats.items():
        spec = tuple(a if a in axes else None for a in specs.get(k, ()))
        out[k] = cut(v, spec, mesh)
    return out
