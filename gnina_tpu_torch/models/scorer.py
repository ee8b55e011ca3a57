"""CNN ensemble scoring of poses (CNNTorchScorer equivalent).

reference: gninasrc/lib/cnn_torch_scorer.cpp:105-232, torch_model.cpp:153-224.
Counterpart of the JAX package's gnina_tpu/models/scorer.py:
- poses are scored in BATCHES: one voxelization + one conv3d forward per
  (model-group, rotation) over all poses of a chunk at once;
- models sharing the same typer/grid settings share voxelized grids;
- the receptor and the ligand are voxelized apart and added (densities are
  additive and their channel ranges disjoint), the receptor through the
  x-sorted per-slab atom window; on a card outside autograd both come
  from one launch of the CUDA voxeliser (ops/voxelize.voxelize_cuda),
  which writes the grids once in the layout the convolutions read;
- the CNN losses as minimisation objectives (make_loss_fn*) take a batch of
  poses with a grid centre each, where the JAX functions take one pose and
  are vmapped; their gradients with respect to the atom coordinates come
  from autograd through the voxelizer and the network.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnina_tpu_torch import trace
from gnina_tpu_torch.chem.ingest import Receptor
from gnina_tpu_torch.chem.tree_build import LigandStruct
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.models.registry import CNNModel, expand_model_names, \
    load_model
from gnina_tpu_torch.ops.quat import quaternion_to_matrix, random_orientation
from gnina_tpu_torch.ops.voxelize import kernel_applies, slab_window_size, \
    voxelize_batch, voxelize_cuda, voxelize_windowed

# pose-axis chunk of the batched rescore: bounds the voxelizer's (poses,
# grid-slab, atoms) intermediate and keeps one forward shape
MAX_POSE_BATCH = 128


def _pose_from_outputs(model: CNNModel, outputs):
    out0 = outputs[0]  # (B,2): log-probs for standard models
    if model.skip_softmax:
        pose = out0[:, 1]
    else:
        pose = torch.softmax(out0, dim=1)[:, 1]
    affinity = outputs[1] if len(outputs) > 1 else torch.zeros_like(pose)
    if affinity.dim() == 0:
        affinity = affinity[None]
    if model.apply_logistic_loss:
        loss = -torch.log(torch.clamp(out0[:, 1], min=1e-30))
    else:
        # torch cross_entropy applies log_softmax to its input; the model
        # output is already log_softmax-ed, so the reference effectively
        # double-normalizes (torch_model.cpp:196) — reproduce exactly.
        loss = -torch.log_softmax(out0, dim=1)[:, 1]
    return pose, affinity, loss


def _rec_typing(m0: CNNModel, rec_types):
    """Receptor atoms' (channels, radii) under m0's receptor typer."""
    dev = rec_types.device
    return (torch.as_tensor(m0.rec_typer.table, device=dev)[rec_types],
            torch.as_tensor(m0.rec_typer.radii, dtype=torch.float32,
                            device=dev)[rec_types])


def _lig_typing(m0: CNNModel, lig_types):
    """Ligand atoms' (channels after the receptor's, radii) under m0's
    ligand typer; channel -1 (untyped) stays -1."""
    dev = lig_types.device
    raw = torch.as_tensor(m0.lig_typer.table, device=dev)[lig_types]
    chan = torch.where(raw >= 0, raw + m0.rec_typer.num_channels, -1)
    return chan, torch.as_tensor(m0.lig_typer.radii, dtype=torch.float32,
                                 device=dev)[lig_types]


def _grid_kw(m0: CNNModel):
    return dict(num_channels=m0.num_channels, npoints=m0.grid_points,
                resolution=m0.resolution, radius_scale=m0.radius_scale)


class CNNScorer:
    """Scores ligand poses against a rigid receptor with a CNN ensemble.

    model_names: registry names or ensemble shorthands (None: the default
    three-model ensemble); models: ready CNNModel objects instead.  device
    None means the card."""

    def __init__(self, model_names: Optional[Sequence[str]] = None,
                 rotations: int = 0, seed: int = 0,
                 center: Optional[np.ndarray] = None, device=None,
                 models: Optional[Sequence[CNNModel]] = None,
                 models_dir: Optional[str] = None, verbose: bool = False):
        self.device = resolve_device(device)
        if models is not None:
            self.models: List[CNNModel] = list(models)
        else:
            names = expand_model_names(list(model_names or []))
            trace.count("cnn.loads", len(names))
            self.models = [load_model(n, device=self.device,
                                      models_dir=models_dir) for n in names]
        self.rotations = max(rotations, 1)
        self.seed = seed
        self.fixed_center = center
        self.verbose = verbose      # --cnn_verbose: kept, as in JAX, unused

    # -- host-side preparation ------------------------------------------------

    def _receptor_arrays(self, rec: Receptor, centers: np.ndarray):
        """Prune receptor to the union of pose grid boxes and pad."""
        max_dim = max(m.dimension for m in self.models)
        margin = max_dim / 2 + 4.0
        lo = centers.min(axis=0) - margin
        hi = centers.max(axis=0) + margin
        keep = np.all((rec.coords >= lo) & (rec.coords <= hi), axis=1)
        coords = rec.coords[keep]
        types = rec.types[keep]
        k = max(((len(types) + 255) // 256) * 256, 256)
        pad = k - len(types)
        return (np.pad(coords, ((0, pad), (0, 0))).astype(np.float32),
                np.pad(types, (0, pad)).astype(np.int64),
                np.pad(np.ones(len(types), bool), (0, pad)))

    # -- main scoring ----------------------------------------------------------

    def score_poses(self, rec: Receptor, lig: LigandStruct,
                    coords_batch: np.ndarray):
        """Score (B,N,3) ligand pose coordinates.

        Returns (score (B,), affinity (B,), loss (B,), variance (B,)).
        """
        coords_batch = np.asarray(coords_batch, np.float32)
        if coords_batch.ndim == 2:
            coords_batch = coords_batch[None]
        return self.score_poses_multi(rec, [(lig, coords_batch)])[0]

    def prepare_multi(self, rec: Receptor, items):
        """The padded arrays of one score_poses_multi call, on the host:
        dict(coords (Bp, Np, 3), types, mask, centers, sizes, b, bp, rec
        (coords, types, mask) sorted by x, win)."""
        sizes = [np.asarray(c).shape[0] for _l, c in items]
        n_atoms_max = max(np.asarray(c).shape[1] for _l, c in items)
        np_pad = ((n_atoms_max + 7) // 8) * 8
        b = sum(sizes)
        coords_p = np.zeros((b, np_pad, 3), np.float32)
        types_p = np.zeros((b, np_pad), np.int64)
        mask_p = np.zeros((b, np_pad), bool)
        centers = np.zeros((b, 3), np.float32)
        off = 0
        for (lig, cb), bi in zip(items, sizes):
            cb = np.asarray(cb, np.float32)
            ni = cb.shape[1]
            coords_p[off:off + bi, :ni] = cb
            types_p[off:off + bi, :ni] = lig.types[:ni]
            mask_p[off:off + bi, :ni] = True
            if self.fixed_center is not None:
                centers[off:off + bi] = np.asarray(self.fixed_center,
                                                   np.float32)
            else:
                # grid center per pose: mean over all ligand atoms
                # (libmolgrid CoordinateSet::center, hydrogens included)
                centers[off:off + bi] = cb.mean(axis=1)
            off += bi

        # the pose axis is chunked at MAX_POSE_BATCH and padded to a whole
        # number of chunks by repeating the last pose
        bp = min(1 << (b - 1).bit_length(), MAX_POSE_BATCH)
        pad_to = -b % bp
        if pad_to:
            coords_p = np.concatenate(
                [coords_p, np.tile(coords_p[-1:], (pad_to, 1, 1))])
            types_p = np.concatenate(
                [types_p, np.tile(types_p[-1:], (pad_to, 1))])
            mask_p = np.concatenate(
                [mask_p, np.tile(mask_p[-1:], (pad_to, 1))])
            centers = np.concatenate(
                [centers, np.tile(centers[-1:], (pad_to, 1))])

        rec_coords, rec_types, rec_mask = self._receptor_arrays(
            rec, centers[:b])
        # sort receptor rows by x and push masked padding to the far end:
        # the receptor is voxelized through a per-slab atom window
        # (ops/voxelize.voxelize_windowed), which needs sorted x and a
        # window width (computed here)
        sort_x = np.where(rec_mask, rec_coords[:, 0], np.float32(1e9))
        order = np.argsort(sort_x, kind="stable")
        rec_coords = rec_coords[order]
        rec_types = rec_types[order]
        rec_mask = rec_mask[order]
        max_reach = max(
            1.5 * float(np.max(m.rec_typer.radii)) * m.radius_scale
            + m.resolution for m in self.models)
        win = slab_window_size(np.where(rec_mask, rec_coords[:, 0], 1e9),
                               max_reach)
        return dict(coords=coords_p, types=types_p, mask=mask_p,
                    centers=centers, sizes=sizes, b=b, bp=bp,
                    rec=(rec_coords, rec_types, rec_mask), win=win)

    def score_poses_multi(self, rec: Receptor, items):
        """Score poses of SEVERAL (possibly different) ligands in one
        batched ensemble pass.

        items: list of (LigandStruct, (Bi, Ni, 3) pose coords).  Ligand
        atom types are per-pose data, so a whole screen batch's rescore is
        one pass per chunk of MAX_POSE_BATCH poses.  Returns a list of
        (score, affinity, loss, variance) per item, numpy arrays."""
        with trace.span("cnn.score", device=self.device):
            prep = self.prepare_multi(rec, items)
            trace.count("cnn.poses", prep["b"])
            dev = self.device
            rec_c, rec_t, rec_m = (torch.as_tensor(x, device=dev)
                                   for x in prep["rec"])
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(self.seed))
            outs = []
            bp = prep["bp"]
            with torch.no_grad():
                for c0 in range(0, prep["coords"].shape[0], bp):
                    sl = slice(c0, c0 + bp)
                    outs.append(self.ensemble_forward(
                        rec_c, rec_t, rec_m,
                        torch.as_tensor(prep["coords"][sl], device=dev),
                        torch.as_tensor(prep["types"][sl], device=dev),
                        torch.as_tensor(prep["mask"][sl], device=dev),
                        torch.as_tensor(prep["centers"][sl], device=dev),
                        prep["win"], gen))
            score, affinity, loss, variance = (
                torch.cat([o[i] for o in outs]).cpu().numpy()
                for i in range(4))
            out = []
            off = 0
            for bi in prep["sizes"]:
                out.append((score[off:off + bi], affinity[off:off + bi],
                            loss[off:off + bi], variance[off:off + bi]))
                off += bi
            return out

    def score_pose(self, rec: Receptor, lig: LigandStruct, coords: np.ndarray
                   ) -> Tuple[float, float, float]:
        """Single pose -> (score, affinity, variance); DLScorer::score shape."""
        s, a, _l, v = self.score_poses(rec, lig, coords[None])
        return float(s[0]), float(a[0]), float(v[0])

    # -- CNN as minimization objective (non_cache_cnn equivalent) ---------------

    def _group_losses(self, ids, grids):
        """Sum over the models `ids` of one voxelization group of their
        (B,) losses on the grids."""
        total = 0.0
        for mi in ids:
            m = self.models[mi]
            total = total + _pose_from_outputs(m, m.module(grids))[2]
        return total

    def _lig_inputs(self, lig_types, lig_mask, b: int):
        dev = self.device
        lig_types = torch.as_tensor(lig_types, device=dev).long()
        lig_mask = torch.as_tensor(lig_mask, device=dev)
        return (lig_types.expand(b, lig_types.shape[-1]),
                lig_mask.expand(b, lig_mask.shape[-1]))

    def make_loss_fn_generic(self, rec_coords, rec_types, rec_mask):
        """Returns loss(lig_coords (B, N, 3), lig_types (N,) or (B, N),
        lig_mask likewise, centers (B, 3)) -> (B,) mean CNN loss over the
        ensemble, the receptor and the ligand voxelized together.

        The grid centre is an argument: during BFGS refinement it is FIXED
        at the value set at refinement start (DLScorer::
        set_center_from_model + non_cache_cnn::adjust_center), while
        Metropolis evaluations re-centre on the current pose every call.
        Differentiable with respect to lig_coords, and to rec_coords when
        it is a tensor that requires grad (the reference's gmaker.backward
        + loss.backward chain, torch_model.cpp:200-221)."""
        dev = self.device
        rec_c = torch.as_tensor(rec_coords, dtype=torch.float32, device=dev)
        rec_t = torch.as_tensor(rec_types, device=dev).long()
        rec_m = torch.as_tensor(rec_mask, device=dev)
        groups = self._groups()

        def loss_fn(lig_coords, lig_types, lig_mask, centers):
            b = lig_coords.shape[0]
            lig_t, lig_m = self._lig_inputs(lig_types, lig_mask, b)
            total = 0.0
            for ids in groups:
                grids = self.voxelize_group(
                    self.models[ids[0]], rec_c, rec_t, rec_m, lig_coords,
                    lig_t, lig_m, centers, win=0)
                total = total + self._group_losses(ids, grids)
            return total / len(self.models)

        return loss_fn

    def make_loss_fn_split(self, rec_coords, rec_types, rec_mask):
        """Receptor/ligand-split variant of make_loss_fn_generic.

        Returns (prep, loss_fn):
          prep(centers (B, 3)) -> tuple of (B, C, n, n, n) RECEPTOR density
            grids, one per voxelization group (_groups), ligand channels
            zero; no gradient;
          loss_fn(rec_grids, lig_coords (B, N, 3), lig_types, lig_mask,
            centers) -> (B,) mean CNN loss, voxelizing ONLY the ligand
            atoms and adding the prepared receptor grids.

        Gaussian densities are additive and the rec/lig channel ranges are
        disjoint (torch_model.cpp:16-46 channel maps), so grid(rec+lig) ==
        grid(rec) + grid(lig).  The receptor is rigid and the grid centre is
        fixed for one BFGS refinement (non_cache_cnn::adjust_center), so
        the receptor grid is prepared once per refinement.  The receptor
        goes through the x-sorted per-slab window (voxelize_windowed);
        masked rows are dropped first, as they add nothing."""
        dev = self.device
        rc, rt, rm = (np.asarray(x.detach().cpu() if torch.is_tensor(x)
                                 else x) for x in (rec_coords, rec_types,
                                                   rec_mask))
        rm = rm.astype(bool)
        order = np.argsort(rc[rm][:, 0], kind="stable")
        rc = np.asarray(rc[rm][order], np.float32)
        rt = np.asarray(rt[rm][order], np.int64)
        max_reach = max(
            1.5 * float(np.max(m.rec_typer.radii)) * m.radius_scale
            + m.resolution for m in self.models)
        win = slab_window_size(rc[:, 0], max_reach)
        rec_c = torch.as_tensor(rc, device=dev)
        rec_t = torch.as_tensor(rt, device=dev)
        rec_m = torch.ones(len(rt), dtype=torch.bool, device=dev)
        groups = self._groups()

        def prep(centers):
            centers = centers.detach()
            grids = []
            with torch.no_grad():
                for ids in groups:
                    m0 = self.models[ids[0]]
                    if len(rt):
                        grids.append(self.receptor_grids(
                            m0, rec_c, rec_t, rec_m, centers, win))
                    else:
                        n = m0.grid_points
                        grids.append(torch.zeros(
                            (centers.shape[0], m0.num_channels, n, n, n),
                            device=dev))
            return tuple(grids)

        def loss_fn(rec_grids, lig_coords, lig_types, lig_mask, centers):
            b = lig_coords.shape[0]
            lig_t, lig_m = self._lig_inputs(lig_types, lig_mask, b)
            total = 0.0
            for ids, rec_g in zip(groups, rec_grids):
                grids = rec_g + self.ligand_grids(
                    self.models[ids[0]], lig_coords, lig_t, lig_m, centers)
                total = total + self._group_losses(ids, grids)
            return total / len(self.models)

        return prep, loss_fn

    def make_loss_fn(self, rec_coords, rec_types, rec_mask, lig_types):
        """Per-ligand convenience wrapper over make_loss_fn_generic."""
        generic = self.make_loss_fn_generic(rec_coords, rec_types, rec_mask)

        def loss_fn(lig_coords, lig_mask, centers):
            return generic(lig_coords, lig_types, lig_mask, centers)

        return loss_fn

    @property
    def max_dimension(self) -> float:
        return max(m.dimension for m in self.models)

    # -- the ensemble program ---------------------------------------------------

    def _groups(self):
        """Model indices grouped by voxelization settings."""
        groups = {}
        for mi, m in enumerate(self.models):
            gkey = (m.rec_typer.num_channels, m.lig_typer.num_channels,
                    m.resolution, m.dimension, m.radius_scale,
                    tuple(m.rec_typer.table), tuple(m.lig_typer.table))
            groups.setdefault(gkey, []).append(mi)
        return list(groups.values())

    def voxelize_group(self, m0: CNNModel, rec_coords, rec_types, rec_mask,
                       lig_coords_b, lig_types_b, lig_mask_b, centers,
                       win: int, rotation=None):
        """(B, C, n, n, n) grids of one pose chunk under model m0's
        voxelization settings.  rotation None: the receptor through the
        x-sorted window (when win) plus the ligand, in one launch of the
        CUDA voxeliser on a card outside autograd; else (B, 3, 3)
        matrices that turn each complex about its grid center, everything
        through the plain voxelizer."""
        with trace.span("cnn.voxelize", device=centers.device):
            if rotation is None and win:
                if kernel_applies(centers):
                    rec_chan, rec_radii = _rec_typing(m0, rec_types)
                    lig_chan, lig_radii = _lig_typing(m0, lig_types_b)
                    return voxelize_cuda(
                        rec_coords, rec_chan, rec_radii, rec_mask, centers,
                        ligand=(lig_coords_b, lig_chan, lig_radii,
                                lig_mask_b), **_grid_kw(m0))
                return (self.receptor_grids(m0, rec_coords, rec_types,
                                            rec_mask, centers, win)
                        + self.ligand_grids(m0, lig_coords_b, lig_types_b,
                                            lig_mask_b, centers))
            rec_chan, rec_radii = _rec_typing(m0, rec_types)
            lig_chan, lig_radii = _lig_typing(m0, lig_types_b)
            kw = _grid_kw(m0)
            b = centers.shape[0]
            rec_xyz = rec_coords[None].expand(b, -1, -1)
            lig_xyz = lig_coords_b
            if rotation is not None:
                c = centers[:, None]
                rt = rotation.transpose(1, 2)
                rec_xyz = torch.bmm(rec_xyz - c, rt) + c
                lig_xyz = torch.bmm(lig_xyz - c, rt) + c
            k = rec_coords.shape[0]
            return voxelize_batch(
                torch.cat([rec_xyz, lig_xyz], 1),
                torch.cat([rec_chan[None].expand(b, k), lig_chan], 1),
                torch.cat([rec_radii[None].expand(b, k), lig_radii], 1),
                torch.cat([rec_mask[None].expand(b, k), lig_mask_b], 1),
                centers, **kw)

    @staticmethod
    def receptor_grids(m0: CNNModel, rec_coords, rec_types, rec_mask,
                       centers, win: int):
        """(B, C, n, n, n) grids of the receptor alone (sorted by x) at B
        centers through the per-slab window, under m0's settings; on a
        card outside autograd, one launch of the CUDA voxeliser."""
        rec_chan, rec_radii = _rec_typing(m0, rec_types)
        if kernel_applies(centers):
            return voxelize_cuda(rec_coords, rec_chan, rec_radii, rec_mask,
                                 centers, **_grid_kw(m0))
        return voxelize_windowed(rec_coords, rec_chan, rec_radii, rec_mask,
                                 centers, window=win, **_grid_kw(m0))

    @staticmethod
    def ligand_grids(m0: CNNModel, lig_coords_b, lig_types_b, lig_mask_b,
                     centers):
        """(B, C, n, n, n) grids of B ligand poses alone (their channels
        after the receptor's), under m0's settings."""
        lig_chan, lig_radii = _lig_typing(m0, lig_types_b)
        return voxelize_batch(lig_coords_b, lig_chan, lig_radii, lig_mask_b,
                              centers, **_grid_kw(m0))

    def ensemble_forward(self, rec_coords, rec_types, rec_mask, lig_coords_b,
                         lig_types_b, lig_mask_b, centers, win: int,
                         generator: torch.Generator):
        """One pose chunk through every (model group, rotation): returns
        (score, affinity, loss, variance), each (B,); the variance is over
        models x rotations.  Rotation 0 is the identity; the others draw
        one random orientation per pose from `generator`, which lives on
        the tensors' device."""
        with trace.span("cnn.forward", device=centers.device):
            b = lig_coords_b.shape[0]
            dev = centers.device
            scores, affinities, losses = [], [], []
            for model_ids in self._groups():
                m0 = self.models[model_ids[0]]
                for r in range(self.rotations):
                    rot = None
                    if r > 0:
                        rot = quaternion_to_matrix(
                            random_orientation((b,), generator, dev))
                    grids = self.voxelize_group(
                        m0, rec_coords, rec_types, rec_mask, lig_coords_b,
                        lig_types_b, lig_mask_b, centers, win, rot)
                    for mi in model_ids:
                        m = self.models[mi]
                        pose, aff, loss = _pose_from_outputs(
                            m, m.module(grids))
                        scores.append(pose)
                        affinities.append(aff)
                        losses.append(loss)
            score = torch.mean(torch.stack(scores), dim=0)
            affs = torch.stack(affinities)       # (M*R, B)
            affinity = torch.mean(affs, dim=0)
            loss = torch.mean(torch.stack(losses), dim=0)
            if affs.shape[0] > 1:
                variance = torch.mean((affs - affinity[None]) ** 2, dim=0)
            else:
                variance = torch.zeros_like(affinity)
            return score, affinity, loss, variance
