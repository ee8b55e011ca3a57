"""CNN gradient debug outputs: --cnn_outputxyz / --cnn_outputdx /
--cnn_gradient_check.

Counterpart of the JAX package's gnina_tpu/models/debug_out.py (reference
surface: main.cpp:1007,1030-1033; in the reference's torch-only build
outputxyz forces gradient computation, cnn_torch_scorer.cpp:164, and the
caffe-era writers are gone, so these implement the documented intent):
the per-atom CNN gradient as .xyz, the loss gradient with respect to the
voxel grid as per-channel .dx, and a finite-difference check of the
analytic atom gradient.  Gradients come from torch.autograd through the
scorer's voxelizer and networks; write_dx is this package's own copy of
the OpenDX writer of the JAX package's gninagrid tool.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnina_tpu_torch.constants import smina_type_to_element_name
from gnina_tpu_torch.models.scorer import _pose_from_outputs
from gnina_tpu_torch.ops.voxelize import voxelize


def _elements(types) -> List[str]:
    return [smina_type_to_element_name(int(t)) for t in np.asarray(types)]


def write_gradient_xyz(path: str, types, coords, grads) -> None:
    """XYZ with the gradient in the comment-free extra columns
    (`El x y z gx gy gz` rows, like the caffe-era ouput_xyz)."""
    coords = np.asarray(coords)
    grads = np.asarray(grads)
    els = _elements(types)
    with open(path, "w") as f:
        f.write(f"{len(els)}\n")
        f.write("CNN gradient (kcal/mol/A per coordinate)\n")
        for el, c, g in zip(els, coords, grads):
            f.write(f"{el:2s} {c[0]:12.5f} {c[1]:12.5f} {c[2]:12.5f} "
                    f"{g[0]:12.6f} {g[1]:12.6f} {g[2]:12.6f}\n")


def write_dx(path: str, grid3: np.ndarray, center, resolution: float):
    """Single-channel OpenDX output (libmolgrid write_dx)."""
    n = grid3.shape[0]
    origin = np.asarray(center) - resolution * (n - 1) / 2.0
    with open(path, "w") as f:
        f.write(f"object 1 class gridpositions counts {n} {n} {n}\n")
        f.write(f"origin {origin[0]:.5f} {origin[1]:.5f} {origin[2]:.5f}\n")
        f.write(f"delta {resolution:.5f} 0 0\n")
        f.write(f"delta 0 {resolution:.5f} 0\n")
        f.write(f"delta 0 0 {resolution:.5f}\n")
        f.write(f"object 2 class gridconnections counts {n} {n} {n}\n")
        f.write(f"object 3 class array type double rank 0 items {n**3} "
                "data follows\n")
        flat = grid3.ravel()
        for i in range(0, len(flat), 3):
            f.write(" ".join(f"{v:.5f}" for v in flat[i:i + 3]) + "\n")


def _ligand_loss(scorer, rec_coords, rec_types, rec_mask, lig, center):
    """loss(lig_xyz (N, 3)) -> the ensemble's CNN loss of one pose, the
    receptor and the ligand voxelized together at a fixed centre."""
    dev = scorer.device
    generic = scorer.make_loss_fn_generic(rec_coords, rec_types, rec_mask)
    lig_types = torch.as_tensor(np.asarray(lig.types), device=dev)
    center = torch.as_tensor(np.asarray(center, np.float32), device=dev)

    def loss(xyz):
        mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=dev)
        return generic(xyz[None], lig_types, mask, center[None])[0]

    return loss


def atom_gradients(scorer, rec_coords, rec_types, rec_mask,
                   lig, coords, center):
    """(lig_grad (N,3), rec_grad (K,3)): d(ensemble loss)/d coords."""
    dev = scorer.device
    lig_xyz = torch.tensor(np.asarray(coords, np.float32), device=dev,
                           requires_grad=True)
    rec_xyz = torch.tensor(np.asarray(rec_coords, np.float32), device=dev,
                           requires_grad=True)
    with torch.enable_grad():
        loss = _ligand_loss(scorer, rec_xyz, rec_types, rec_mask, lig,
                            center)(lig_xyz)
        lg, rg = torch.autograd.grad(loss, (lig_xyz, rec_xyz))
    return lg.cpu().numpy(), rg.cpu().numpy()


def write_grid_gradient_dx(prefix: str, scorer, rec_coords, rec_types,
                           rec_mask, lig, coords, center, log=None) -> list:
    """Per-channel .dx files of d(loss)/d(voxel) for the FIRST model in
    the ensemble (--cnn_outputdx)."""
    dev = scorer.device
    m = scorer.models[0]
    t = lambda a, **kw: torch.as_tensor(np.asarray(a), device=dev, **kw)
    rec_types, lig_types = t(rec_types).long(), t(lig.types).long()
    nrec = m.rec_typer.num_channels
    lig_raw = t(m.lig_typer.table)[lig_types]
    channels = torch.cat([t(m.rec_typer.table)[rec_types],
                          torch.where(lig_raw >= 0, lig_raw + nrec, -1)])
    radii = torch.cat([t(m.rec_typer.radii, dtype=torch.float32)[rec_types],
                       t(m.lig_typer.radii, dtype=torch.float32)[lig_types]])
    mask = torch.cat([t(rec_mask).bool(),
                      torch.ones(len(lig_types), dtype=torch.bool,
                                 device=dev)])
    allc = torch.cat([t(rec_coords, dtype=torch.float32),
                      t(coords, dtype=torch.float32)])
    with torch.no_grad():
        grid = voxelize(allc, channels, radii, mask,
                        t(center, dtype=torch.float32),
                        num_channels=m.num_channels, npoints=m.grid_points,
                        resolution=m.resolution, radius_scale=m.radius_scale)
    grid.requires_grad_(True)
    with torch.enable_grad():
        loss = _pose_from_outputs(m, m.module(grid[None]))[2][0]
        (ggrad,) = torch.autograd.grad(loss, grid)
    ggrad = ggrad.cpu().numpy()
    names = (list(m.rec_typer.channel_names)
             + [f"lig_{c}" for c in m.lig_typer.channel_names])
    written = []
    for ci in range(ggrad.shape[0]):
        path = f"{prefix}_grad_{names[ci]}.dx"
        write_dx(path, ggrad[ci], np.asarray(center), m.resolution)
        written.append(path)
    if log is not None:
        log.write(f"Wrote {len(written)} grid-gradient .dx files "
                  f"({prefix}_grad_*.dx)\n")
    return written


def gradient_check(scorer, rec_coords, rec_types, rec_mask, lig, coords,
                   center, log, n_atoms: int = 3, eps: float = 1e-2) -> float:
    """Central finite-difference check of the analytic ligand-coordinate
    gradient (--cnn_gradient_check).  Prints and returns the max relative
    error over the first n_atoms atoms x 3 axes."""
    dev = scorer.device
    loss = _ligand_loss(scorer, rec_coords, rec_types, rec_mask, lig, center)
    x0 = torch.tensor(np.asarray(coords, np.float32), device=dev,
                      requires_grad=True)
    with torch.enable_grad():
        (ana,) = torch.autograd.grad(loss(x0), x0)
    ana = ana.cpu().numpy()
    x0 = x0.detach()
    worst = 0.0
    with torch.no_grad():
        for i in range(min(n_atoms, len(coords))):
            for ax in range(3):
                d = torch.zeros_like(x0)
                d[i, ax] = eps
                fp = float(loss(x0 + d))
                fm = float(loss(x0 - d))
                num = (fp - fm) / (2 * eps)
                denom = max(abs(num), abs(float(ana[i, ax])), 1e-6)
                rel = abs(num - float(ana[i, ax])) / denom
                worst = max(worst, rel)
                log.write(f"gradient_check atom {i} axis {ax}: analytic "
                          f"{float(ana[i, ax]):+.6f} numeric {num:+.6f} "
                          f"rel {rel:.3e}\n")
    log.write(f"gradient_check max relative error: {worst:.3e}\n")
    return worst
