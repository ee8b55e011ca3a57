"""gninagrid equivalent: batch voxelizer producing .binmap / .dx / .map grids.

reference: gninasrc/gninagrid/gninagrid.cpp + molgridder.cpp.  Channel
layout and file naming follow the reference exactly:
  binmap: {out}_{i}.{N}.{nchan}.binmap with channels
          [usergrids..., rec types..., lig types...] (outputBIN)
  dx/map: {out}_{i}_{rec|lig}_{typename}.{dx|map}, empty channels skipped
  --separate: the receptor (+usergrids) binmap is written ONCE at the
          example-grid coordinate frame as {out}.{N}.{chan}.binmap and each
          ligand as lig-only {out}_{i}.{N}.{nlig}.binmap
  -g usergrid.dx files define the grid frame and ride along as channels

Counterpart of the JAX package's gnina_tpu/tools/gninagrid.py.  The grids
are voxelized on the torch device that --device names (default: the card;
--device cpu asks for the CPU); --gpu is accepted and ignored, as there.
--random_rotation draws each ligand's quaternion as the JAX tool does,
as the normal draw of shape (4,) under PRNGKey(seed + i), replayed by
ops/jax_random (threefry2x32 is a counter hash), so the rotation does not
depend on the device.  One difference: --separate with -g writes what the
file name says, the user grids followed by the receptor channels (the JAX
tool's file holds the user grids only).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gnina_tpu_torch.chem import ingest
from gnina_tpu_torch.constants import EPSILON_FL
from gnina_tpu_torch.device import device_from_flag
from gnina_tpu_torch.models.typer import ChannelTyper, default_lig_typer, \
    default_rec_typer
from gnina_tpu_torch.ops import jax_random
from gnina_tpu_torch.ops.quat import quaternion_to_matrix
from gnina_tpu_torch.ops.voxelize import slab_window_size, voxelize, \
    voxelize_windowed


def grid_channels(coords, channels, radii, center, nchan: int, npts: int,
                  resolution: float, binary: bool = False,
                  device=None) -> np.ndarray:
    """Voxelize one atom set into (nchan, npts, npts, npts) on `device`
    (None: the card).  Atoms farther from the grid's cube than their
    density reaches (1.5 radii) are dropped first: they add exact zeros.
    Densities go through the x-sorted per-slab atom window
    (ops/voxelize.voxelize_windowed, equal to voxelize up to float32
    summation order), binary occupancy through voxelize."""
    dev = device_from_flag(device)
    coords = np.asarray(coords, np.float32)
    radii = np.asarray(radii, np.float32)
    channels = np.asarray(channels, np.int64)
    half = resolution * (npts - 1) / 2.0
    gap = np.maximum(np.abs(coords - np.asarray(center, np.float32)) - half,
                     0.0)
    keep = np.sum(gap * gap, axis=1) <= (1.5 * radii) ** 2 + 1e-3
    if not keep.any():
        return np.zeros((nchan, npts, npts, npts), np.float32)
    order = np.argsort(np.where(keep, coords[:, 0], np.inf),
                       kind="stable")[:int(keep.sum())]
    t = lambda a: torch.as_tensor(a[order], device=dev)
    xyz, chan, rad = t(coords), t(channels), t(radii)
    mask = torch.ones(len(order), dtype=torch.bool, device=dev)
    c = torch.as_tensor(np.asarray(center, np.float32), device=dev)
    kw = dict(num_channels=nchan, npoints=npts, resolution=resolution)
    if binary:
        g = voxelize(xyz, chan, rad, mask, c, binary=True, **kw)
    else:
        window = slab_window_size(coords[order, 0],
                                  1.5 * float(radii[order].max()) + resolution)
        g = voxelize_windowed(xyz, chan, rad, mask, c[None], window=window,
                              **kw)[0]
    return g.cpu().numpy()


def random_rotation(seed: int) -> np.ndarray:
    """The (3, 3) rotation of --random_rotation for seed `seed`: JAX's
    random_orientation(PRNGKey(seed)), a normalised float32 normal draw of
    shape (4,) (gnina_tpu/ops/quat.py:114-120)."""
    g = jax_random.normal(jax_random.PRNGKey(seed), (4,))
    q = g / torch.sqrt(torch.clamp(torch.sum(g * g), min=EPSILON_FL))
    return quaternion_to_matrix(q).numpy()


def make_grid(rec_coords, rec_types, lig_coords, lig_types, center,
              rec_typer: ChannelTyper, lig_typer: ChannelTyper,
              resolution: float, dimension: float,
              rotation: Optional[np.ndarray] = None,
              translation: Optional[np.ndarray] = None,
              binary: bool = False, device=None) -> np.ndarray:
    """Combined rec+lig grid (rec channels first) — molgridder setGrid."""
    npts = int(round(dimension / resolution)) + 1
    nrec = rec_typer.num_channels
    nchan = nrec + lig_typer.num_channels

    rc = rec_typer.channels_for(rec_types)
    lc_raw = lig_typer.channels_for(lig_types)
    lc = np.where(lc_raw >= 0, lc_raw + nrec, -1)
    channels = np.concatenate([rc, lc]).astype(np.int32)
    radii = np.concatenate([rec_typer.radii_for(rec_types),
                            lig_typer.radii_for(lig_types)]).astype(np.float32)
    coords = np.concatenate([rec_coords, lig_coords]).astype(np.float32)
    if rotation is not None:
        coords = (coords - center) @ rotation.T + center
    if translation is not None:
        coords = coords + translation
    return grid_channels(coords, channels, radii, center, nchan, npts,
                         resolution, binary, device)


def read_dx(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    """OpenDX -> (grid (n,n,n), center, resolution)."""
    vals: List[float] = []
    n = None
    origin = np.zeros(3)
    res = 0.5
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "object" and "gridpositions" in line:
                n = int(t[5])
            elif t[0] == "origin":
                origin = np.array([float(v) for v in t[1:4]])
            elif t[0] == "delta":
                d = [float(v) for v in t[1:4]]
                res = max(d)
            elif t[0] == "object" and "array" in line:
                pass
            else:
                try:
                    vals.extend(float(v) for v in t)
                except ValueError:
                    continue
    assert n is not None, f"no grid counts in {path}"
    grid = np.array(vals[:n ** 3], np.float32).reshape(n, n, n)
    center = origin + res * (n - 1) / 2.0
    return grid, center, res


def write_binmap(path: str, grid: np.ndarray):
    """Raw float32 channel grids, C-order — the reference .binmap."""
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(grid, np.float32).tobytes())


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
        f.write(f"object 3 class array type double rank 0 items {n**3} data follows\n")
        flat = grid3.ravel()
        for i in range(0, len(flat), 3):
            f.write(" ".join(f"{v:.5f}" for v in flat[i:i + 3]) + "\n")


def write_map(path: str, grid3: np.ndarray, center, resolution: float):
    """AD4 .map output (libmolgrid write_map; golden:
    test/gninagrid/files/ccmap_*.map).  Values are z-major (x fastest)."""
    n = grid3.shape[0]
    with open(path, "w") as f:
        f.write("GRID_PARAMETER_FILE\nGRID_DATA_FILE\nMACROMOLECULE\n")
        f.write(f"SPACING {resolution:g}\n")
        f.write(f"NELEMENTS {n - 1} {n - 1} {n - 1}\n")
        f.write(f"CENTER {center[0]:g} {center[1]:g} {center[2]:g}\n")
        # AD4 map order: x fastest -> transpose from our (x,y,z) C-order
        flat = np.transpose(grid3, (2, 1, 0)).ravel()
        f.write("\n".join(f"{v:g}" for v in flat))
        f.write("\n")


def _write_channel_files(base: str, grid: np.ndarray, nuser: int,
                         rec_typer, lig_typer, center, resolution: float,
                         ext: str, separate: bool):
    """Per-channel dx/map files with reference naming; empty skipped."""
    writer = write_map if ext == "map" else write_dx
    ci = 0
    for a in range(nuser):
        # (outputDX names usergrid channels "_lig_{a}.dx"; outputMAP uses
        # "_usergrid_{a}.dx" — replicate both quirks)
        tag = f"_usergrid_{a}.dx" if ext == "map" else f"_lig_{a}.dx"
        write_dx(f"{base}{tag}", grid[ci], center, resolution)
        ci += 1
    if not separate:
        for a, name in enumerate(rec_typer.channel_names):
            if np.any(grid[ci] != 0.0):
                writer(f"{base}_rec_{name}.{ext}", grid[ci], center,
                       resolution)
            ci += 1
    for a, name in enumerate(lig_typer.channel_names):
        if np.any(grid[ci] != 0.0):
            writer(f"{base}_lig_{name}.{ext}", grid[ci], center, resolution)
        ci += 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gninagrid")
    p.add_argument("-r", "--receptor", required=True)
    p.add_argument("-l", "--ligand", required=True)
    p.add_argument("-o", "--out", required=True, help="output base name")
    p.add_argument("-g", "--grid", action="append", default=[],
                   help="user grid(s) (dx); define the coordinate frame")
    p.add_argument("--example_grid",
                   help="example dx grid for positioning with --separate")
    p.add_argument("--resolution", type=float, default=0.5)
    p.add_argument("--dimension", type=float, default=23.5)
    p.add_argument("--binary_occupancy", action="store_true")
    p.add_argument("--random_rotation", action="store_true")
    p.add_argument("--random_translate", "--random_translation",
                   dest="random_translate", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recmap", help="receptor type map file")
    p.add_argument("--ligmap", help="ligand type map file")
    p.add_argument("--dx", action="store_true", help="write .dx per channel")
    p.add_argument("--map", action="store_true",
                   help="write AD4 .map per channel")
    p.add_argument("--separate", action="store_true",
                   help="output separate rec/lig grids")
    p.add_argument("--gpu", action="store_true", help="(compat; ignored)")
    p.add_argument("--device", default=None,
                   help="torch device of the voxelizer (default: the card; "
                        "'cpu' for the CPU)")
    p.add_argument("--time", action="store_true", help="print grid times")
    args = p.parse_args(argv)

    rec_typer = (ChannelTyper(open(args.recmap).read()) if args.recmap
                 else default_rec_typer())
    lig_typer = (ChannelTyper(open(args.ligmap).read()) if args.ligmap
                 else default_lig_typer())

    resolution, dimension = args.resolution, args.dimension
    center = None
    usergrids: List[np.ndarray] = []
    for gpath in args.grid:
        g, c, res = read_dx(gpath)
        if args.random_rotation or args.random_translate:
            print("Random rotation/translation is not supported with "
                  "user grids.", file=sys.stderr)
            return 1
        if usergrids:
            if abs(res - resolution) > 1e-6 or \
                    np.abs(c - center).max() > 1e-4:
                print("Inconsistent grids", file=sys.stderr)
                return 1
        else:
            resolution, center = res, c
            dimension = res * (g.shape[0] - 1)
        usergrids.append(g)
    if args.example_grid:
        g, center, resolution = read_dx(args.example_grid)
        dimension = resolution * (g.shape[0] - 1)
    center_set = center is not None
    nuser = len(usergrids)
    npts = int(round(dimension / resolution)) + 1

    dev = device_from_flag(args.device)
    rec = ingest.Receptor.from_file(args.receptor)
    rng = np.random.RandomState(args.seed)
    nrec, nlig = rec_typer.num_channels, lig_typer.num_channels

    def rec_grid_at(c):
        rc = rec_typer.channels_for(rec.types)
        return grid_channels(rec.coords, rc, rec_typer.radii_for(rec.types),
                             c, nrec, npts, resolution,
                             args.binary_occupancy, dev)

    if args.separate:
        if not center_set:
            print("--separate specified, but no example or additional "
                  "grids specified to define coordinate system",
                  file=sys.stderr)
            return 1
        full = np.concatenate(([np.stack(usergrids)] if usergrids else [])
                              + [rec_grid_at(center)])
        write_binmap(f"{args.out}.{npts}.{nuser + nrec}.binmap", full)

    count = 0
    for i, lig in enumerate(ingest.iter_ligands(args.ligand)):
        t0 = time.time()
        c = center if center_set else lig.orig_coords.mean(axis=0)
        rotation = translation = None
        if args.random_rotation:
            rotation = random_rotation(args.seed + i)
        if args.random_translate > 0:
            translation = rng.uniform(-args.random_translate,
                                      args.random_translate,
                                      3).astype(np.float32)
        if args.separate:
            lc = lig_typer.channels_for(lig.types)
            lig_grid = grid_channels(
                lig.orig_coords, lc, lig_typer.radii_for(lig.types), c,
                nlig, npts, resolution, args.binary_occupancy, dev)
            grid = lig_grid
        else:
            grid = make_grid(rec.coords, rec.types, lig.orig_coords,
                             lig.types, c, rec_typer, lig_typer, resolution,
                             dimension, rotation, translation,
                             binary=args.binary_occupancy, device=dev)
            if usergrids:
                grid = np.concatenate([np.stack(usergrids), grid])
        if args.time:
            print(f"Grid Time: {int((time.time() - t0) * 1e9)}")

        base = f"{args.out}_{i}"
        if args.map:
            _write_channel_files(base, grid, nuser, rec_typer, lig_typer,
                                 c, resolution, "map", args.separate)
        elif args.dx:
            _write_channel_files(base, grid, nuser, rec_typer, lig_typer,
                                 c, resolution, "dx", args.separate)
        elif args.separate:
            write_binmap(f"{base}.{npts}.{nlig}.binmap", grid)
        else:
            write_binmap(f"{base}.{npts}.{nuser + nrec + nlig}.binmap", grid)
        count += 1
    print(f"wrote {count} grid(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
