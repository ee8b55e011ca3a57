"""gnina-compatible command-line interface of the port.

Counterpart of gnina_tpu/cli.py (reference: gninasrc/main/main.cpp options
at :909-1083) on top of the PyTorch/CUDA docking engine: every flag of the
JAX parser, the same log lines, the same screen (shape buckets, batches of
8, per-ligand retry, `.partial` checkpoint and --resume).

    python -m gnina_tpu_torch -r rec.pdb -l ligs.sdf --autobox_ligand \\
        ligs.sdf -o out.sdf [--device cpu]

Differences from the JAX CLI, all forced by the port:
- `--device` names the torch device (default: the card; a run without one
  fails unless `--device cpu` asks for the plain versions).  The JAX flag
  of that name is a compatibility no-op taking gnina's GPU number, which is
  still accepted here.
- canonical_shapes stays off: it pads shapes so that compiled TPU programs
  are shared, and the port's kernels take their shapes at run time.
- Buckets are docked in a plain loop; `--no_compile_ahead` is accepted
  without effect (its two worker threads overlap XLA compiles).

Multi-GPU: a screen on the default device with more than one card shards
each batch (8 ligands a card) over a "dp" mesh of every card
(parallel/mesh.py); `--dist_nprocs N` (or GNINA_TPU_NPROCS) runs a screen
as N processes that meet over a gloo process group at `--dist_coordinator
host:port` (parallel/multihost.py), each docking the round-robin slice of
the ligands into `{out}.part{pid}`, which process 0 merges in input order.

The GNINA_TPU_FUSED_* environment knobs keep their names.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np

from gnina_tpu_torch import __version__
from gnina_tpu_torch.chem import flexinfo, ingest
from gnina_tpu_torch.chem.tree_build import attach_flex, empty_ligand_struct
from gnina_tpu_torch.device import device_from_flag
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.output import write_flex_pdb, write_poses_sdf
from gnina_tpu_torch.scoring.builtin import get_scoring_function, \
    scoring_function_from_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnina_tpu_torch",
        description="Molecular docking with the capabilities of gnina, in "
                    "PyTorch and CUDA")
    gin = p.add_argument_group("Input")
    gin.add_argument("-r", "--receptor", help="rigid receptor (PDB/PDBQT)")
    gin.add_argument("-l", "--ligand", action="append", default=[],
                     help="ligand(s) (SDF/MOL/PDBQT/PDB)")
    gin.add_argument("--flex", help="flexible side chains PDBQT")
    gin.add_argument("--flexres", help="flexible residues (chain:resid[:icode],...)")
    gin.add_argument("--flexdist_ligand", help="ligand that determines flexdist residues")
    gin.add_argument("--flexdist", type=float, default=-1,
                     help="make residues within this distance flexible")
    gin.add_argument("--flex_limit", type=int, default=-1,
                     help="hard limit on number of flexible residues")
    gin.add_argument("--flex_max", type=int, default=-1,
                     help="keep only the closest flex_max flexible residues")

    gbox = p.add_argument_group("Search space")
    gbox.add_argument("--center_x", type=float)
    gbox.add_argument("--center_y", type=float)
    gbox.add_argument("--center_z", type=float)
    gbox.add_argument("--size_x", type=float)
    gbox.add_argument("--size_y", type=float)
    gbox.add_argument("--size_z", type=float)
    gbox.add_argument("--autobox_ligand", help="ligand to autobox around")
    gbox.add_argument("--autobox_add", type=float, default=4.0)
    gbox.add_argument("--autobox_extend", type=int, default=1)

    gcov = p.add_argument_group("Covalent docking")
    gcov.add_argument("--covalent_rec_atom", default="",
                      help="receptor atom (chain:resnum[icode]:[resname:]"
                           "atomname or x,y,z) to bond the ligand to")
    gcov.add_argument("--covalent_lig_atom_pattern", default="",
                      help="SMARTS pattern; first matched atom bonds to the "
                           "receptor atom")
    gcov.add_argument("--covalent_lig_atom_position", default="",
                      help="x,y,z position for the ligand attachment atom")
    gcov.add_argument("--covalent_fix_lig_atom_position", action="store_true")
    gcov.add_argument("--covalent_bond_order", type=int, default=1)
    gcov.add_argument("--covalent_optimize_lig", action="store_true",
                      help="relieve clashes of the placed ligand (approx of "
                           "the reference's UFF pass)")

    gout = p.add_argument_group("Output")
    gout.add_argument("-o", "--out", help="output file (SDF)")
    gout.add_argument("--out_flex", help="output file for flexible residue poses (PDB)")
    gout.add_argument("--atom_terms", default="",
                      help="optionally write per-atom interaction term "
                           "values to file (result_info::writeAtomValues)")
    gout.add_argument("--atom_term_data", action="store_true",
                      help="embed per-atom interaction terms in the output "
                           "SD data")
    gout.add_argument("--full_flex_output", action="store_true",
                      help="output entire structure for out_flex, not just "
                           "flexible residues")
    gout.add_argument("--log", help="log file")
    gout.add_argument("-q", "--quiet", action="store_true")
    gout.add_argument("--verbosity", type=int, default=1,
                      help="0=quiet, 1=normal, 2+=debug timing detail")

    gsc = p.add_argument_group("Scoring and minimization")
    gsc.add_argument("--scoring", default="default",
                     help="vina|vinardo|dkoes_scoring|dkoes_fast|ad4_scoring")
    gsc.add_argument("--custom_scoring", help="custom scoring term file")
    gsc.add_argument("--score_only", action="store_true")
    gsc.add_argument("--local_only", action="store_true")
    gsc.add_argument("--minimize", action="store_true")
    gsc.add_argument("--randomize_only", action="store_true")
    gsc.add_argument("--minimize_iters", type=int, default=0)
    gsc.add_argument("--accurate_line", action="store_true")
    gsc.add_argument("--simple_ascent", action="store_true",
                     help="use simple gradient ascent (legacy steepest "
                          "descent) instead of BFGS")
    gsc.add_argument("--minimize_single_full", action="store_true",
                     help="during docking perform a single full "
                          "minimization instead of a truncated "
                          "pre-evaluate followed by a full one")
    gsc.add_argument("--minimize_early_term", action="store_true",
                     help="stop minimization before convergence based on "
                          "simple progress heuristic")
    gsc.add_argument("--force_cap", type=float, default=None,
                     help="max allowed force; lower values more gently "
                          "minimize clashing structures (default 1000; "
                          "--minimize softens to 10, main.cpp:1152-1166)")
    gsc.add_argument("--print_terms", action="store_true",
                     help="print all available terms with default "
                          "parameterizations")
    gsc.add_argument("--print_atom_types", action="store_true",
                     help="print all available atom types")
    gsc.add_argument("--approximation", default=None,
                     help="(compat) linear/spline/exact approximation; the "
                          "TPU path always evaluates terms analytically")
    gsc.add_argument("--factor", type=float, default=None,
                     help="(compat) approximation fineness; unused (terms "
                          "are evaluated analytically, not tabulated)")
    gsc.add_argument("--outputmin", type=int, default=0,
                     help="output minout.sdf of minimization with provided "
                          "amount of interpolation")
    gsc.add_argument("--user_grid",
                     help="AutoDock4 .map adding a per-atom bias term")
    gsc.add_argument("--user_grid_lambda", type=float, default=-1.0,
                     help="scale scoring terms by lambda and the user grid "
                          "by 1-lambda (main.cpp:1312-1349)")

    gcnn = p.add_argument_group("Convolutional neural net (CNN) scoring")
    gcnn.add_argument("--cnn_scoring", default="rescore",
                      choices=["none", "rescore", "refinement",
                               "metrorescore", "metrorefine", "all"])
    gcnn.add_argument("--cnn", action="append", default=[],
                      help="built-in model name(s) or ensemble")
    gcnn.add_argument("--cnn_model", action="append", default=[],
                      help="TorchScript model file(s) to convert and use")
    # the reference spells this flag --cnn_rotation (main.cpp:1022);
    # accept both spellings
    gcnn.add_argument("--cnn_rotations", "--cnn_rotation", type=int,
                      default=0, dest="cnn_rotations")
    gcnn.add_argument("--cnn_mix_emp_force", action="store_true",
                      help="merge CNN and empirical minus forces")
    gcnn.add_argument("--cnn_mix_emp_energy", action="store_true",
                      help="merge CNN and empirical energy")
    gcnn.add_argument("--cnn_empirical_weight", type=float, default=1.0,
                      help="weight for scaling and merging empirical "
                           "force and energy")
    gcnn.add_argument("--cnn_center_x", type=float)
    gcnn.add_argument("--cnn_center_y", type=float)
    gcnn.add_argument("--cnn_center_z", type=float)
    gcnn.add_argument("--cnn_verbose", action="store_true")
    gcnn.add_argument("--cnn_outputdx", action="store_true",
                      help="dump per-channel .dx files of the CNN loss "
                           "gradient w.r.t. the atom grid (first model)")
    gcnn.add_argument("--cnn_outputxyz", action="store_true",
                      help="dump .xyz files of the per-atom CNN gradient")
    gcnn.add_argument("--cnn_xyzprefix", default="gradient",
                      help="prefix for --cnn_outputxyz/--cnn_outputdx files")
    gcnn.add_argument("--cnn_gradient_check", action="store_true",
                      help="finite-difference check of the analytic CNN "
                           "atom gradient (diagnostic)")

    gmisc = p.add_argument_group("Misc")
    gmisc.add_argument("--resume", action="store_true",
                       help="resume an interrupted screen from {out}.partial")
    gmisc.add_argument("--no_lig", action="store_true",
                       help="no ligand; score/minimize flex residues only")
    gmisc.add_argument("--custom_atoms", help="custom atom parameter file")
    gmisc.add_argument("--cpu", type=int, default=0, help="(compat; ignored)")
    gmisc.add_argument("--seed", type=int, default=0)
    gmisc.add_argument("--exhaustiveness", type=int, default=8)
    gmisc.add_argument("--num_modes", type=int, default=9)
    gmisc.add_argument("--num_mc_steps", type=int, default=0)
    gmisc.add_argument("--max_mc_steps", type=int, default=0)
    gmisc.add_argument("--num_mc_saved", type=int, default=50)
    gmisc.add_argument("--temperature", type=float, default=0)
    gmisc.add_argument("--min_rmsd_filter", type=float, default=1.0)
    gmisc.add_argument("--pose_sort_order", default="CNNscore",
                       choices=["CNNscore", "CNNaffinity", "Energy"])
    gmisc.add_argument("--no_gpu", action="store_true", help="(compat)")
    gmisc.add_argument("--device", default=None,
                       help="torch device: cuda, cuda:N, a bare GPU number "
                            "as gnina takes it, or cpu (default: the card; "
                            "without one the run fails)")
    gmisc.add_argument("--addH", default="on",
                       help="automatically add hydrogens in ligands "
                            "(on by default; off types atoms as drawn)")
    gmisc.add_argument("--stripH", default="on",
                       help="remove nonpolar hydrogens after atom typing "
                            "(deviation: on by default here — scoring is "
                            "identical, smaller TPU kernels; off keeps "
                            "explicit H in output poses)")
    gmisc.add_argument("--no_compile_ahead", action="store_true",
                       help="disable pipelined per-bucket compilation in "
                            "virtual screens (compile each shape bucket "
                            "serially between device runs)")
    gmisc.add_argument("--dist_nprocs", type=int, default=None,
                       help="multi-host screens: total number of processes "
                            "(default $GNINA_TPU_NPROCS; 1 = single host)")
    gmisc.add_argument("--dist_procid", type=int, default=None,
                       help="this process's rank (default $GNINA_TPU_PROCID)")
    gmisc.add_argument("--dist_coordinator", default=None,
                       help="process-group coordinator host:port "
                            "(default $GNINA_TPU_COORDINATOR)")
    gmisc.add_argument("--flex_hydrogens", action="store_true",
                       help="leave rotatable hydrogen branches mobile "
                            "(PDBQT ligands; main.cpp:1150)")
    gmisc.add_argument("--version", action="version",
                       version=f"gnina_tpu_torch {__version__}")
    gmisc.add_argument("--config", help="options file")
    return p


def parse_config_file(path: str, parser: argparse.ArgumentParser,
                      argv: List[str]) -> List[str]:
    """--config file: 'name = value' lines prepended to argv."""
    extra: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                extra.extend([f"--{k.strip()}", v.strip()])
            else:
                extra.append(f"--{line}")
    return extra + argv


class Tee:
    def __init__(self, logfile: Optional[str], quiet: bool):
        self.f = open(logfile, "w") if logfile else None
        self.quiet = quiet

    def write(self, msg: str):
        if not self.quiet:
            sys.stdout.write(msg)
            sys.stdout.flush()
        if self.f:
            self.f.write(msg)

    def close(self):
        if self.f:
            self.f.close()


def _cnn_debug_outputs(args, cnn, rec, lig, result, log):
    """--cnn_outputxyz/--cnn_outputdx/--cnn_gradient_check on the top pose
    (main.cpp:1007,1030-1033; see models/debug_out.py)."""
    from gnina_tpu_torch.models import debug_out

    coords = np.asarray(result.coords, np.float32)
    if cnn.fixed_center is not None:
        center = np.asarray(cnn.fixed_center, np.float32)
    else:
        center = coords.mean(axis=0)
    rec_coords, rec_types, rec_mask = cnn._receptor_arrays(rec, center[None])
    prefix = args.cnn_xyzprefix
    if args.cnn_outputxyz:
        lg, rg = debug_out.atom_gradients(cnn, rec_coords, rec_types,
                                          rec_mask, lig, coords, center)
        debug_out.write_gradient_xyz(f"{prefix}_lig.xyz", lig.types,
                                     coords, lg)
        debug_out.write_gradient_xyz(f"{prefix}_rec.xyz",
                                     rec_types[rec_mask],
                                     rec_coords[rec_mask], rg[rec_mask])
        log.write(f"Wrote {prefix}_lig.xyz / {prefix}_rec.xyz\n")
    if args.cnn_outputdx:
        debug_out.write_grid_gradient_dx(prefix, cnn, rec_coords, rec_types,
                                         rec_mask, lig, coords, center,
                                         log=log)
    if args.cnn_gradient_check:
        debug_out.gradient_check(cnn, rec_coords, rec_types, rec_mask, lig,
                                 coords, center, log)


def main(argv: Optional[List[str]] = None, device=None) -> int:
    from gnina_tpu_torch.parallel import multihost

    try:
        return _main(argv, device)
    finally:
        multihost.shutdown()


def _main(argv: Optional[List[str]], device) -> int:
    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args, unknown = parser.parse_known_args(argv)
    if args.config:
        argv = parse_config_file(args.config, parser, argv)
        args, unknown = parser.parse_known_args(argv)

    log = Tee(args.log, args.quiet or args.verbosity <= 0)
    if unknown:
        log.write(f"ERROR: unrecognized option(s): {' '.join(unknown)}\n")
        return 1
    t_start = time.time()

    # pure table dumps, exit before any input validation (main.cpp:1130-1139)
    if args.print_terms:
        from gnina_tpu_torch.scoring.terms import available_term_names

        for name in available_term_names():
            sys.stdout.write(name + "\n")
        return 0
    if args.print_atom_types:
        from gnina_tpu_torch.constants import atom_info_lines, \
            table_from_custom_atoms

        table = (table_from_custom_atoms(args.custom_atoms)
                 if args.custom_atoms else None)
        for line in atom_info_lines(table):
            sys.stdout.write(line + "\n")
        return 0
    if args.approximation or args.factor is not None:
        log.write("WARNING: --approximation/--factor accepted for "
                  "compatibility and ignored: this implementation always "
                  "evaluates scoring terms analytically (exactly) on the "
                  "accelerator instead of interpolating tables\n")

    if not args.receptor:
        log.write("ERROR: receptor (-r) required\n")
        return 1
    if not args.ligand and not args.no_lig:
        log.write("ERROR: ligand (-l) required (or --no_lig)\n")
        return 1

    for path in [args.receptor, *args.ligand, args.autobox_ligand,
                 args.custom_atoms]:
        if path and not os.path.isfile(path):
            log.write(f"ERROR: cannot read file {path}\n")
            return 1

    # the multi-process environment contract of the JAX CLI
    # (parallel/multihost.py; GNINA_TPU_{COORDINATOR,NPROCS,PROCID}, flags
    # override)
    from gnina_tpu_torch.parallel import multihost

    env_coord, env_np, env_pid = multihost.env_config()
    args.dist_nprocs = args.dist_nprocs or env_np
    args.dist_procid = (args.dist_procid if args.dist_procid is not None
                        else env_pid)
    args.dist_coordinator = args.dist_coordinator or env_coord
    scoring = args.scoring if args.scoring != "default" else "vina"
    dev = device_from_flag(args.device if args.device is not None else device)
    if args.dist_nprocs > 1:
        multihost.init(args.dist_coordinator, args.dist_nprocs,
                       args.dist_procid)
        if args.verbosity > 0:
            log.write(f"Multi-host screen: process {args.dist_procid} of "
                      f"{args.dist_nprocs}\n")

    # --minimize softens the defaults (main.cpp:1152-1166): forcecap 10,
    # converge (10000 iters), accurate line search; plain --local_only
    # keeps the docking defaults (fast line search, heuristic iters)
    forcecap = args.force_cap
    if forcecap is None:
        forcecap = 10.0 if args.minimize else 1000.0

    def _onoff(v, default=True):
        s = str(v).strip().lower()
        if s in ("on", "1", "true", "yes"):
            return True
        if s in ("off", "0", "false", "no"):
            return False
        return default

    add_h = _onoff(args.addH, True)
    strip_h = _onoff(args.stripH, True)
    settings = DockSettings(
        scoring=scoring,
        exhaustiveness=args.exhaustiveness,
        num_modes=args.num_modes,
        num_mc_saved=args.num_mc_saved,
        out_min_rmsd=args.min_rmsd_filter,
        forcecap=forcecap,
        seed=args.seed,
        num_mc_steps=args.num_mc_steps,
        max_mc_steps=args.max_mc_steps,
        temperature=args.temperature if args.temperature > 0 else 1.2,
        autobox_add=args.autobox_add,
        minimize_iters=args.minimize_iters,
        accurate_line_search=args.accurate_line,
        local_only=bool(args.local_only and not args.minimize),
        minimize_early_term=args.minimize_early_term,
        simple_ascent=args.simple_ascent,
        minimize_single_full=args.minimize_single_full,
        cnn_scoring=args.cnn_scoring,
        cnn_rotations=args.cnn_rotations,
        cnn_mix_emp_force=args.cnn_mix_emp_force,
        cnn_mix_emp_energy=args.cnn_mix_emp_energy,
        cnn_empirical_weight=args.cnn_empirical_weight,
        sort_order=args.pose_sort_order if args.pose_sort_order else "auto",
        outputmin_frames=max(args.outputmin, 0),
        # a TPU compile-sharing knob; the port's kernels take their shapes
        # at run time
        canonical_shapes=False,
    )
    # kernel tuning via env (operator knobs with measured defaults; no
    # reference-CLI equivalent exists, so they stay off the flag surface)
    _env_knobs = {}
    for _name, _cast in (("fused_async_ls", lambda v: v == "1"),
                         ("fused_async_mc", lambda v: v == "1"),
                         ("fused_mc_in_kernel", lambda v: v == "1"),
                         ("fused_mc_tick_budget", int),
                         ("fused_mc_steps", int),
                         ("fused_ls_trials", int),
                         ("fused_ls_factor", float),
                         ("fused_refine_every", int),
                         ("fused_done_frac", float)):
        _v = os.environ.get("GNINA_TPU_" + _name.upper())
        if _v is not None:
            _env_knobs[_name] = _cast(_v)
    if _env_knobs:
        settings = dataclasses.replace(settings, **_env_knobs)

    sf = None
    if args.custom_scoring:
        sf = scoring_function_from_file(args.custom_scoring)
    if args.custom_atoms:
        # runtime atom-parameter table (main.cpp:546-600); overrides the
        # scoring function's own table (as the reference's global swap does)
        from gnina_tpu_torch.constants import table_from_custom_atoms

        base_sf = sf if sf is not None else get_scoring_function(scoring)
        tbl = table_from_custom_atoms(
            args.custom_atoms, base_sf.table,
            warn=lambda m: log.write(m + "\n"))
        sf = dataclasses.replace(base_sf, table=tbl)

    cnn = None
    if args.cnn_scoring != "none":
        from gnina_tpu_torch.models.scorer import CNNScorer

        center = None
        if args.cnn_center_x is not None:
            center = np.array([args.cnn_center_x, args.cnn_center_y,
                               args.cnn_center_z], np.float32)
        cnn = CNNScorer(model_names=(args.cnn + args.cnn_model) or None,
                        rotations=args.cnn_rotations, seed=args.seed,
                        center=center, device=dev, verbose=args.cnn_verbose)

    user_grid = None
    ug_box = None
    if args.user_grid:
        from gnina_tpu_torch.ops.user_grid import read_ad4_map

        ug_scale = 1.0
        if args.user_grid_lambda != -1.0:
            ug_scale = 1.0 - args.user_grid_lambda
            # scale all scoring-term weights by lambda (set_scaling_factor)
            base = sf if sf is not None else get_scoring_function(scoring)
            sf = dataclasses.replace(
                base, pair_weights=tuple(w * args.user_grid_lambda
                                         for w in base.pair_weights))
        user_grid, ug_center, ug_size = read_ad4_map(
            args.user_grid, scaling=ug_scale, device=dev)
        ug_box = (ug_center, ug_size)

    engine = DockingEngine(settings, sf=sf, cnn_scorer=cnn, device=dev,
                           user_grid=user_grid)
    if args.verbosity >= 2:
        # MC search progress (the reference's parallel_progress bar)
        engine.progress = lambda msg: log.write(msg + "\n")
    rec = ingest.Receptor.from_file(args.receptor)

    # covalent docking context (reference: covinfo.cpp, molgetter.cpp:105+)
    cov_ctx = None
    if args.covalent_rec_atom:
        from gnina_tpu_torch.chem import covalent as cov_mod

        cinfo = cov_mod.CovInfo(cov_mod.CovOptions(
            covalent_rec_atom=args.covalent_rec_atom,
            covalent_lig_atom_pattern=args.covalent_lig_atom_pattern,
            covalent_lig_atom_position=args.covalent_lig_atom_position,
            covalent_fix_lig_atom_position=args.covalent_fix_lig_atom_position,
            covalent_bond_order=args.covalent_bond_order,
            covalent_optimize_lig=args.covalent_optimize_lig,
            dont_move_ligand=bool(args.score_only or args.minimize
                                  or args.local_only),
        ), log=lambda m: log.write(m + "\n"))
        rec, covres, cov_ratom = cov_mod.extract_covres(rec, cinfo)
        cov_ctx = (cov_mod, cinfo, covres, cov_ratom)
        log.write(f"Covalent receptor atom: {cinfo.rec_atom_string()}\n")

    # flexible residue selection (reference: flexinfo.cpp)
    flex_residues = []
    if args.flex:
        # user-supplied flex PDBQT (parse_pdbqt.h:28-32, molgetter.cpp:52+)
        with open(args.flex) as f:
            flex_residues.extend(flexinfo.flex_from_pdbqt(f.read()))
        if not flex_residues:
            log.write(f"WARNING: no flexible residues parsed from "
                      f"{args.flex}\n")
    if args.flexres or (args.flexdist > 0 and args.flexdist_ligand):
        flexdist_coords = None
        if args.flexdist_ligand:
            fl = next(ingest.iter_ligands(args.flexdist_ligand))
            flexdist_coords = fl.orig_coords
        keys = flexinfo.select_flex_residues(
            rec, flexres=args.flexres, flexdist=args.flexdist,
            flexdist_coords=flexdist_coords, flex_limit=args.flex_limit,
            flex_max=args.flex_max)
        selected = [f for f in (flexinfo.extract_flex_residue(rec, k)
                                for k in keys) if f is not None]
        if selected:
            rec = flexinfo.strip_flex_from_receptor(rec, selected)
            flex_residues.extend(selected)
    if flex_residues:
        log.write("Flexible residues: " + " ".join(
            f"{f.key[0]}:{f.key[1]}{f.key[2]}" for f in flex_residues)
            + "\n")

    # search box
    center = size = None
    if args.autobox_ligand:
        center, size = ingest.autobox_ligand(args.autobox_ligand,
                                             args.autobox_add)
    elif args.center_x is not None and args.size_x is not None:
        center = np.array([args.center_x, args.center_y, args.center_z],
                          np.float32)
        size = np.array([args.size_x, args.size_y, args.size_z], np.float32)
    elif ug_box is not None:
        # the user grid defines the search box (setup_user_gd,
        # main.cpp:1338-1342)
        center, size = ug_box

    cnn_enabled = cnn is not None

    def load_all_ligands():
        if args.no_lig:
            if not flex_residues:
                log.write("ERROR: --no_lig requires flexible residues\n")
                return
            yield attach_flex(empty_ligand_struct(), flex_residues)
            return
        for ligpath in args.ligand:
            if cov_ctx is not None:
                cov_mod, cinfo, covres, cov_ratom = cov_ctx
                for mol in ingest.iter_molecules(ligpath):
                    complexes = cov_mod.covalent_complexes_for_mol(
                        covres, cov_ratom, mol, cinfo,
                        rec_coords=rec.coords)
                    if not complexes:
                        log.write(f"WARNING: Ligand {mol.name} did not "
                                  "match covalent_lig_atom_pattern. "
                                  "Skipping\n")
                    for li, lig in enumerate(complexes):
                        if len(complexes) > 1:
                            lig.name = f"{lig.name}_match{li}"
                        yield lig
                continue
            for lig in ingest.iter_ligands(
                    ligpath, strip_h=strip_h, add_h=add_h,
                    flex_hydrogens=args.flex_hydrogens):
                yield attach_flex(lig, flex_residues)

    def render_poses(lig, results):
        """Pose text for -o (SDF, or PDBQT when the extension asks:
        result_info.cpp:112-210) + per-pose --atom_terms tables."""
        tables = None
        if args.atom_terms or args.atom_term_data:
            from gnina_tpu_torch.scoring.atom_terms import atom_terms_table

            tables = [atom_terms_table(engine.sf, lig, rec, r.coords,
                                       device=engine.device)
                      for r in results]
        if args.out and args.out.lower().endswith(".pdbqt"):
            from gnina_tpu_torch.output import write_poses_pdbqt

            text = write_poses_pdbqt(lig, results, cnn_enabled)
        else:
            text = write_poses_sdf(
                lig, results, cnn_enabled,
                atom_terms=tables if args.atom_term_data else None)
        return text, tables

    docking_mode = not (args.score_only or args.local_only or args.minimize
                        or args.randomize_only)
    if docking_mode and center is not None:
        # virtual-screen path: bucket the ligand stream by shape and dock
        # each bucket as one batched device run (the reference streams one
        # ligand per worker thread; here the batch IS the parallelism)
        return _run_screen(args, engine, rec, center, size,
                           load_all_ligands(), cnn_enabled, log, t_start,
                           render_poses)

    out_chunks: List[str] = []
    out_flex_chunks: List[str] = []
    atom_chunks: List[str] = []
    n_ligs = 0
    for lig in load_all_ligands():
        n_ligs += 1
        log.write(f"\n## {lig.name}\n")
        if args.score_only:
            r = engine.score_only(rec, lig)
            log.write(f"Affinity: {r.energy:.5f} (kcal/mol)\n")
            log.write(f"CNNscore: {r.cnnscore:.5f} \n")
            log.write(f"CNNaffinity: {r.cnnaffinity:.5f}\n")
            if r.cnnvariance > 0:
                log.write(f"CNNvariance: {r.cnnvariance:.5f}\n")
            log.write(f"Intramolecular energy: {r.intramol:.5f}\n")
            # unconditional in score mode like the reference (main.cpp:252)
            vals = engine.term_values(rec, lig)
            log.write("Term values, before weighting:\n## "
                      + lig.name.replace(" ", "_") + " "
                      + " ".join(f"{v:.5f}" for v in vals) + "\n")
            results = [r]
        elif args.randomize_only:
            if center is None:
                lo = lig.orig_coords.min(axis=0) - args.autobox_add
                hi = lig.orig_coords.max(axis=0) + args.autobox_add
                rcenter, rsize = (lo + hi) / 2, hi - lo
            else:
                rcenter, rsize = center, size
            results = [engine.randomize(rec, lig, rcenter, rsize,
                                        seed=args.seed + i)
                       for i in range(args.num_modes)]
            for r in results:
                log.write(f"Clash penalty: {r.energy:.5f}\n")
        elif args.local_only or args.minimize:
            # both modes derive the box from the movable atoms regardless
            # of any user box (main.cpp:1465-1478), skipping >100A spans
            span = (lig.orig_coords.max(axis=0)
                    - lig.orig_coords.min(axis=0)) + 2 * args.autobox_add
            if np.any(span > 100.0):
                log.write(f"WARNING: Ligand {lig.name} has an extent "
                          "greater than 100A. Skipping.\n")
                continue
            r = engine.minimize(rec, lig)
            if args.outputmin > 0:
                # minout.sdf in the working directory, as the reference
                # writes it (bfgs.h:265)
                frames = engine.minimize_trajectory(rec, lig)
                from gnina_tpu_torch.chem.sdf import write_sdf_block

                with open("minout.sdf", "w") as fmin:
                    for fc in frames:
                        fmin.write(write_sdf_block(lig.mol, coords=fc,
                                                   name=lig.name))
                log.write(f"Wrote minout.sdf ({len(frames)} frames)\n")
            log.write(f"Affinity: {r.energy:.5f}  {r.intramol:.5f} "
                      f"(kcal/mol)\nRMSD: {r.rmsd:.5f}\n")
            log.write(f"CNNscore: {r.cnnscore:.5f} \n")
            log.write(f"CNNaffinity: {r.cnnaffinity:.5f}\n")
            if not r.within_box:
                log.write("WARNING: not all movable atoms are within the "
                          "search space\n")
            results = [r]
        else:
            if center is None:
                log.write("ERROR: search box required (--autobox_ligand "
                          "or --center/--size)\n")
                return 1
            box_size = size
            if args.autobox_ligand and args.autobox_extend:
                # ensure box fits ligand max span (main.cpp:1479-1484)
                span = lig.max_span() + 4
                box_size = np.maximum(size, span)
            results = engine.dock(rec, lig, center, box_size,
                                  seed=args.seed)
            _write_pose_table(log, results)
        if cnn is not None and results and (
                args.cnn_outputxyz or args.cnn_outputdx
                or args.cnn_gradient_check):
            _cnn_debug_outputs(args, cnn, rec, lig, results[0], log)
        if args.out or args.atom_terms:
            text, tables = render_poses(lig, results)
            if args.out:
                out_chunks.append(text)
            if args.atom_terms and tables:
                atom_chunks.extend(tables)
        if args.out_flex and lig.flex_meta:
            out_flex_chunks.append(write_flex_pdb(
                lig, results,
                rigid=rec.mol if args.full_flex_output else None))
    if n_ligs == 0:
        log.write("ERROR: no ligands could be read from: "
                  + " ".join(args.ligand) + "\n")
        return 1
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(out_chunks))
    if args.atom_terms:
        with open(args.atom_terms, "w") as f:
            f.write("".join(atom_chunks))
    if args.out_flex:
        with open(args.out_flex, "w") as f:
            f.write("".join(out_flex_chunks))

    log.write(f"\nLoop time {time.time() - t_start:.2f}\n")
    log.close()
    return 0


def _write_pose_table(log, results) -> None:
    log.write("mode |  affinity  |  intramol  |    CNN     |   CNN\n")
    log.write("     | (kcal/mol) | (kcal/mol) | pose score | affinity\n")
    log.write("-----+------------+------------+------------+----------\n")
    for i, r in enumerate(results):
        log.write(f"{i + 1:5d} {r.energy:11.2f} {r.intramol:11.2f} "
                  f"{r.cnnscore:11.4f} {r.cnnaffinity:9.3f}\n")


def _screen_mesh(log, verbosity: int, dev):
    """The screen's ligand sharding: a "dp" mesh over every card when the
    screen runs on the default card and more than one is present
    (gnina_tpu/cli.py:708-722), else None."""
    import torch

    if dev.type != "cuda" or dev.index is not None \
            or torch.cuda.device_count() <= 1:
        return None
    from gnina_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(tp=1)
    if verbosity > 1:
        log.write(f"Sharding ligand batches over {mesh.shape['dp']} "
                  "devices\n")
    return mesh


def _run_screen(args, engine, rec, center, size, ligands, cnn_enabled,
                log, t_start, render_poses) -> int:
    """Batched virtual screen: bucket ligands by padded shape, dock each
    bucket in batches of 8 a card, write results in input order.  Under
    --dist_nprocs this process docks its round-robin slice and process 0
    merges the part files."""
    from gnina_tpu_torch.parallel import multihost

    def bucket_key(lig):
        def up(x, m):
            return ((x + m - 1) // m) * m

        # bucket rounding mirrors dock_batch's shape rounding
        return (up(lig.num_atoms, 8), up(lig.num_nodes, 4))

    all_ligs = list(ligands)
    if not all_ligs:
        log.write("ERROR: no ligands could be read\n")
        return 1
    mesh = _screen_mesh(log, args.verbosity, engine.device)
    n_dev = mesh.shape["dp"] if mesh is not None else 1
    batch_size = max(8, 8 * n_dev)
    order = {id(l): i for i, l in enumerate(all_ligs)}
    nprocs = getattr(args, "dist_nprocs", 1) or 1
    pid = getattr(args, "dist_procid", 0) or 0
    dist = nprocs > 1

    def mine(idx: int) -> bool:
        return (idx % nprocs) == pid

    # crash recovery: finished ligands stream to {out}.partial as framed SDF
    # chunks; --resume reloads them and docks only the remainder.  The
    # reference has no docking checkpointing: a killed screen restarts from
    # zero.
    results_by_idx = {}
    partial_path = (args.out + ".partial") if args.out else None
    if dist and partial_path:
        partial_path = f"{args.out}.h{pid}.partial"  # per-process checkpoint
    resumed = set()
    if getattr(args, "resume", False) and partial_path and \
            os.path.exists(partial_path):
        with open(partial_path) as f:
            text = f.read()
        for block in text.split("#GNINA_TPU_IDX ")[1:]:
            head, _, body = block.partition("\n")
            parts = head.split(None, 1)
            try:
                idx = int(parts[0])
            except (ValueError, IndexError):
                continue
            if not (0 <= idx < len(all_ligs)):
                continue
            # the partial may be left over from a run against a DIFFERENT
            # ligand file: trust a block only when the stored name matches
            stored_name = parts[1] if len(parts) > 1 else ""
            if stored_name != all_ligs[idx].name:
                log.write(f"WARNING: partial block {idx} names "
                          f"'{stored_name}' but the ligand file has "
                          f"'{all_ligs[idx].name}'; re-docking it\n")
                continue
            # a flex chunk (if any) rides in the same block after its marker
            sdf_body, _, flex_part = body.partition("#GNINA_TPU_FLEX ")
            flex_body = flex_part.partition("\n")[2] if flex_part else ""
            results_by_idx[idx] = ("text", stored_name, (sdf_body, flex_body))
            resumed.add(idx)
        if resumed:
            log.write(f"Resuming: {len(resumed)} of {len(all_ligs)} "
                      "ligand(s) already docked\n")
    # append only when actually resuming: a stale partial from an older
    # interrupted run must not leak foreign blocks into this run's output
    part_mode = "a" if resumed else "w"
    part_f = open(partial_path, part_mode) if partial_path else None

    buckets = {}
    for lig in all_ligs:
        if order[id(lig)] not in resumed and mine(order[id(lig)]):
            buckets.setdefault(bucket_key(lig), []).append(lig)

    if args.verbosity > 1 and len(buckets) > 1:
        log.write(f"Screen uses {len(buckets)} shape bucket(s): "
                  + ", ".join(f"{k}x{len(v)}" for k, v in buckets.items())
                  + "\n")

    first_seen = set()

    def dock_one(key, chunk):
        box_size = np.asarray(size)
        if args.autobox_ligand and args.autobox_extend:
            span = max(l.max_span() for l in chunk) + 4
            box_size = np.maximum(box_size, span)
        t_bucket = time.time()
        try:
            res_b = engine.dock_batch(rec, chunk, center, box_size,
                                      seed=args.seed, mesh=mesh)
        except Exception as e:
            # the whole batch failed: retry ligand-by-ligand so one
            # poisoned molecule costs only itself (the reference
            # isolates per ligand, main.cpp:406-409)
            log.write(f"WARNING: batch failed ({e}); retrying "
                      "per-ligand\n")
            res_b = []
            for lone in chunk:
                try:
                    res_b.append(engine.dock_batch(
                        rec, [lone], center, box_size,
                        seed=args.seed)[0])
                except Exception as e1:
                    log.write(f"ERROR processing ligand {lone.name}: "
                              f"{e1}\n")
                    res_b.append([])
        if key not in first_seen and args.verbosity > 1:
            log.write(f"Bucket {key}: first batch "
                      f"{time.time() - t_bucket:.1f} s\n")
        first_seen.add(key)
        for lig, res in zip(chunk, res_b):
            idx = order[id(lig)]
            results_by_idx[idx] = ("res", lig, res)
            if part_f is not None:
                sdf_text, _ = render_poses(lig, res)
                part_f.write(f"#GNINA_TPU_IDX {idx} {lig.name}\n")
                part_f.write(sdf_text)
                if args.out_flex and lig.flex_meta:
                    part_f.write(f"#GNINA_TPU_FLEX {idx}\n")
                    part_f.write(write_flex_pdb(
                        lig, res,
                        rigid=rec.mol if args.full_flex_output else None))
                part_f.flush()

    # a plain loop over the buckets: there is no compile to overlap
    for key, blist in buckets.items():
        for i in range(0, len(blist), batch_size):
            dock_one(key, blist[i:i + batch_size])

    if part_f is not None:
        part_f.close()

    out_chunks = []
    out_flex_chunks = []
    atom_chunks = []
    if dist and (args.atom_terms or args.out_flex):
        log.write("WARNING: --atom_terms/--out_flex are per-process under "
                  "--dist_nprocs; only this process's ligands are "
                  "included\n")
    indexed_chunks = []  # (global index, sdf text) for the part file
    my_indices = sorted(results_by_idx) if dist else range(len(all_ligs))
    for i in my_indices:
        kind, a, b = results_by_idx[i]
        if kind == "text":
            log.write(f"\n## {a} (resumed)\n")
            sdf_body, flex_body = b
            out_chunks.append(sdf_body)
            indexed_chunks.append((i, sdf_body))
            if flex_body:
                out_flex_chunks.append(flex_body)
            continue
        lig, results = a, b
        log.write(f"\n## {lig.name}\n")
        _write_pose_table(log, results)
        if args.out or args.atom_terms:
            text, tables = render_poses(lig, results)
            if args.out:
                out_chunks.append(text)
                indexed_chunks.append((i, text))
            if args.atom_terms and tables:
                atom_chunks.extend(tables)
        if args.out_flex and lig.flex_meta:
            out_flex_chunks.append(write_flex_pdb(
                lig, results,
                rigid=rec.mol if args.full_flex_output else None))
    if args.out and dist:
        # each process writes its slice; process 0 stitches the input
        # order back together after the barrier (parallel/multihost.py)
        with open(multihost.part_path(args.out, pid), "w") as f:
            for i, text in indexed_chunks:
                f.write(f"#GNINA_TPU_IDX {i} {all_ligs[i].name}\n")
                f.write(text)
        multihost.barrier("screen-output")
        if pid == 0:
            n_merged = multihost.merge_part_outputs(args.out, nprocs)
            log.write(f"Merged {n_merged} ligand(s) from {nprocs} "
                      "process part files\n")
    elif args.out:
        with open(args.out, "w") as f:
            f.write("".join(out_chunks))
    if args.out:
        if partial_path and os.path.exists(partial_path):
            os.remove(partial_path)  # the final ordered output supersedes it
    if args.atom_terms:
        # resumed ligands' tables are not recomputed
        with open(args.atom_terms, "w") as f:
            f.write("".join(atom_chunks))
    if args.out_flex:
        with open(args.out_flex, "w") as f:
            f.write("".join(out_flex_chunks))
    log.write(f"\nLoop time {time.time() - t_start:.2f}\n")
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
