"""End-to-end docking engine: the PyTorch/CUDA counterpart of
gnina_tpu/docking.py (reference: gninasrc/main/main.cpp:210-530).

Pipeline for a batch of ligands against one receptor and box:
  host ingest -> lane pack (ligands x exhaustiveness chains) -> random
  chain heads -> MC search -> per-ligand merge -> five slope-escalation
  refine stages (one lane per saved pose) -> exact rescore +
  conf-independent terms -> CNN rescore of every saved pose (when the
  engine holds a scorer) -> sort, dedup.

Two routes run the search and the refine stages, as in the JAX package:

- the fused route (every device; kernels on `cuda`, their plain versions
  on `cpu`): windows of in-kernel MC (K3) with sub-window full-v refines
  (K2) and one batched container merge per window, and the stages through
  K2.  The search settings select the kernel modes as in the JAX package:
  fused_async_mc=False runs lockstep windows (K5, at most 16 steps each),
  fused_mc_in_kernel=False the host-driven step loop
  (mc_fused.fused_mc_chunk over K2), fused_async_ls the per-pose tick line
  search (K4) in every BFGS, fused_warm_ls the warm-started line search of
  the async window (K6); fused_done_frac < 1 goes to all three kernel
  handles (K8).
- the general path (fused_search="off", and every job the fused route
  does not take: non-vina terms, a user grid, the testing minimizers
  simple_ascent and minimize_single_full, flexible side chains and
  covalent complexes, whose "other" pairs are scored at v[2]): per-type
  search grids
  (ops/cache_grid.py, with the user grid folded in), the host-driven MC
  step loop of ops/mc.mc_chunk over ops/bfgs.py's BFGS on autograd
  energies, and the stages on the exact energy; ordinary PyTorch, no
  kernel.

The CNN inside the search (cnn_scoring refinement, metrorescore,
metrorefine, all, with a scorer) takes the general path, as in the JAX
package: the CNN loss drives Metropolis (every such mode), refines the
saved poses in the stages (refinement, metrorefine, all) and is the MC
step's BFGS objective (all, with no search grids); minimize refines with
it under refinement, metrorefine and all.  Ordinary PyTorch over the
scorer's voxelizer and networks (_build_cnn_objective), no kernel.

dock_batch(mesh=) docks the batch in shards, one a "dp" row of a
parallel.mesh.Mesh, on either route (the JAX engine's shard_map): the
random numbers are drawn once for the whole batch and each shard takes
its lanes' share, so the shards together dock what one device docks.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from gnina_tpu_torch import trace
from gnina_tpu_torch.chem.ingest import Receptor, box_from_center_size
from gnina_tpu_torch.chem.tree_build import LigandStruct
from gnina_tpu_torch.constants import IS_HYDROGEN, MAX_FL
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.ops import cache_grid as cg
from gnina_tpu_torch.ops import fk, mc
from gnina_tpu_torch.ops import quat as Q
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.ops import mc_fused
from gnina_tpu_torch.ops.bfgs import MinimizeParams, bfgs
from gnina_tpu_torch.ops.energy import Box, EnergyFn, lane_ligands, \
    make_energy_fn
from gnina_tpu_torch.scoring.builtin import get_scoring_function
from gnina_tpu_torch.scoring.weighted import ScoringFunction
from gnina_tpu_torch.types import Conf, LigandData, ReceptorData, \
    initial_conf, pad_ligand, pad_receptor

# poses per evaluation of the CNN objective: bounds the grids and the
# networks' activations (and their autograd state, for a gradient) held at
# once
CNN_POSE_CHUNK = 64
# poses per BFGS run of the CNN refinement stages: bounds the receptor
# grids held over one run (12.4 MB a pose and voxelization group at 28
# channels on 48^3)
CNN_STAGE_CHUNK = 256
_CNN_MODES = ("refinement", "metrorescore", "metrorefine", "all")


@dataclasses.dataclass
class DockSettings:
    """Every field of the JAX package's DockSettings, with its default; the
    fields of other routes are carried so settings objects agree."""

    scoring: str = "vina"
    exhaustiveness: int = 8
    num_modes: int = 9
    num_mc_saved: int = 50
    out_min_rmsd: float = 1.0
    forcecap: float = 1000.0
    seed: int = 0
    num_mc_steps: int = 0          # 0 -> heuristic
    max_mc_steps: int = 0
    refine_stride: int = 8
    fused_line_search: bool = False
    temperature: float = 1.2
    autobox_add: float = 4.0
    minimize_iters: int = 0        # 0 -> heuristic
    accurate_line_search: bool = False
    local_only: bool = False
    minimize_early_term: bool = False
    simple_ascent: bool = False
    minimize_single_full: bool = False
    cnn_scoring: str = "rescore"   # none|rescore|refinement|all
    cnn_rotations: int = 0
    cnn_mix_emp_force: bool = False
    cnn_mix_emp_energy: bool = False
    cnn_empirical_weight: float = 1.0
    sort_order: str = "auto"       # auto|CNNscore|CNNaffinity|Energy
    mc_chunk_steps: int = 256      # steps per chunk of windows
    search_grid: bool = True
    fused_search: str = "auto"     # auto|on|off ("off" is the general path)
    fused_done_frac: float = 1.0
    fused_mc_in_kernel: bool = True
    fused_mc_steps: int = 128      # MC window length S
    fused_ls_trials: int = 10
    fused_ls_factor: float = 2.0
    fused_async_ls: bool = False
    fused_async_mc: bool = True
    fused_mc_tick_budget: int = 16
    fused_refine_every: int = 0    # 0 = auto (max(32, num_steps // 16))
    fused_warm_ls: bool = False
    outputmin_frames: int = 0
    canonical_shapes: bool = False


@dataclasses.dataclass
class PoseResult:
    energy: float               # Vina affinity (kcal/mol)
    intramol: float
    cnnscore: float
    cnnaffinity: float
    cnnvariance: float
    coords: np.ndarray          # (N,3) all-atom coords (unpadded)
    conf_position: np.ndarray
    conf_orientation: np.ndarray
    conf_torsions: np.ndarray
    rmsd: float = -1.0
    within_box: bool = True


class _SharedDraws:
    """The random draws of one batch, made in the unsharded run's order
    and handed to every shard: chunk k is drawn once, after every earlier
    chunk, by whichever shard asks first; once each of the `readers`
    shards has taken it, it is dropped."""

    def __init__(self, draw_chunk, readers: int):
        self._draw = draw_chunk
        self._readers = readers
        self._lock = threading.Lock()
        self._made = 0
        self._chunks = {}
        self._left = {}

    def get(self, k: int):
        with self._lock:
            while self._made <= k:
                self._chunks[self._made] = self._draw(self._made)
                self._left[self._made] = self._readers
                self._made += 1
            out = self._chunks[k]
            self._left[k] -= 1
            if not self._left[k]:
                del self._chunks[k], self._left[k]
            return out


def _run_shards(devices, fn):
    """[fn(i) for each shard]: in this thread for one shard, else one
    thread a shard with its card current, so that shards on distinct
    cards enqueue at once and overlap."""
    if len(devices) == 1:
        return [fn(0)]
    parent = trace.current()

    def run(i):
        with trace.adopt(parent):
            if devices[i].type == "cuda":
                with torch.cuda.device(devices[i]):
                    return fn(i)
            return fn(i)

    with ThreadPoolExecutor(max_workers=len(devices)) as ex:
        futures = [ex.submit(run, i) for i in range(len(devices))]
        return [f.result() for f in futures]


def _carry_slice(carry: mc.MCCarry, l0: int, l1: int, device) -> mc.MCCarry:
    """Lanes l0..l1-1 of a chain state, on `device`."""
    def sl(x):
        return x[l0:l1].to(device)

    return mc.MCCarry(*[mc.PoseContainer(*[sl(y) for y in x])
                        if isinstance(x, mc.PoseContainer) else sl(x)
                        for x in carry])


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


def _async_mc_steps_guard(mc_steps: int, m_nodes: int,
                          vmem_cap: int = 10 << 20) -> int:
    """Window-length guard of the JAX package (stream rows + Hessian
    scratch under a fixed budget), kept so both packages run the same
    window schedule; low-torsion ligands keep the long default window."""
    lane_bytes = 4 * 128
    fixed = (7 + m_nodes) ** 2 * lane_bytes      # Hessian scratch
    row = (11 + m_nodes) * lane_bytes            # stream rows per step
    budget = max(vmem_cap - fixed, row * 16)
    return int(min(mc_steps, max(budget // row, 16)))


def exact_split(efn: EnergyFn, lig_d: LigandData, rec_d: ReceptorData,
                conf: Conf, box: Box, slope, cap):
    """(affinity_arg, intramolecular) with flex residues (model.cu:352-407):
      intramolecular = ligand intra pairs (v[0]) + flex-rigid inter (v[1])
                       + flex-flex other pairs (v[2])
      affinity_arg   = ligand-rigid inter + ligand-flex other pairs
    curl is per atom and per pair, so splitting the inter sum by atom
    subset is exact.  A ligand-only complex has no other pairs and no flex
    atoms: inter and intra."""
    inter_all = efn.eval_inter(lig_d, rec_d, conf, box, slope, cap[1])
    lig_only = lig_d._replace(heavy_mask=lig_d.lig_heavy_mask)
    inter_lig = efn.eval_inter(lig_only, rec_d, conf, box, slope, cap[1])
    intra = efn.eval_intra(lig_d, conf, cap[0])
    other_all = efn.eval_other(lig_d, conf, cap[2])
    ffl = lig_d._replace(opair_mask=lig_d.opair_mask & lig_d.opair_ff)
    other_ff = efn.eval_other(ffl, conf, cap[2])
    affinity_arg = inter_lig + (other_all - other_ff)
    intramol = intra + (inter_all - inter_lig) + other_ff
    return affinity_arg, intramol


def _inside(lig: LigandData, coords, lo, hi):
    """(...,) True where every heavy atom of a pose lies in [lo, hi] up to
    1e-4 A (refine_structure's within test)."""
    margin = 0.0001
    ok = (coords >= lo - margin) & (coords <= hi + margin)
    return (ok | ~lig.heavy_mask[..., None]).all(-1).all(-1)


def _num_steps_heuristic(lig: LigandStruct, settings: DockSettings) -> int:
    """main.cpp:449-456."""
    dof = 6 + lig.num_torsions
    heuristic = lig.num_atoms + 10 * dof
    steps = int(70 * 3 * (50 + heuristic) / 2)
    if settings.num_mc_steps > 0:
        steps = settings.num_mc_steps
    if settings.max_mc_steps > 0:
        steps = min(steps, settings.max_mc_steps)
    return steps


def _minimize_iters_heuristic(lig: LigandStruct, settings: DockSettings) -> int:
    """ssd_par.evals = (25 + natoms)/3 (main.cpp:454)."""
    if settings.minimize_iters > 0:
        return settings.minimize_iters
    return max(int((25 + lig.num_atoms) / 3), 1)


def batch_ligands(sms: Optional[int], blocks_per_sm: int,
                  exhaustiveness: int, n_dev: int, k3: bool) -> int:
    """Ligands a screen docks in one dock_batch over n_dev cards.  Where K3
    runs the search (k3: the fused route with in-kernel async MC) on a card
    with `sms` SMs, each card takes as many ligands as fill K3's resident
    pose blocks (sms x blocks_per_sm, one lane a chain), and never fewer
    than the JAX CLI's 8; off the card (sms None) and on every other route,
    8 a card (gnina_tpu/cli.py's max(8, 8 * n_dev))."""
    per_card = 8
    if k3 and sms:
        per_card = max(8, sms * blocks_per_sm // exhaustiveness)
    return per_card * n_dev


class DockingEngine:
    """Docking on one device, or on a mesh of them (dock_batch(mesh=)),
    through the fused kernels or the general path (module docstring).

    cnn_scorer: a models.scorer.CNNScorer, or None.  Without one the engine
    docks without a CNN whatever cnn_scoring says (scores 0.0, sort `auto`
    -> Energy), as the JAX engine does.  user_grid: an
    ops.user_grid.UserGrid bias (--user_grid), added per movable atom
    before curl in every energy; a job with one takes the general path."""

    def __init__(self, settings: DockSettings = DockSettings(),
                 sf: Optional[ScoringFunction] = None, cnn_scorer=None,
                 device=None, user_grid=None):
        self.settings = settings
        self.sf = sf if sf is not None else get_scoring_function(settings.scoring)
        self.cnn = cnn_scorer
        self.device = resolve_device(device)
        self.user_grid = user_grid
        # optional search progress sink (the reference's parallel_progress
        # bar); the CLI wires this at --verbosity >= 2
        self.progress = None  # Callable[[str], None] | None

    def _make_efn(self, max_layers: int) -> EnergyFn:
        return make_energy_fn(self.sf, max_layers, user_grid=self.user_grid)

    # -- routing --------------------------------------------------------------

    def _check_supported(self) -> None:
        """Raise NotImplementedError for canonical_shapes, which neither
        route takes."""
        if self.settings.canonical_shapes:
            raise NotImplementedError(
                "canonical_shapes pads to share compiled TPU programs; the "
                "port's kernels take their shapes at run time")

    def _fused_route(self, ligs) -> bool:
        """The fused route takes vina-family scoring of ligands alone
        (no flex residues, no "other" pairs: so no covalent complex) without
        a user grid, the testing minimizers or the CNN in the loop (a
        scorer with a CNN-in-the-loop mode), unless fused_search is "off";
        "auto" and "on" take it on every device.  Everything else takes the
        general path (the JAX engine's _fused_eligible)."""
        self._check_supported()
        s = self.settings
        return (s.fused_search != "off"
                and fd.extract_vina_terms(self.sf) is not None
                and self.user_grid is None
                and not (self.cnn is not None
                         and s.cnn_scoring in _CNN_MODES)
                and not (s.simple_ascent or s.minimize_single_full)
                and all(l.num_lig_atoms in (-1, l.num_atoms)
                        and (l.other_pairs is None or not len(l.other_pairs))
                        for l in ligs))

    def _runs_k3(self, ligs) -> bool:
        """The search of a dock of ligs runs K3: the fused route with
        in-kernel async MC windows (not the lockstep K5 or host steps)."""
        s = self.settings
        return (s.fused_mc_in_kernel and s.fused_async_mc
                and self._fused_route(ligs))

    def _k3_occupancy(self, device, n: int, m: int, k: int):
        """fused_dock.k3_occupancy at the shared memory of a K3 launch for N
        atom rows, M tree nodes and K receptor atoms; None where no plan
        fits (the dock then fails on its own)."""
        try:
            nbytes = fd.smem_plan(n, m, 6 + m - 1, k).nbytes
        except ValueError:
            return None
        return fd.k3_occupancy(device, nbytes)

    def screen_batch(self, rec: Receptor, ligs: List[LigandStruct], center,
                     size, n_dev: int = 1) -> int:
        """Ligands a screen docks in one dock_batch from ligs (one shape
        bucket) in this box, over n_dev cards: batch_ligands for K3's
        resident blocks on the engine's card at the bucket's launch."""
        k3 = self._runs_k3(ligs)
        occ = None
        if k3:
            pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                                margin=self.sf.cutoff)
            occ = self._k3_occupancy(
                self.device, _round_up(max(l.num_atoms for l in ligs), 8),
                _round_up(max(l.num_nodes for l in ligs), 4),
                len(pruned.types))
        sms, per_sm = occ if occ else (None, 0)
        return batch_ligands(sms, per_sm, self.settings.exhaustiveness,
                             n_dev, k3)

    @property
    def _has_cnn(self) -> bool:
        return self.cnn is not None and self.settings.cnn_scoring != "none"

    # -- score-only ---------------------------------------------------------

    def _conf_independent(self, lig: LigandStruct, e) -> np.ndarray:
        inputs = {
            "num_tors": np.float32(lig.num_tors),
            "num_heavy_atoms": np.float32(lig.num_heavy_atoms),
            "num_hydrophobic_atoms": np.float32(lig.num_hydrophobic_atoms),
            "ligand_lengths_sum": np.float32(lig.ligand_length),
            "num_ligands": np.float32(1.0),
        }
        return self.sf.conf_independent(inputs, np.float32(e))

    def score_only(self, rec: Receptor, lig: LigandStruct) -> PoseResult:
        """--score_only (main.cpp:233-270): exact scoring at the input pose,
        through the fused value kernel (K1) on a one-lane pack, or on the
        general path through the autograd energy."""
        fused = self._fused_route([lig])
        dev = self.device
        center = lig.orig_coords.mean(axis=0)
        size = np.full(3, 2 * (self.sf.cutoff + lig.max_span()), np.float32)
        lig_d, rec_d, _box, max_layers = self._prepare(rec, lig, center, size)
        conf = initial_conf(lig, lig_d.num_torsion_slots, device=dev)
        # naive (no box penalty): an enormous box, slope 0
        lo, hi = np.full(3, -1e8), np.full(3, 1e8)
        if fused:
            m = lig_d.num_torsion_slots + 1
            pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                                margin=self.sf.cutoff)
            pack = fd.build_pack([lig], pruned.coords, pruned.types,
                                 np.ones(len(pruned.types), np.float32), 1,
                                 self.sf.table, m_pad=m, device=dev)
            rigid, tors = fd.conf_to_packed(Conf(*[x[None] for x in conf]),
                                            m)
            inter, intra = self._exact_energies(rigid, tors, pack, lo, hi,
                                                0.0)
        else:
            big = Box(lo=torch.as_tensor(lo, dtype=torch.float32, device=dev),
                      hi=torch.as_tensor(hi, dtype=torch.float32, device=dev))
            with torch.no_grad():
                inter, intra = exact_split(
                    self._make_efn(max_layers), lig_d, rec_d,
                    Conf(*[x[None] for x in conf]), big, 0.0,
                    [float(self.settings.forcecap)] * 3)
            inter, intra = inter.cpu().numpy(), intra.cpu().numpy()
        with torch.no_grad():
            coords = fk.fk_coords(lig_d, conf, max_layers)
        coords = coords.cpu().numpy()[:lig.num_atoms]
        cnnscore = cnnaff = cnnvar = 0.0
        if self._has_cnn:
            cnnscore, cnnaff, cnnvar = self.cnn.score_pose(rec, lig, coords)
        return PoseResult(
            energy=float(self._conf_independent(lig, float(inter[0]))),
            intramol=float(intra[0]), cnnscore=cnnscore, cnnaffinity=cnnaff,
            cnnvariance=cnnvar, coords=coords,
            conf_position=conf.position.cpu().numpy(),
            conf_orientation=conf.orientation.cpu().numpy(),
            conf_torsions=conf.torsions.cpu().numpy()[:lig.num_torsions])

    def _exact_energies(self, rigid, tors, pack: fd.DockPack, lo, hi, slope):
        """The exact split (affinity argument, intramolecular) of packed
        poses through K1: with every cap at forcecap, K1's Metropolis twin
        is the receptor-ligand energy at cap (+ box penalty) and the rest
        of its total the intra-ligand pairs at cap (model.cu:352-407, as
        exact_split computes it)."""
        cap = float(self.settings.forcecap)
        scal = fd.scal_vector(cap, cap, slope, cap, lo, hi,
                              device=rigid.device)
        e, e_inter, _, _ = fd.eval_fg(fd.extract_vina_terms(self.sf), rigid,
                                      tors, scal, pack)
        return e_inter.cpu().numpy(), (e - e_inter).cpu().numpy()

    def term_values(self, rec: Receptor, lig: LigandStruct) -> List[float]:
        """Per-term unweighted rec-lig sums at the input pose, the "Term
        values, before weighting" row of --score_only (main.cpp:252-264,
        terms.h evale_robust).  Ordinary PyTorch on the engine's device: one
        (atoms, receptor atoms) distance matrix, each term broadcast over it
        (no kernel)."""
        from gnina_tpu_torch.scoring.terms import gather_type_params

        dev = self.device
        center = lig.orig_coords.mean(axis=0)
        size = np.full(3, 2 * (self.sf.cutoff + lig.max_span()), np.float32)
        pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                            margin=self.sf.cutoff)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        diff = (f32(lig.orig_coords)[:, None, :]
                - f32(pruned.coords)[None, :, :])
        r = torch.sqrt((diff ** 2).sum(-1))
        heavy = torch.as_tensor(
            ~IS_HYDROGEN[lig.types][:, None]
            & ~IS_HYDROGEN[np.asarray(pruned.types)][None, :], device=dev)
        mask = (r < self.sf.cutoff) & heavy
        pa = {k: v[:, None] for k, v in
              gather_type_params(self.sf.table, lig.types, dev).items()}
        pb = {k: v[None, :] for k, v in
              gather_type_params(self.sf.table, pruned.types, dev).items()}
        qa, qb = f32(lig.charges)[:, None], f32(pruned.charges)[None, :]
        vals = torch.stack([
            torch.where(mask, t.eval(pa, pb, r, qa=qa, qb=qb), 0.0).sum()
            for t in self.sf.pair_terms])
        return [float(v) for v in vals.cpu()]

    # -- local minimization (--minimize / --local_only) -----------------------

    def _prepare(self, rec: Receptor, lig: LigandStruct, center, size):
        """Padded ligand and pruned receptor tensors, the box and the tree
        depth for the general path's energy function."""
        dev = self.device
        pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                            margin=self.sf.cutoff)
        n, m = _round_up(lig.num_atoms, 8), _round_up(lig.num_nodes, 4)
        p = _round_up(max(len(lig.pairs), 1), 32)
        k = _round_up(len(pruned.types), 128)
        lig_d = pad_ligand(lig, n, m, p, device=dev)
        rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges, k,
                             device=dev)
        lo, hi = box_from_center_size(center, size)
        box = Box(lo=torch.as_tensor(lo, device=dev),
                  hi=torch.as_tensor(hi, device=dev))
        max_layers = _round_up(int(lig.layer.max()) if lig.num_nodes > 1
                               else 1, 4)
        return lig_d, rec_d, box, max_layers

    def _build_refine(self, efn: EnergyFn, minpar: MinimizeParams, cap):
        """refine_structure (main.cpp:131-173): up to 5 slope escalations of
        the general-path BFGS, on a batch of one pose."""

        def refine(lig_d, rec_d, conf: Conf, box: Box, dof_mask=None):
            b = conf.position.shape[0]
            dev = conf.position.device
            e = torch.full((b,), MAX_FL, dtype=torch.float32, device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            for i in range(5):
                if bool(done.all()):
                    break
                slope = 10.0 ** (i + 1.0)

                def f(c):
                    return efn.eval_deriv(lig_d, rec_d, c, box, slope, cap)

                def fv(c):
                    with torch.no_grad():
                        return efn.eval_energy(lig_d, rec_d, c, box, slope,
                                               cap)

                res = bfgs(f, conf, minpar, dof_mask, f_val=fv)
                new_done = _inside(lig_d, fk.fk_coords(lig_d, res.x,
                                                       efn.max_layers),
                                   box.lo, box.hi)
                conf = Conf(*[torch.where(done[:, None], old, new)
                              for old, new in zip(conf, res.x)])
                e = torch.where(done, e, res.f0)
                done = done | new_done
            e = torch.where(done, e, torch.full_like(e, MAX_FL))
            return conf, e

        return refine

    # -- CNN objective (non_cache_cnn equivalent) ------------------------------

    def _build_cnn_objective(self, rec: Receptor, box: Box, max_layers: int):
        """CNN loss + out-of-bounds penalties as a differentiable objective
        (reference: non_cache_cnn.cpp:33-169; the JAX engine's
        _build_cnn_objective) over a batch of B poses: `lig` is a
        LigandData with the lane dimension (energy.lane_ligands), one
        ligand per pose; confs may carry leading dimensions before B (the
        line search's trials).  Every evaluation runs CNN_POSE_CHUNK poses
        at a time.

        Returns a dict of:
          center_of(lig, conf) -> (..., 3) heavy centroid
            (set_center_from_model);
          prep(centers (B, 3)) -> receptor grids at those centres (no
            gradient);
          value_p(rec_grids, lig, conf, center, slope, rows=None) -> (...,)
            with prepared grids and centres, one per pose; with rows, conf
            (R, ...) are poses rows of the batch (the lazy line search);
          deriv_p(rec_grids, lig, conf, center, slope) -> (value (B,),
            gradient over the DOF (B, 6+T));
          value(lig, conf, center, slope, rows=None), deriv(lig, conf,
            center, slope): the same with the grids prepared at `center`,
            one per conf;
          value_on_coords(lig, coords, slope) -> (B,) Metropolis energy of
            lab coordinates, centred on each pose's heavy centroid."""
        dev = self.device
        s = self.settings
        margin = self.cnn.max_dimension / 2 + 6.0
        blo, bhi = box.lo.cpu().numpy(), box.hi.cpu().numpy()
        keep = np.all((rec.coords >= blo - margin)
                      & (rec.coords <= bhi + margin), axis=1)
        nk = int(keep.sum())
        pad = _round_up(nk, 256) - nk
        prep_fn, loss_from_grids = self.cnn.make_loss_fn_split(
            np.pad(rec.coords[keep], ((0, pad), (0, 0))),
            np.pad(rec.types[keep], (0, pad)),
            np.pad(np.ones(nk, bool), (0, pad)))
        half_dim = self.cnn.max_dimension / 2.0

        # CNN/empirical mixing (non_cache_cnn.cpp:115-167): blend the
        # empirical inter energy/forces into the minimization objective;
        # mix_emp_force mixes only the gradient (the value stays pure CNN),
        # mix_emp_energy only the value, through detach.  Metropolis
        # (value_on_coords) stays pure CNN, as the reference's eval()
        mix_f, mix_e = s.cnn_mix_emp_force, s.cnn_mix_emp_energy
        emp_w = float(s.cnn_empirical_weight)
        emp_value = None
        if mix_f or mix_e:
            efn = self._make_efn(max_layers)
            pruned = rec.pruned((blo + bhi) / 2, (bhi - blo) / 2,
                                margin=self.sf.cutoff)
            emp_rec_d = pad_receptor(pruned.coords, pruned.types,
                                     pruned.charges,
                                     _round_up(len(pruned.types), 128),
                                     device=dev)

            def emp_value(lig, coords, slope):
                # rec-lig pairwise at box-clamped coords + slope penalty
                # (the emp branch of non_cache_cnn::eval_deriv, :117-137)
                return efn.inter_on_coords(lig, emp_rec_d, coords, box,
                                           slope, float(s.forcecap))

        def mix(cnn_val, emp_val):
            mixed = (cnn_val + emp_w * emp_val) / (1.0 + emp_w)
            if mix_f and mix_e:
                return mixed
            if mix_f:
                return mixed + (cnn_val - mixed).detach()
            return cnn_val + (mixed - cnn_val).detach()

        def centroid(lig, coords):
            h = lig.heavy_mask[..., None]
            cnt = torch.clamp(h.sum(-2), min=1)
            return torch.where(h, coords, 0.0).sum(-2) / cnt

        def cnn_value(rec_grids, lig, coords, center, slope):
            """CNN loss + search-box and CNN-box linear penalties per heavy
            atom, for B poses and their centres."""
            def oob(lo_, hi_):
                d = (coords - torch.minimum(torch.maximum(coords, lo_),
                                            hi_)).abs().sum(-1)
                return torch.where(lig.heavy_mask, d, 0.0).sum(-1)

            c = center[:, None, :]
            pen = slope * (oob(box.lo, box.hi)
                           + oob(c - half_dim, c + half_dim))
            return loss_from_grids(rec_grids, coords, lig.types,
                                   lig.atom_mask, center) + pen

        def flat(conf, rows):
            """conf flattened to R rows, and each row's pose index."""
            lead = conf.position.shape[:-1]
            fc = Conf(*[x.reshape((-1,) + x.shape[len(lead):])
                        for x in conf])
            if rows is None:
                rows = torch.arange(lead[-1], device=dev).repeat(
                    fc.position.shape[0] // lead[-1])
            return lead, fc, rows

        def run(lig, fc, rows, centers, slope, rec_grids=None, grad=False):
            """The objective (and its DOF gradient) of the rows of fc, row
            r a conf of pose rows[r] centred at centers[r], a chunk at a
            time; rec_grids one per pose, or None to prepare them per
            chunk at the rows' centres."""
            t = fc.torsions.shape[-1]
            es, gs = [], []
            for c0 in range(0, len(rows), CNN_POSE_CHUNK):
                sl = slice(c0, c0 + CNN_POSE_CHUNK)
                r = rows[sl]
                lig_r = LigandData(*[x[r] if torch.is_tensor(x) else x
                                     for x in lig])
                c_r = centers[sl]
                g_r = (prep_fn(c_r) if rec_grids is None
                       else tuple(g[r] for g in rec_grids))
                conf_r = Conf(*[x[sl] for x in fc])
                if not grad:
                    coords = fk.fk_coords(lig_r, conf_r, max_layers)
                    v = cnn_value(g_r, lig_r, coords, c_r, slope)
                    if emp_value is not None:
                        v = mix(v, emp_value(lig_r, coords, slope))
                    es.append(v)
                    continue
                eps = torch.zeros((len(r), 6 + t), device=dev,
                                  requires_grad=True)
                with torch.enable_grad():
                    coords = fk.fk_coords(
                        lig_r, fk.conf_with_increment_var(conf_r, eps),
                        max_layers)
                    v = cnn_value(g_r, lig_r, coords, c_r, slope)
                    if emp_value is not None:
                        v = mix(v, emp_value(lig_r, coords, slope))
                    (g,) = torch.autograd.grad(v.sum(), eps)
                es.append(v.detach())
                gs.append(g)
            return (torch.cat(es), torch.cat(gs)) if grad else torch.cat(es)

        def center_of(lig, conf):
            return centroid(lig, fk.fk_coords(lig, conf, max_layers))

        def value_p(rec_grids, lig, conf, center, slope, rows=None):
            lead, fc, rows = flat(conf, rows)
            return run(lig, fc, rows, center[rows], slope,
                       rec_grids).reshape(lead)

        def deriv_p(rec_grids, lig, conf, center, slope):
            return run(lig, conf, torch.arange(conf.position.shape[0],
                                               device=dev), center, slope,
                       rec_grids, grad=True)

        def value(lig, conf, center, slope, rows=None):
            lead, fc, rows = flat(conf, rows)
            return run(lig, fc, rows, center.reshape(-1, 3),
                       slope).reshape(lead)

        def deriv(lig, conf, center, slope):
            return run(lig, conf, torch.arange(conf.position.shape[0],
                                               device=dev), center, slope,
                       grad=True)

        def value_on_coords(lig, coords, slope):
            centers = centroid(lig, coords)
            out = []
            for c0 in range(0, coords.shape[0], CNN_POSE_CHUNK):
                sl = slice(c0, c0 + CNN_POSE_CHUNK)
                lig_r = LigandData(*[x[sl] if torch.is_tensor(x) else x
                                     for x in lig])
                out.append(cnn_value(prep_fn(centers[sl]), lig_r,
                                     coords[sl], centers[sl], slope))
            return torch.cat(out)

        return {"value": value, "deriv": deriv, "center_of": center_of,
                "value_on_coords": value_on_coords, "prep": prep_fn,
                "value_p": value_p, "deriv_p": deriv_p}

    def _cnn_refine(self, cnn_obj, lig: LigandData, conf: Conf, box: Box,
                    minpar: MinimizeParams, max_layers: int) -> Conf:
        """refine_structure with the CNN objective (the JAX engine's
        _cnn_refine) over a batch of poses: the centre fixed at each
        starting pose's heavy centroid, so the receptor grids are prepared
        once for all 5 slope stages; a pose is done once its heavy atoms
        lie inside the CNN box OR the search box (non_cache_cnn::within)."""
        with torch.no_grad():
            center = cnn_obj["center_of"](lig, conf)
            rec_g = cnn_obj["prep"](center)
        half_dim = self.cnn.max_dimension / 2.0
        c = center[:, None, :]
        done = torch.zeros(conf.position.shape[0], dtype=torch.bool,
                           device=center.device)
        for i in range(5):
            if bool(done.all()):
                break
            slope_i = 10.0 ** (i + 1.0)

            def f(c_):
                return cnn_obj["deriv_p"](rec_g, lig, c_, center, slope_i)

            def fv(c_, rows=None):
                return cnn_obj["value_p"](rec_g, lig, c_, center, slope_i,
                                          rows)

            res = bfgs(f, conf, minpar, f_val=fv, lazy_trials=True)
            with torch.no_grad():
                coords = fk.fk_coords(lig, res.x, max_layers)
            new_done = (_inside(lig, coords, box.lo, box.hi)
                        | _inside(lig, coords, c - half_dim, c + half_dim))
            conf = Conf(*[torch.where(done[:, None], old, new)
                          for old, new in zip(conf, res.x)])
            done = done | new_done
        return conf

    def minimize(self, rec: Receptor, lig: LigandStruct,
                 center=None, size=None) -> PoseResult:
        """--minimize / --local_only refinement from the input pose
        (main.cpp:271-311), through the general path's BFGS (ops/bfgs.py)
        over the autograd energy.  Both modes derive the box from the
        movable atoms (main.cpp:1465-1478); they differ in minimizer
        defaults: --minimize converges (10000 accurate-line-search iters),
        plain --local_only uses the fast line search and the (25+natoms)/3
        heuristic (settings.local_only); simple_ascent replaces the BFGS by
        the legacy steepest descent (ops/ssd.py).  With a scorer under
        refinement, metrorefine or all the CNN objective refines instead
        (_cnn_refine)."""
        s = self.settings
        center, size = self._movable_box(lig, center, size)
        dev = self.device
        lig_d, rec_d, box, max_layers = self._prepare(rec, lig, center, size)
        efn = self._make_efn(max_layers)
        t = lig.num_torsions
        tp = lig_d.num_torsion_slots
        conf0 = Conf(*[x[None] for x in initial_conf(lig, tp, device=dev)])
        ar = torch.arange(6 + tp, device=dev)
        dof_mask = (ar < 6 + t) & (ar >= (0 if lig.has_rigid_dof else 6))
        cap = [float(s.forcecap)] * 3
        minpar = self._minimize_params(lig)
        if s.simple_ascent:
            # main.cpp:1189-1191
            minpar = dataclasses.replace(minpar, type="simple")
        if self._has_cnn and s.cnn_scoring in ("refinement", "metrorefine",
                                               "all"):
            cnn_obj = self._build_cnn_objective(rec, box, max_layers)
            conf = self._cnn_refine(
                cnn_obj, lane_ligands([lig_d], torch.zeros(
                    1, dtype=torch.long, device=dev)), conf0, box, minpar,
                max_layers)
        else:
            refine = self._build_refine(efn, minpar, cap)
            conf, _e = refine(lig_d, rec_d, conf0, box, dof_mask)
        with torch.no_grad():
            big = Box(lo=torch.full((3,), -1e8, device=dev),
                      hi=torch.full((3,), 1e8, device=dev))
            inter, intra = exact_split(efn, lig_d, rec_d, conf, big, 0.0, cap)
            coords = fk.fk_coords(lig_d, conf, max_layers)[0]
        coords = coords.cpu().numpy()[:lig.num_atoms]
        e = float(self._conf_independent(lig, float(inter[0])))
        heavy = lig_d.heavy_mask.cpu().numpy()[:lig.num_atoms]
        rmsd = float(np.sqrt(((coords[heavy] - lig.orig_coords[heavy]) ** 2)
                             .sum(axis=1).mean()))
        lo_b, hi_b = box.lo.cpu().numpy(), box.hi.cpu().numpy()
        within = bool(np.all((coords[heavy] >= lo_b - 1e-4)
                             & (coords[heavy] <= hi_b + 1e-4)))
        cnnscore = cnnaff = cnnvar = 0.0
        if self._has_cnn:
            cnnscore, cnnaff, cnnvar = self.cnn.score_pose(rec, lig, coords)
        return PoseResult(
            energy=e, intramol=float(intra[0]), cnnscore=cnnscore,
            cnnaffinity=cnnaff, cnnvariance=cnnvar, coords=coords,
            conf_position=conf.position[0].cpu().numpy(),
            conf_orientation=conf.orientation[0].cpu().numpy(),
            conf_torsions=conf.torsions[0].cpu().numpy()[:t],
            rmsd=rmsd, within_box=within)

    def _movable_box(self, lig: LigandStruct, center, size):
        """The given box, or movable_atoms_box with the autobox_add margin
        (main.cpp:1465-1478)."""
        if center is None:
            lo = lig.orig_coords.min(axis=0) - self.settings.autobox_add
            hi = lig.orig_coords.max(axis=0) + self.settings.autobox_add
            center, size = (lo + hi) / 2, hi - lo
        return center, size

    def _minimize_params(self, lig: LigandStruct) -> MinimizeParams:
        """--minimize converges (10000 accurate-line-search iterations);
        plain --local_only takes the fast line search and the (25+natoms)/3
        heuristic, unless the settings name others."""
        s = self.settings
        if s.local_only:
            iters = (s.minimize_iters if s.minimize_iters > 0
                     else _minimize_iters_heuristic(lig, s))
            ls_type = "accurate" if s.accurate_line_search else "fast"
        else:
            iters = s.minimize_iters if s.minimize_iters > 0 else 10000
            ls_type = "accurate"
        return MinimizeParams(maxiters=min(iters, 10000), type=ls_type,
                              early_term=s.minimize_early_term)

    def minimize_trajectory(self, rec: Receptor, lig: LigandStruct,
                            center=None, size=None) -> np.ndarray:
        """--outputmin N (main.cpp:1005, bfgs.h:244-310): all-atom frames
        of the minimization trajectory, N+1 interpolated frames per
        accepted quasi-Newton step (factor 0..1 inclusive, bfgs.h:302-310).

        Captures the slope=10 quasi-Newton run (refine_structure's first
        escalation, main.cpp:131-173): for in-box input poses that is the
        run whose minout.sdf survives in the reference (each escalation
        reopens and truncates the file).  Returns (F, num_atoms, 3)
        float32."""
        s = self.settings
        nframes = s.outputmin_frames
        center, size = self._movable_box(lig, center, size)
        dev = self.device
        lig_d, rec_d, box, max_layers = self._prepare(rec, lig, center, size)
        efn = self._make_efn(max_layers)
        tp = lig_d.num_torsion_slots
        conf0 = Conf(*[x[None] for x in initial_conf(lig, tp, device=dev)])
        cap = [float(s.forcecap)] * 3
        minpar = self._minimize_params(lig)
        slope = 10.0

        def f(c):
            return efn.eval_deriv(lig_d, rec_d, c, box, slope, cap)

        def fv(c):
            with torch.no_grad():
                return efn.eval_energy(lig_d, rec_d, c, box, slope, cap)

        _res, hist, n = bfgs(f, conf0, minpar, f_val=fv,
                             traj_cap=min(minpar.maxiters, 128))
        n = int(n[0])
        row0, row1 = hist[0, :n, None], hist[0, 1:n + 1, None]  # (n, 1, R)
        fac = (torch.arange(nframes + 1, dtype=torch.float32, device=dev)
               / max(nframes, 1))[:, None]                       # (F, 1)
        q0 = row0[..., 3:7]
        v = Q.quaternion_to_rotvec(Q.qmul(row1[..., 3:7], Q.qconj(q0)))
        dt = Q.normalize_angle(row1[..., 7:] - row0[..., 7:])
        conf = Conf(
            position=row0[..., :3] + fac * (row1[..., :3] - row0[..., :3]),
            orientation=Q.qnormalize_approx(
                Q.qmul(Q.rotvec_to_quaternion(fac * v), q0)),
            torsions=Q.normalize_angle(row0[..., 7:] + fac * dt))
        with torch.no_grad():
            coords = fk.fk_coords(lig_d, conf, max_layers)   # (n, F, N, 3)
        coords = coords.reshape(-1, coords.shape[-2], 3).cpu().numpy()
        return coords[:, :lig.num_atoms]

    # -- randomize only -------------------------------------------------------

    def randomize(self, rec: Receptor, lig: LigandStruct, center, size,
                  seed: int = 0, attempts: int = 100,
                  generator: Optional[torch.Generator] = None) -> PoseResult:
        """--randomize_only (main.cpp:100-129): of `attempts` random confs
        (position in the box, random orientation and torsions) the one with
        the least pairwise clash penalty.  Draws come from `generator`, a
        CPU torch.Generator; without one, from a generator seeded with
        `seed`."""
        dev = self.device
        lig_d, _rec_d, box, max_layers = self._prepare(rec, lig, center, size)
        tp = lig_d.num_torsion_slots
        if generator is None:
            generator = torch.Generator(device="cpu")
            generator.manual_seed(int(seed))
        pos, quat, tors = mc.randomize_conf(attempts, box.lo.cpu(),
                                            box.hi.cpu(), tp, generator,
                                            device=dev)
        confs = Conf(pos, quat, tors)
        pens = self.clash_penalty(lig_d, confs, max_layers)
        best = int(torch.argmin(pens))
        conf = Conf(*[x[best] for x in confs])
        with torch.no_grad():
            coords = fk.fk_coords(lig_d, conf, max_layers)
        coords = coords.cpu().numpy()[:lig.num_atoms]
        return PoseResult(
            energy=float(pens[best]), intramol=0.0, cnnscore=-1.0,
            cnnaffinity=0.0, cnnvariance=0.0, coords=coords,
            conf_position=conf.position.cpu().numpy(),
            conf_orientation=conf.orientation.cpu().numpy(),
            conf_torsions=conf.torsions.cpu().numpy()[:lig.num_torsions])

    def clash_penalty(self, lig_d: LigandData, confs: Conf, max_layers: int):
        """model.cpp:1173-1201 over a batch of confs: per intra-ligand pair
        1 - (r/cov_r)^2/4, zero beyond twice the covalent distance."""
        cov = torch.as_tensor(
            np.asarray(self.sf.table.covalent_radius, np.float32),
            device=lig_d.types.device)[lig_d.types]
        with torch.no_grad():
            coords = fk.fk_coords(lig_d, confs, max_layers)
            ca = coords[..., lig_d.pair_a, :]
            cb = coords[..., lig_d.pair_b, :]
            r = torch.sqrt(torch.clamp(torch.sum((ca - cb) ** 2, dim=-1),
                                       min=1e-12))
            cr = cov[lig_d.pair_a] + cov[lig_d.pair_b]
            x = r / torch.clamp(cr, min=1e-6)
            pen = torch.where(x > 2.0, 0.0, 1.0 - x * x / 4.0)
            return torch.sum(torch.where(lig_d.pair_mask, pen, 0.0), dim=-1)

    # -- full docking ---------------------------------------------------------

    def dock(self, rec: Receptor, lig: LigandStruct, center, size,
             seed: Optional[int] = None) -> List[PoseResult]:
        return self.dock_batch(rec, [lig], center, size, seed=seed)[0]

    def dock_batch(self, rec: Receptor, ligs: List[LigandStruct], center,
                   size, seed: Optional[int] = None,
                   mesh=None) -> List[List[PoseResult]]:
        """Dock a batch of ligands against one receptor/box: (ligands x
        exhaustiveness) MC chains run as one lane axis on the device.  All
        ligands share the MC step count (max of the per-ligand heuristics,
        main.cpp:449-456) so the batch stays rectangular.

        mesh: an optional parallel.mesh.Mesh.  The ligand list is padded to
        a multiple of its "dp" size (with copies of the last ligand, whose
        results are dropped) and split into dp contiguous shards, each
        docked on its row's first device, from its own thread, with no
        communication until the results are gathered (the JAX engine's
        shard_map, gnina_tpu/docking.py:794-816).  Every random number is
        drawn once for the whole batch, in the unsharded run's order, and
        each shard takes its lanes' share: the chain heads and host-driven
        draws by slicing, the in-kernel windows' seeds whole with the
        shard's first global lane as the kernels' lane_offset.  So a
        sharded dock equals the unsharded one wherever the lanes do not
        interact, that is at fused_done_frac = 1 (K8 couples groups of 128
        lanes, which a shard boundary splits otherwise)."""
        if not ligs:
            raise ValueError("empty ligand batch")
        n_real = len(ligs)
        trace.count("dock.batches")
        trace.count("dock.ligands", n_real)
        trace.count("dock.lanes", n_real * self.settings.exhaustiveness)
        if mesh is not None:
            dp = mesh.shape["dp"]
            ligs = list(ligs) + [ligs[-1]] * ((-len(ligs)) % dp)
        if not self._fused_route(ligs):
            return self._dock_general(rec, ligs, center, size, seed,
                                      mesh)[:n_real]
        return self._dock_fused(rec, ligs, center, size, seed,
                                mesh)[:n_real]

    def _shard_devices(self, mesh) -> List[torch.device]:
        """One device per shard: each "dp" row's first device, or the
        engine's own without a mesh."""
        if mesh is None:
            return [self.device]
        return [torch.device(mesh.devices[i, 0])
                for i in range(mesh.shape["dp"])]

    def _dock_fused(self, rec: Receptor, ligs: List[LigandStruct], center,
                    size, seed: Optional[int], mesh) -> List[List[PoseResult]]:
        """dock_batch on the fused route (the kernels K1-K8)."""
        s = self.settings
        dev = self.device
        n = _round_up(max(l.num_atoms for l in ligs), 8)
        m = _round_up(max(l.num_nodes for l in ligs), 4)
        p = _round_up(max(max(len(l.pairs) for l in ligs), 1), 32)
        max_layers = _round_up(max(int(l.layer.max()) if l.num_nodes > 1
                                   else 1 for l in ligs), 4)
        pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                            margin=self.sf.cutoff)
        kr = len(pruned.types)
        lo, hi = box_from_center_size(center, size)
        num_steps = max(_num_steps_heuristic(l, s) for l in ligs)
        miniters = max(_minimize_iters_heuristic(l, s) for l in ligs)
        num_out = max(s.num_modes, s.num_mc_saved)
        e = s.exhaustiveness
        lanes = len(ligs) * e
        devices = self._shard_devices(mesh)
        dp = len(devices)
        gps = len(ligs) // dp                   # ligands a shard
        occ = self._k3_occupancy(devices[0], n, m, kr) \
            if self._runs_k3(ligs) else None
        if occ is not None:
            # the cards' K3 slots: their fill is dock.lanes / screen.slots
            trace.count("screen.slots", occ[0] * occ[1] * dp)

        # window schedule: the JAX package's arithmetic (docking.py:994-1051)
        base_chunk = int(s.mc_chunk_steps) or num_steps
        chunk = min(num_steps, max(32, base_chunk * 128 // max(lanes, 128)))
        mcs = 0
        if s.fused_mc_in_kernel:
            mcs = max(int(s.fused_mc_steps) or 16, 1)
            if not s.fused_async_mc:
                mcs = min(mcs, 16)  # lockstep windows stay at 16 steps
            mcs = min(mcs, max(num_steps // 8, 16))
            if s.fused_async_mc:
                mcs = _async_mc_steps_guard(mcs, m)
            chunk = max(((chunk + mcs - 1) // mcs) * mcs, mcs)
        r_every = int(s.fused_refine_every) or max(32, num_steps // 16)
        refine_subs = max(1, mcs // max(r_every, 1))
        while mcs % refine_subs:
            refine_subs -= 1
        n_chunks = -(-num_steps // chunk)

        common = dict(num_trials=s.fused_ls_trials,
                      ls_factor=s.fused_ls_factor, async_ls=s.fused_async_ls,
                      done_frac=s.fused_done_frac)
        mcpar = mc.MCParams(temperature=s.temperature,
                            num_saved_mins=num_out,
                            refine_stride=s.refine_stride)
        hc = mcpar.hunt_cap
        slope = 1e3

        with trace.span("dock.pack"):
            pack = fd.build_pack(ligs, pruned.coords, pruned.types,
                                 np.ones(kr, np.float32), e, self.sf.table,
                                 m_pad=m, device=devices[0], shards=dp)
            # every draw of the batch, in the unsharded run's order: the
            # chain heads, then each chunk's window seeds (in-kernel
            # windows) or step draws (host-driven steps), handed to the
            # shards chunk by chunk
            gen = torch.Generator(device="cpu")
            gen.manual_seed(int(seed if seed is not None else s.seed))
            all_lanes = pack.real_lanes()
            with torch.no_grad():
                carry = mc.mc_init(lanes, m, mcpar, lo, hi, pack.dims[0],
                                   gen, lambda r, t: fd.fk_packed(
                                       r, t, all_lanes), device=devices[0])
        if s.fused_mc_in_kernel:
            def draw_chunk(_k):
                return [int(torch.randint(0, 1 << 30, (1,), generator=gen))
                        for _ in range(chunk // mcs)]
        else:
            meta_all = mc_fused.lane_meta(all_lanes)

            def draw_chunk(_k):
                return [(mc.draw_mutation(gen, meta_all.ntors,
                                          meta_all.has_rigid, device="cpu"),
                         torch.rand(lanes, generator=gen,
                                    dtype=torch.float32))
                        for _ in range(chunk)]
        draws = _SharedDraws(draw_chunk, dp)

        def run_shard(i: int):
            sdev = devices[i]
            l0, l1 = i * gps * e, (i + 1) * gps * e
            pk = pack.shard(i, dp).to(sdev) if dp > 1 else pack
            meta = mc_fused.lane_meta(pk)
            # second lane layout for the finish stages: one lane per saved
            # pose
            pack_out = pk.with_lanes(torch.arange(
                gps, device=sdev, dtype=torch.int32).repeat_interleave(
                    num_out))
            heavy_g = torch.as_tensor(pk.heavy_idx >= 0, device=sdev)
            fused_ref = fd.FusedBfgs(self.sf, pk, miniters, want_metro=True,
                                     **common)
            fused_out = fd.FusedBfgs(self.sf, pack_out, miniters,
                                     want_metro=False, **common)
            fused_mc = None
            if s.fused_mc_in_kernel:
                fused_mc = fd.FusedBfgs(
                    self.sf, pk, miniters, want_metro=True, mc_steps=mcs,
                    tick_budget=s.fused_mc_tick_budget,
                    async_mc=s.fused_async_mc, warm_ls=s.fused_warm_ls,
                    lane_offset=l0, lane_total=lanes, **common)
            scal_h = fd.scal_vector(hc[0], hc[1], slope, 1000.0, lo, hi,
                                    mcpar.mutation_amplitude,
                                    mcpar.temperature, device=sdev)
            scal_f = fd.scal_vector(1000.0, 1000.0, slope, 1000.0, lo, hi,
                                    device=sdev)
            with torch.no_grad():
                with trace.span("dock.search", device=sdev,
                                lanes=l1 - l0, chunks=n_chunks):
                    c = _carry_slice(carry, l0, l1, sdev)
                    for k in range(n_chunks):
                        dr = draws.get(k)
                        if fused_mc is not None:
                            c = mc_fused.fused_mc_chunk_inkernel(
                                c, None, chunk, fused_mc, fused_ref, pk,
                                scal_h, scal_f, meta, mcpar, m - 1,
                                refine_subs=refine_subs, seeds=dr)
                        else:
                            c = mc_fused.fused_mc_chunk(
                                c, None, chunk, fused_ref, pk, scal_h, scal_f,
                                meta, mcpar, m - 1, draws=[
                                    (mc.MutationDraws(*[x[l0:l1].to(sdev)
                                                        for x in md]),
                                     u[l0:l1].to(sdev)) for md, u in dr])
                        if self.progress is not None and i == 0:
                            self.progress(
                                f"MC {min((k + 1) * chunk, num_steps)}/"
                                f"{num_steps} steps ({len(ligs)} ligand(s) x "
                                f"{s.exhaustiveness} chains)")
                with trace.span("dock.finish", device=sdev):
                    # merge: per-ligand top num_out over all chains
                    # (min_rmsd 2)
                    conts = mc.PoseContainer(
                        *[x.reshape((gps, e) + x.shape[1:]) for x in c.cont])
                    merged = mc.merge_containers(conts, heavy_g, 2.0, num_out)
                    mconf = Conf(position=merged.position.reshape(-1, 3),
                                 orientation=merged.orientation.reshape(-1, 4),
                                 torsions=merged.torsions.reshape(-1, m - 1))
                    rigid, tors = fd.conf_to_packed(mconf, m)
                    mdone = torch.zeros(gps * num_out, dtype=torch.bool,
                                        device=sdev)

                    # refine_structure stages (main.cpp:144-158): authentic-v
                    # BFGS at box slope 10^(i+1), one lane per (ligand, saved
                    # pose)
                    cap_v = float(s.forcecap)
                    heavy_out = pack_out.ap[pack_out.lane_lig.long(), :, 4] > 0
                    lo_t = torch.as_tensor(lo, device=sdev)
                    hi_t = torch.as_tensor(hi, device=sdev)
                    for stage_i in range(5):
                        scal = fd.scal_vector(cap_v, cap_v,
                                              10.0 ** (stage_i + 1), cap_v,
                                              lo, hi, device=sdev)
                        org, otr, _stats, coords_h = fused_out(rigid, tors,
                                                               scal)
                        margin = 0.0001
                        ok = ((coords_h >= lo_t - margin)
                              & (coords_h <= hi_t + margin)).all(-1)
                        new_done = torch.where(heavy_out, ok, True).all(-1)
                        rigid = torch.where(mdone[:, None], rigid, org)
                        tors = torch.where(mdone[:, None], tors, otr)
                        mdone = mdone | new_done

                    # exact rescore (always the empirical affinity,
                    # main.cpp:336-343) through K1
                    inter, intra = self._exact_energies(rigid, tors, pack_out,
                                                        lo, hi, 1e3)
            return rigid, tors, inter, intra, merged.energy

        parts = _run_shards(devices, run_shard)
        with torch.no_grad(), trace.span("dock.assemble"):
            rigid = torch.cat([x[0].to(dev) for x in parts])
            tors = torch.cat([x[1].to(dev) for x in parts])
            return self._assemble(
                rec, ligs, fd.packed_to_conf(rigid, tors, m - 1),
                np.concatenate([x[2] for x in parts]),
                np.concatenate([x[3] for x in parts]),
                torch.cat([x[4].cpu() for x in parts]), n, m, p, max_layers,
                num_out)

    # -- the general path ---------------------------------------------------

    def _populate_cache(self, ligs, rec_d, lo, hi, num_slots: int = 16):
        """The per-type search grids for this receptor and box
        (cache::populate, cache.cpp:104-184), shared by the ligand batch;
        None (analytic search) when the ligands hold more movable heavy
        types than slots."""
        types = sorted({int(t) for l in ligs for t in l.types
                        if int(t) > 1})  # movable non-hydrogen types
        if len(types) > num_slots:
            return None
        slot_of_type = np.zeros(28, np.int64)
        gridded = np.zeros(28, bool)
        slot_types = np.zeros(num_slots, np.int64)
        for i, t in enumerate(types):
            slot_of_type[t] = i
            gridded[t] = True
            slot_types[i] = t
        npts = cg.grid_shape_for(lo, hi)
        populate = cg.make_populate_fn(self.sf, npts, num_slots,
                                       self.sf.has_charge_terms)
        with torch.no_grad():
            grids = populate(rec_d, lo, hi, torch.as_tensor(
                slot_types, device=rec_d.coords.device), slot_of_type,
                gridded)
            if self.user_grid is not None:
                # fold the user-grid bias into every type slot
                # (cache.cpp:177)
                from gnina_tpu_torch.ops.user_grid import \
                    user_values_on_lattice

                uv = user_values_on_lattice(self.user_grid, lo,
                                            cg.GRANULARITY, npts)
                data = grids.data + uv.to(grids.data.device)[None]
                grids = grids._replace(data=data, cells=cg._make_cells(data))
        return grids

    @staticmethod
    def _energy_fns_for(efn: EnergyFn, lig_l: LigandData,
                        rec_d: ReceptorData, box: Box, grids, max_layers,
                        slope: float = 1e3, cnn_obj=None,
                        cnn_metro: bool = False, cnn_search: bool = False):
        """The MC chunk's energy functions over the lane axis: the search
        grids' trilinear inter energy plus the exact intra pairs when there
        are grids (do_search passes the cache as the search igrid,
        main.cpp:504), else the exact energy; Metropolis on the inter-only
        energy at authentic v (update_energy, monte_carlo.cpp:44-47).
        cnn_metro: Metropolis on the CNN objective (value_on_coords);
        cnn_search: the BFGS on it too, its gradient at each conf's own
        heavy centroid (the JAX engine's energy_fns_for,
        docking.py:1347-1362)."""
        fns = {
            "eval_deriv": lambda conf, v: efn.eval_deriv(
                lig_l, rec_d, conf, box, slope, v),
            "eval_energy": lambda conf, v: efn.eval_energy(
                lig_l, rec_d, conf, box, slope, v),
            "metro_on_coords": lambda coords: efn.inter_on_coords(
                lig_l, rec_d, coords, box, slope, 1000.0),
        }
        if grids is not None:
            def grid_inter(coords, v1):
                return cg.cache_inter_energy(grids, coords, lig_l.types,
                                             lig_l.charges, lig_l.heavy_mask,
                                             slope, v1)

            def grid_total(conf, v):
                coords = fk.fk_coords(lig_l, conf, max_layers)
                return (grid_inter(coords, v[1])
                        + efn.pairs_on_coords(lig_l, coords, v[0], v[2]))

            def grid_deriv(conf, v):
                t = conf.torsions.shape[-1]
                eps = torch.zeros(conf.position.shape[:-1] + (6 + t,),
                                  device=conf.position.device,
                                  requires_grad=True)
                with torch.enable_grad():
                    e = grid_total(fk.conf_with_increment_var(conf, eps), v)
                    (g,) = torch.autograd.grad(e.sum(), eps)
                return e.detach(), g

            fns["eval_deriv"] = grid_deriv
            fns["eval_energy"] = grid_total
            fns["metro_on_coords"] = lambda coords: grid_inter(coords, 1000.0)
        if cnn_metro:
            fns["metro_on_coords"] = lambda coords: cnn_obj[
                "value_on_coords"](lig_l, coords, slope)
        if cnn_search:
            fns["eval_deriv"] = lambda conf, v: cnn_obj["deriv"](
                lig_l, conf, cnn_obj["center_of"](lig_l, conf), slope)
            fns["eval_energy"] = lambda conf, v: cnn_obj["value"](
                lig_l, conf, cnn_obj["center_of"](lig_l, conf), slope)
        return fns

    def _dock_general(self, rec: Receptor, ligs: List[LigandStruct], center,
                      size, seed: Optional[int],
                      mesh=None) -> List[List[PoseResult]]:
        """dock_batch on the general path (the JAX engine's XLA programs:
        init_fn, chunk_fn over mc.mc_chunk, merge_fn, stage_fn_xla,
        rescore_fn; docking.py:1273-1662), every ligand's chains on one
        lane axis; under a mesh one lane axis a shard, as in _dock_fused.
        The CNN in the loop runs on the scorer's device, so every shard of
        such a job must lie there."""
        s = self.settings
        dev = self.device
        g, e = len(ligs), s.exhaustiveness
        lanes = g * e
        devices = self._shard_devices(mesh)
        dp = len(devices)
        gps = g // dp
        n = _round_up(max(l.num_atoms for l in ligs), 8)
        m = _round_up(max(l.num_nodes for l in ligs), 4)
        p = _round_up(max(max(len(l.pairs) for l in ligs), 1), 32)
        tp = m - 1
        # the tree's own depth: FK layers past it change nothing (the JAX
        # package rounds it up to 4 to share compiled programs)
        max_layers = max(int(l.layer.max()) if l.num_nodes > 1 else 1
                         for l in ligs)
        pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                            margin=self.sf.cutoff)
        lo, hi = box_from_center_size(center, size)
        q = _round_up(max(len(l.other_pairs) if l.other_pairs is not None
                          else 0 for l in ligs), 32)
        num_steps = max(_num_steps_heuristic(l, s) for l in ligs)
        miniters = max(_minimize_iters_heuristic(l, s) for l in ligs)
        num_out = max(s.num_modes, s.num_mc_saved)
        base_chunk = int(s.mc_chunk_steps) or num_steps
        chunk = min(num_steps, max(32, base_chunk * 64 // max(lanes, 64)))
        n_chunks = -(-num_steps // chunk)
        minpar = MinimizeParams(
            maxiters=miniters,
            type=("simple" if s.simple_ascent
                  else "accurate" if s.accurate_line_search else "fast"),
            early_term=s.minimize_early_term)
        # --minimize_single_full (main.cpp:987, monte_carlo.cpp:117-133):
        # minimise at full v from the start and skip the separate full-v
        # refinement of promising poses
        hunt = ((1000.0, 1000.0, 1000.0) if s.minimize_single_full
                else mc.MCParams.hunt_cap)
        stride = (max(chunk, 1 << 20) if s.minimize_single_full
                  else s.refine_stride)
        mcpar = mc.MCParams(
            temperature=s.temperature, num_saved_mins=num_out,
            hunt_cap=hunt, refine_stride=stride, minparams=minpar)
        cap = [float(s.forcecap)] * 3
        efn = self._make_efn(max_layers)
        # CNN-in-the-loop modes (user_opts.h:24-31): the CNN drives
        # Metropolis under every one, refines the saved poses under
        # refinement, metrorefine and all, and is the MC BFGS objective
        # under all (which then searches without grids)
        mode = s.cnn_scoring if self._has_cnn else "none"
        cnn_search = mode == "all"
        cnn_refine = mode in ("refinement", "metrorefine", "all")
        if mode in _CNN_MODES and any(d != dev for d in devices):
            raise ValueError("the CNN in the loop runs on the engine's "
                             f"device {dev}: a mesh must name only it")

        def lane_data(sdev, sub):
            """The padded ligands of `sub` and their lane view on sdev."""
            lig_ds = [pad_ligand(l, n, m, p, q_pad=q, device=sdev)
                      for l in sub]
            lane_lig = torch.arange(len(sub), device=sdev).repeat_interleave(
                e)
            return lig_ds, lane_lig, lane_ligands(lig_ds, lane_lig)

        # every draw of the batch, in the unsharded run's order: the chain
        # heads, then each chunk's step draws, handed to the shards chunk
        # by chunk (mc.chain_steps draws a step's mutation, then its
        # Metropolis uniforms)
        ntors_all = torch.as_tensor([l.num_torsions for l in ligs]
                                    ).repeat_interleave(e)
        rigid_all = torch.as_tensor([l.has_rigid_dof for l in ligs]
                                    ).repeat_interleave(e)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed if seed is not None else s.seed))
        with torch.no_grad():
            lig_all = lane_data(devices[0], ligs)[2]
            carry = mc.mc_init(lanes, m, mcpar, lo, hi, n, gen,
                               lambda r, t: fk.fk_coords(
                                   lig_all, fd.packed_to_conf(r, t, tp),
                                   max_layers), device=devices[0])
            del lig_all

        def draw_chunk(_k):
            return [(mc.draw_mutation(gen, ntors_all, rigid_all,
                                      device="cpu"),
                     torch.rand(lanes, generator=gen, dtype=torch.float32))
                    for _ in range(chunk)]

        draws = _SharedDraws(draw_chunk, dp)

        def run_shard(i: int):
            sdev = devices[i]
            l0, l1 = i * gps * e, (i + 1) * gps * e
            sub = ligs[i * gps:(i + 1) * gps]
            rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges,
                                 _round_up(len(pruned.types), 128),
                                 device=sdev)
            box = Box(lo=torch.as_tensor(lo, device=sdev),
                      hi=torch.as_tensor(hi, device=sdev))
            lig_ds, lane_lig, lig_l = lane_data(sdev, sub)
            ar = torch.arange(6 + tp, device=sdev)
            dof_mask = torch.stack([
                (ar < 6 + l.num_torsions)
                & (ar >= (0 if l.has_rigid_dof else 6)) for l in sub])[
                    lane_lig]
            ntors = ntors_all[l0:l1].to(sdev)
            has_rigid = rigid_all[l0:l1].to(sdev)
            cnn_obj = (self._build_cnn_objective(rec, box, max_layers)
                       if mode in _CNN_MODES else None)
            # the search grids of every ligand type in the batch, so each
            # shard searches the grids of the unsharded run
            grids = (self._populate_cache(ligs, rec_d, lo, hi)
                     if s.search_grid and not cnn_search else None)
            fns = self._energy_fns_for(efn, lig_l, rec_d, box, grids,
                                       max_layers, cnn_obj=cnn_obj,
                                       cnn_metro=cnn_obj is not None,
                                       cnn_search=cnn_search)
            with torch.no_grad():
                c = _carry_slice(carry, l0, l1, sdev)
                for k in range(n_chunks):
                    dr = [(mc.MutationDraws(*[x[l0:l1].to(sdev)
                                              for x in md]),
                           u[l0:l1].to(sdev)) for md, u in draws.get(k)]
                    c = mc.mc_chunk(c, None, chunk, lig_l, fns, mcpar,
                                    max_layers, dof_mask, ntors, has_rigid,
                                    draws=dr)
                    if self.progress is not None and i == 0:
                        self.progress(
                            f"MC {min((k + 1) * chunk, num_steps)}/"
                            f"{num_steps} steps ({g} ligand(s) x {e} "
                            "chains)")

                # merge: per-ligand top num_out over all chains (min_rmsd 2)
                conts = mc.PoseContainer(*[x.reshape((gps, e) + x.shape[1:])
                                           for x in c.cont])
                heavy_g = torch.stack([l.heavy_mask for l in lig_ds])
                merged = mc.merge_containers(conts, heavy_g, 2.0, num_out)
                conf = Conf(position=merged.position.reshape(-1, 3),
                            orientation=merged.orientation.reshape(-1, 4),
                            torsions=merged.torsions.reshape(-1, tp))
                out_lig = torch.arange(gps, device=sdev).repeat_interleave(
                    num_out)

                # refine_structure stages (main.cpp:144-158) on the exact
                # energy or the CNN objective, the saved poses only (an
                # empty slot's result is never read)
                sel = torch.nonzero(merged.energy.reshape(-1) < MAX_FL)[:, 0]
                if len(sel):
                    lig_v = lane_ligands(lig_ds, out_lig[sel])
                    conf_v = self._stages(efn, lig_v, rec_d, box, minpar,
                                          cap, Conf(*[x[sel] for x in conf]),
                                          cnn_obj if cnn_refine else None)
                    conf = Conf(*[x.index_copy(0, sel, y)
                                  for x, y in zip(conf, conf_v)])
                lig_out = lane_ligands(lig_ds, out_lig)
                inter, intra = exact_split(efn, lig_out, rec_d, conf, box,
                                           1e3, cap)
            return conf, inter.cpu().numpy(), intra.cpu().numpy(), \
                merged.energy.cpu()

        parts = _run_shards(devices, run_shard)
        conf = Conf(*[torch.cat([x[0][j].to(dev) for x in parts])
                      for j in range(3)])
        with torch.no_grad(), trace.span("dock.assemble"):
            return self._assemble(
                rec, ligs, conf, np.concatenate([x[1] for x in parts]),
                np.concatenate([x[2] for x in parts]),
                torch.cat([x[3] for x in parts]), n, m, p, max_layers,
                num_out)

    def _stages(self, efn: EnergyFn, lig_v: LigandData, rec_d: ReceptorData,
                box: Box, minpar: MinimizeParams, cap, conf: Conf,
                cnn_obj=None) -> Conf:
        """The five slope-escalation stages of refine_structure
        (main.cpp:144-158, the JAX engine's stage_fn_xla): BFGS at box slope
        10^(i+1) on the exact energy, each pose frozen once its heavy atoms
        lie in the box (a frozen pose is not minimised again: its result
        would be discarded).  With cnn_obj the CNN objective takes the exact
        energy's place: each stage centres every pose's grids on its heavy
        centroid at the stage's start and prepares the receptor grids once
        for its BFGS, CNN_STAGE_CHUNK poses at a time, the line search's
        trials evaluated lazily (ops/bfgs.fast_line_search); a pose is done
        by the search box alone, as in stage_fn_xla."""
        max_layers = efn.max_layers
        done = torch.zeros(conf.position.shape[0], dtype=torch.bool,
                           device=conf.position.device)
        chunk = CNN_STAGE_CHUNK if cnn_obj is not None else max(len(done), 1)
        for i in range(5):
            live_all = torch.nonzero(~done)[:, 0]
            slope_i = 10.0 ** (i + 1)
            for c0 in range(0, len(live_all), chunk):
                live = live_all[c0:c0 + chunk]
                lig_i = LigandData(*[x[live] if torch.is_tensor(x) else x
                                     for x in lig_v])
                conf_i = Conf(*[x[live] for x in conf])
                if cnn_obj is None:
                    def f(c):
                        return efn.eval_deriv(lig_i, rec_d, c, box, slope_i,
                                              cap)

                    def fv(c):
                        return efn.eval_energy(lig_i, rec_d, c, box, slope_i,
                                               cap)

                    res = bfgs(f, conf_i, minpar, f_val=fv)
                else:
                    center = cnn_obj["center_of"](lig_i, conf_i)
                    rec_g = cnn_obj["prep"](center)

                    def f(c):
                        return cnn_obj["deriv_p"](rec_g, lig_i, c, center,
                                                  slope_i)

                    def fv(c, rows=None):
                        return cnn_obj["value_p"](rec_g, lig_i, c, center,
                                                  slope_i, rows)

                    res = bfgs(f, conf_i, minpar, f_val=fv, lazy_trials=True)
                coords = fk.fk_coords(lig_i, res.x, max_layers)
                conf = Conf(*[x.index_copy(0, live, y)
                              for x, y in zip(conf, res.x)])
                done = done.index_copy(0, live, _inside(lig_i, coords,
                                                        box.lo, box.hi))
        return conf

    def _assemble(self, rec, ligs, conf_all: Conf, inter, intra, menergy,
                  n, m, p, max_layers, num_out):
        """Conf-independent terms on the exact rescore (inter, intra: one
        row per (ligand, saved pose)), one batched CNN rescore of every
        valid pose of every ligand (when the engine holds a scorer), then
        per-ligand sort and dedup."""
        s = self.settings
        dev = self.device
        menergy = menergy.cpu().numpy()
        per_lig = []
        for li, lig in enumerate(ligs):
            sl = slice(li * num_out, (li + 1) * num_out)
            conf = Conf(*[x[sl] for x in conf_all])
            lig_d = pad_ligand(lig, n, m, p, device=dev)
            coords = fk.fk_coords(lig_d, conf, max_layers).cpu().numpy()
            valid_ids = [i for i in range(num_out) if menergy[li, i] < MAX_FL]
            per_lig.append((sl, conf, coords[:, :lig.num_atoms], valid_ids))

        # ONE ensemble pass covers every valid pose of every ligand
        multi_scores = None
        if self._has_cnn:
            items = [(lig, coords[valid_ids])
                     for lig, (_, _, coords, valid_ids) in zip(ligs, per_lig)
                     if valid_ids]
            if items:
                multi_scores = iter(self.cnn.score_poses_multi(rec, items))

        all_results: List[List[PoseResult]] = []
        for lig, (sl, conf, coords, valid_ids) in zip(ligs, per_lig):
            pos = conf.position.cpu().numpy()
            quat = conf.orientation.cpu().numpy()
            trs = conf.torsions.cpu().numpy()
            energies = self._conf_independent(lig, inter[sl])
            cnn_scores = {}
            if valid_ids and multi_scores is not None:
                sc, aff, _loss, var = next(multi_scores)
                cnn_scores = {i: (float(sc[j]), float(aff[j]), float(var[j]))
                              for j, i in enumerate(valid_ids)}
            t = lig.num_torsions
            results = []
            for i in valid_ids:
                cnnscore, cnnaff, cnnvar = cnn_scores.get(i, (0.0, 0.0, 0.0))
                results.append(PoseResult(
                    energy=float(energies[i]), intramol=float(intra[sl][i]),
                    cnnscore=cnnscore, cnnaffinity=cnnaff,
                    cnnvariance=cnnvar, coords=coords[i],
                    conf_position=pos[i], conf_orientation=quat[i],
                    conf_torsions=trs[i][:t]))
            results = self._sort(results)
            results = self._remove_redundant(results, lig)
            all_results.append(results[: s.num_modes])
        return all_results

    def _sort(self, results: List[PoseResult]) -> List[PoseResult]:
        """auto -> CNNscore when a scorer rescored, else Energy.  Sorts are
        stable: on equal keys (the 0.0 scores of a run without a scorer)
        the order of the container stays."""
        order = self.settings.sort_order
        if order == "auto":
            order = "CNNscore" if self._has_cnn else "Energy"
        if order == "CNNscore":
            return sorted(results, key=lambda r: -r.cnnscore)
        if order == "CNNaffinity":
            return sorted(results, key=lambda r: -r.cnnaffinity)
        return sorted(results, key=lambda r: r.energy)

    def _remove_redundant(self, results: List[PoseResult],
                          lig: LigandStruct) -> List[PoseResult]:
        """remove_redundant (main.cpp:185-195)."""
        heavy = ~IS_HYDROGEN[lig.types]
        kept: List[PoseResult] = []
        for r in results:
            ok = True
            for k in kept:
                d2 = ((r.coords[heavy] - k.coords[heavy]) ** 2).sum(axis=1).mean()
                if np.sqrt(d2) <= self.settings.out_min_rmsd:
                    ok = False
                    break
            if ok:
                kept.append(r)
        return kept
