"""Fused docking kernels: value+gradient, truncated BFGS and in-kernel MC.

Counterpart of the JAX package's single Pallas kernel
(gnina_tpu/ops/pallas_dock.py, make_bfgs_kernel) in every mode of the
fused docking route, plus its fused evaluation core:

  K1 `eval_fg`          fused value + DOF gradient of a batch of poses
                        (pallas_dock.py eval_fg :677 = fk :362 + energy :474
                        + fk_backward :613); its gradient output is what the
                        debug_grad mode (K7, :960) dumps
  K2 `bfgs_minimize`    one truncated BFGS per pose (bfgs_run_lockstep :722)
  K4   ... async_ls     the same search, one value+gradient per Armijo
                        trial (bfgs_run_async :860)
  K3 `async_mc_window`  a window of per-pose Monte Carlo steps (async_mc
                        amc_body :1124, mutate :1038, rand_sphere :1009)
  K6   ... warm_ls      the same window, Armijo exponents warm-started
                        (:1150-1152)
  K5 `lockstep_mc_window`  a step-indexed window: every step runs one whole
                        BFGS, no tick budget (mc_body :1290)
  K8   ... done_frac<1  the group stop of both BFGS loops (:715-720, :733,
                        :869), a mode of K2/K4 and of K5: 128 consecutive
                        lanes form a group whose loops all end once
                        done_frac of its lanes read done

Each is a hand-written CUDA kernel in csrc/fused_dock.cu with one thread
block per pose, and a plain PyTorch version here that computes the same
function step for step, batched over poses.  The wrapper takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.  Every kernel launch adds one to its wrapper's `launches`.

Layout is pose-major: rigid (L, 8) = [pos(3), quat(4), 0], tors (L, M) with
column 0 the root's unused slot, stats (L, 8), heavy-atom coords (L, N, 3).
The pack holds each ligand's topology once plus a lane -> ligand index
(the `exhaustiveness` chains of one ligand share it).

scal (12,) float32: [v_intra, v_inter, slope, v_metro, lo x3, hi x3,
mutation amplitude, temperature].
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gnina_tpu_torch.constants import EPSILON_FL, IS_HYDROGEN
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.ops import quat as Q
from gnina_tpu_torch.scoring import terms as T
from gnina_tpu_torch.scoring.weighted import ScoringFunction
from gnina_tpu_torch.types import Conf

NUM_TRIALS = 10   # Armijo halvings (bfgs.h:73-91)
C0 = 1e-4
N_DRAWS = 13      # uniforms per MC tick: 12 for mutate, 1 for Metropolis
BLOCK_THREADS = 512   # threads per pose block in csrc/fused_dock.cu (NT)
GROUP = 128           # lanes per done_frac group (the JAX kernel's block, LB)
_COUNT_LOCK = threading.Lock()

# Shared memory of a pose block (csrc/fused_dock.cu smem_bytes): two
# mbarriers, the receptor, the pose state and one pair queue per warp.  The
# receptor (REC_ROW_BYTES an atom) stays resident for the whole launch up to
# REC_RESIDENT_BYTES; above, it streams through two tiles of REC_TILE_ATOMS
# per evaluation.
SMEM_LIMIT = 232448 - 1024   # the card's per-block maximum, less the
                             # kernels' static shared memory (terms, scal)
REC_ROW_BYTES = 32
REC_RESIDENT_BYTES = 192 * 1024
REC_TILE_ATOMS = 2048
QUEUE_CAP = 64               # pair-queue entries per warp (QCAP)
REC_OFFSET = 128             # bytes before the receptor: the mbarriers


# --------------------------------------------------------------------------
# scoring-function compatibility: extract static term parameters
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VinaTerms:
    """Static parameters of the fused term family (all python floats)."""

    gauss: Tuple[Tuple[float, float, float], ...]        # (offset, width, w)
    repulsion: Tuple[Tuple[float, float], ...]           # (offset, w)
    hydrophobic: Tuple[Tuple[float, float, float], ...]  # (good, bad, w)
    hbond: Tuple[Tuple[float, float, float], ...]        # (good, bad, w)
    cutoff_sqr: float


def extract_vina_terms(sf: ScoringFunction) -> Optional[VinaTerms]:
    """The kernel's term parameters, or None if sf is outside the fused
    family."""
    gauss, rep, hyd, hb = [], [], [], []
    for t, w in zip(sf.pair_terms, sf.pair_weights):
        if isinstance(t, T.Gauss):
            gauss.append((t.offset, t.width, w))
        elif isinstance(t, T.Repulsion):
            rep.append((t.offset, w))
        elif isinstance(t, T.Hydrophobic):
            hyd.append((t.good, t.bad, w))
        elif isinstance(t, T.NonDirHBond):
            hb.append((t.good, t.bad, w))
        else:
            return None
    if len(gauss) > 4 or len(rep) > 2 or len(hyd) > 2 or len(hb) > 2:
        return None  # more terms than the kernel's fixed slots
    return VinaTerms(gauss=tuple(gauss), repulsion=tuple(rep),
                     hydrophobic=tuple(hyd), hbond=tuple(hb),
                     cutoff_sqr=float(sf.cutoff) ** 2)


# --------------------------------------------------------------------------
# pack
# --------------------------------------------------------------------------

class DockPack(NamedTuple):
    """Per-ligand packed arrays (G ligands) + lane index + receptor."""

    lc: torch.Tensor        # (G, N, 3) local coords, heavy atoms only
    ap: torch.Tensor        # (G, N, 6) radius, phi, don, acc, heavy, 0
    node: torch.Tensor      # (G, N) int32 tree node of each heavy atom
    parent: torch.Tensor    # (G, M) int32 parent node (0 for root / pad)
    layer: torch.Tensor     # (G, M) int32 BFS depth; 0 = root or inert pad
    relax: torch.Tensor     # (G, M, 3)
    relo: torch.Tensor      # (G, M, 3)
    imask: torch.Tensor     # (G, N, N) symmetric intra-pair mask
    dofmask: torch.Tensor   # (G, D)
    nheavy: torch.Tensor    # (G,) int32 real heavy atoms
    rec: torch.Tensor       # (K, 8) x y z radius phi don acc mask
    lane_lig: torch.Tensor  # (L,) int32 lane -> ligand
    heavy_idx: np.ndarray   # (G, N) int64 heavy-subset -> full index, -1 pad
    num_layers: int         # LY: deepest tree layer over the pack
    max_heavy: int          # largest heavy-atom count over the ligands
    pad_lig: int = -1       # the inert ligand row of pad lanes; -1: none

    @property
    def lanes(self) -> int:
        return int(self.lane_lig.shape[0])

    @property
    def dims(self):
        """(N, M, LY, K, L)."""
        return (int(self.lc.shape[1]), int(self.parent.shape[1]),
                self.num_layers, int(self.rec.shape[0]), self.lanes)

    def with_lanes(self, lane_lig: torch.Tensor) -> "DockPack":
        """The same ligands and receptor under another lane layout."""
        return self._replace(lane_lig=lane_lig.to(torch.int32).contiguous())

    def to(self, device) -> "DockPack":
        """Every tensor on `device`."""
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})

    def real_lanes(self) -> "DockPack":
        """The pack without its pad lanes (build_pack(shards > 1)): the
        lanes of the unsharded layout, ligand-major."""
        if self.pad_lig < 0:
            return self
        return self.with_lanes(self.lane_lig[self.lane_lig != self.pad_lig])

    def shard(self, i: int, shards: int) -> "DockPack":
        """Shard i of a pack laid out by build_pack(shards=shards): its
        real lanes, over the rows of the ligands they dock (renumbered from
        0), without the inert row.  Equal to build_pack of those ligands
        alone, except that the dimensions (N, M, LY) stay the whole pack's,
        so every shard runs what the unsharded pack runs for its lanes."""
        block = self.lanes // shards
        if block * shards != self.lanes:
            raise ValueError(f"{self.lanes} lanes do not split into "
                             f"{shards} shards")
        ll = self.lane_lig[i * block:(i + 1) * block]
        if self.pad_lig >= 0:
            ll = ll[ll != self.pad_lig]
        lo, hi = int(ll.min()), int(ll.max()) + 1
        per_lig = ("lc", "ap", "node", "parent", "layer", "relax", "relo",
                   "imask", "dofmask", "nheavy")
        return self._replace(
            lane_lig=(ll - lo).to(torch.int32).contiguous(),
            heavy_idx=self.heavy_idx[lo:hi], pad_lig=-1,
            **{k: getattr(self, k)[lo:hi].contiguous() for k in per_lig})


def build_pack(ligs, rec_coords, rec_types, rec_mask, exhaustiveness: int,
               table, m_pad: int = 0, device=None,
               shards: int = 1) -> DockPack:
    """Build kernel arrays from host LigandStructs + receptor atoms.

    Lane layout: lane = ligand_index * exhaustiveness + chain.  m_pad:
    force at least this many tree nodes (so the packed torsion layout lines
    up with an externally chosen Conf slot count).

    shards > 1 lays the lanes out for an even split over a device mesh's
    "dp" axis, as the JAX package's build_pack does
    (gnina_tpu/ops/pallas_dock.py:127-204): the real lanes fall into
    `shards` contiguous groups and each group carries its own trailing
    pad up to a multiple of GROUP lanes (the JAX kernel's block), so the
    lane axis splits into `shards` equal [real | pad] blocks.  Pad lanes
    point at one inert ligand row (no atom, no degree of freedom) after the
    real ones, `pad_lig`.  The kernels take partial groups of GROUP lanes,
    so a shard runs its real lanes (DockPack.shard); the pad keeps the
    layout JAX's, lane for lane.  Requires lanes % shards == 0 (the
    engine pads the ligand list).  shards=1 is the layout above, no pad."""
    device = resolve_device(device)
    g = len(ligs)
    lanes = g * exhaustiveness
    if shards < 1 or lanes % shards:
        raise ValueError(f"{lanes} lanes do not split into {shards} shards")
    lps = lanes // shards
    lps_pad = ((lps + GROUP - 1) // GROUP) * GROUP if shards > 1 else lps
    gp = g + int(lps_pad > lps)     # an inert row after the real ligands
    heavy_lists = [np.where(~IS_HYDROGEN[l.types])[0] for l in ligs]
    n = max(1, max(len(h) for h in heavy_lists))
    n = ((n + 7) // 8) * 8
    m = max(max(l.num_nodes for l in ligs), m_pad)
    ly = max(int(l.layer.max()) if l.num_nodes > 1 else 1 for l in ligs)
    d = 6 + (m - 1)

    lc = np.zeros((gp, n, 3), np.float32)
    ap = np.zeros((gp, n, 6), np.float32)
    node = np.zeros((gp, n), np.int32)
    parent = np.zeros((gp, m), np.int32)
    layer = np.zeros((gp, m), np.int32)
    relax = np.zeros((gp, m, 3), np.float32)
    relo = np.zeros((gp, m, 3), np.float32)
    imask = np.zeros((gp, n, n), np.float32)
    dofmask = np.zeros((gp, d), np.float32)
    nheavy = np.zeros((gp,), np.int32)
    heavy_idx = np.full((gp, n), -1, np.int64)

    for gi, (lig, hidx) in enumerate(zip(ligs, heavy_lists)):
        nh = len(hidx)
        nheavy[gi] = nh
        heavy_idx[gi, :nh] = hidx
        remap = -np.ones(lig.num_atoms, np.int64)
        remap[hidx] = np.arange(nh)
        tt = lig.types[hidx]
        lc[gi, :nh] = lig.local_coords[hidx]
        ap[gi, :nh, 0] = table.xs_radius[tt]
        ap[gi, :nh, 1] = table.xs_hydrophobe[tt]
        ap[gi, :nh, 2] = table.xs_donor[tt]
        ap[gi, :nh, 3] = table.xs_acceptor[tt]
        ap[gi, :nh, 4] = 1.0
        node[gi, :nh] = lig.node_id[hidx]
        mr = lig.num_nodes
        for mi in range(1, mr):
            parent[gi, mi] = lig.parent[mi]
            layer[gi, mi] = lig.layer[mi]
        relax[gi, :mr] = lig.rel_axis
        relo[gi, :mr] = lig.rel_origin
        for (a, b) in lig.pairs:
            ra, rb = remap[a], remap[b]
            if ra >= 0 and rb >= 0:
                imask[gi, ra, rb] = 1.0
                imask[gi, rb, ra] = 1.0
        dofmask[gi, :6 + lig.num_torsions] = 1.0
        if not lig.has_rigid_dof:
            dofmask[gi, :6] = 0.0

    rt = np.asarray(rec_types, np.int64)
    rec = np.zeros((len(rt), 8), np.float32)
    rec[:, 0:3] = np.asarray(rec_coords, np.float32)
    rec[:, 3] = table.xs_radius[rt]
    rec[:, 4] = table.xs_hydrophobe[rt]
    rec[:, 5] = table.xs_donor[rt]
    rec[:, 6] = table.xs_acceptor[rt]
    rec[:, 7] = np.asarray(rec_mask, np.float32)
    lane_lig = np.repeat(np.arange(g, dtype=np.int32), exhaustiveness)
    if lps_pad > lps:
        # per-shard trailing pad: (shards, lps) -> (shards, lps_pad) -> flat
        lane_lig = np.pad(lane_lig.reshape(shards, lps),
                          [(0, 0), (0, lps_pad - lps)],
                          constant_values=g).reshape(-1)

    def t(a):
        return torch.as_tensor(a, device=device).contiguous()

    return DockPack(lc=t(lc), ap=t(ap), node=t(node), parent=t(parent),
                    layer=t(layer), relax=t(relax), relo=t(relo),
                    imask=t(imask), dofmask=t(dofmask), nheavy=t(nheavy),
                    rec=t(rec), lane_lig=t(lane_lig), heavy_idx=heavy_idx,
                    num_layers=ly, max_heavy=int(nheavy.max()),
                    pad_lig=g if gp > g else -1)


class SmemPlan(NamedTuple):
    """How a pose block of the fused kernels holds the receptor."""

    rec_tile: int     # receptor atoms a tile (K when resident)
    resident: bool    # the whole receptor stays in shared memory
    n_tiles: int      # tiles an evaluation walks (1 when resident)
    nbytes: int       # dynamic shared memory of the block


def state_floats(n: int, m: int, d: int) -> int:
    """Floats of a pose block's state in shared memory (csrc/fused_dock.cu
    smem_floats): clamped atoms, per-atom sums, pack, frames, atoms,
    per-warp pair sums, node forces, BFGS, pose states, scalars."""
    nwarps = BLOCK_THREADS // 32
    return (n * 4
            + n * 8
            + n * 3 + n * 6 + m * 3 + m * 3 + n * n + d
            + n + m + m
            + m + m + m * 4 + m * 3 + m * 3
            + n * 3 + n * 3
            + 2 * nwarps * n * 4
            + m * 3 + m * 3
            + d * d + 5 * d
            + 4 * (8 + m)
            + 32)


def smem_plan(n: int, m: int, d: int, k: int) -> SmemPlan:
    """The shared-memory plan of a pose block for N atom rows, M tree
    nodes, D DOFs and K receptor atoms: the receptor resident when it takes
    at most REC_RESIDENT_BYTES and fits beside the state, else two tiles of
    REC_TILE_ATOMS (halved until they fit).  Raises when not even the
    smallest tiles fit."""
    fixed = (REC_OFFSET + 4 * state_floats(n, m, d)
             + 4 * (BLOCK_THREADS // 32) * QUEUE_CAP)
    rec = k * REC_ROW_BYTES
    if rec <= REC_RESIDENT_BYTES and fixed + rec <= SMEM_LIMIT:
        return SmemPlan(k, True, 1 if k else 0, fixed + rec)
    tile = REC_TILE_ATOMS
    while fixed + 2 * tile * REC_ROW_BYTES > SMEM_LIMIT and tile > 256:
        tile //= 2
    nbytes = fixed + 2 * tile * REC_ROW_BYTES
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"a pose block needs {nbytes} bytes of shared "
                         f"memory (N={n}, M={m}); the card has {SMEM_LIMIT}")
    return SmemPlan(tile, False, -(-k // tile), nbytes)


def conf_to_packed(conf: Conf, m: int):
    """Conf with a leading lane axis (L, ...) -> rigid (L, 8), tors (L, M)."""
    pos, quat, tt = conf.position, conf.orientation, conf.torsions
    lanes = pos.shape[0]
    z = torch.zeros((lanes, 1), dtype=torch.float32, device=pos.device)
    rigid = torch.cat([pos, quat, z], dim=1)
    tt = tt[:, :m - 1]              # extra slots are padding: truncate
    parts = [z, tt]
    if tt.shape[1] < m - 1:
        parts.append(torch.zeros((lanes, m - 1 - tt.shape[1]),
                                 dtype=torch.float32, device=pos.device))
    return rigid.contiguous(), torch.cat(parts, dim=1).contiguous()


def packed_to_conf(rigid, tors, t: int) -> Conf:
    return Conf(position=rigid[..., 0:3], orientation=rigid[..., 3:7],
                torsions=tors[..., 1:1 + t])


def scal_vector(v_intra, v_inter, slope, v_metro, lo, hi, amplitude=2.0,
                temperature=1.2, device=None) -> torch.Tensor:
    device = resolve_device(device)
    lo = torch.as_tensor(lo, dtype=torch.float32).reshape(3).tolist()
    hi = torch.as_tensor(hi, dtype=torch.float32).reshape(3).tolist()
    return torch.tensor([float(v_intra), float(v_inter), float(slope),
                         float(v_metro)] + lo + hi
                        + [float(amplitude), float(temperature)],
                        dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# plain PyTorch versions (batched over poses)
# --------------------------------------------------------------------------

def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _qrotate(q, v):
    """v' = v + 2 q_v x (q_v x v + q_w v): the kernel's rotation form (the
    exact energy's FK, ops/quat.qrotate, goes through the matrix)."""
    qv = q[..., 1:4]
    t = _cross(qv, v) + q[..., 0:1] * v
    return v + 2.0 * _cross(qv, t)


def _gather(x, idx):
    """x (L, M, C), idx (L, J) -> (L, J, C)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        idx.shape + (x.shape[-1],)))


def _fk(rigid, tors, pack: DockPack, lane_lig=None):
    """Layered FK: returns heavy coords (P, N, 3), node origins (P, M, 3),
    node lab axes (P, M, 3)."""
    lig = (pack.lane_lig if lane_lig is None else lane_lig).long()
    parent = pack.parent[lig]
    layer = pack.layer[lig]
    relo = pack.relo[lig]
    relax = pack.relax[lig]
    p, m = tors.shape
    dev = rigid.device
    row0 = (torch.arange(m, device=dev) == 0)[None, :, None]
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    fq = torch.where(row0, rigid[:, None, 3:7], ident)
    fo = torch.where(row0, rigid[:, None, 0:3], 0.0)
    axl = torch.zeros((p, m, 3), dtype=torch.float32, device=dev)
    half = 0.5 * Q.normalize_angle(tors)
    ch = torch.cos(half)[..., None]
    sh = torch.sin(half)[..., None]
    for lyr in range(1, pack.num_layers + 1):
        sel = (layer == lyr)[..., None]
        pq = _gather(fq, parent)
        po = _gather(fo, parent)
        no = po + _qrotate(pq, relo)
        ax = _qrotate(pq, relax)
        nq = Q.qnormalize_approx(Q.qmul(torch.cat([ch, sh * ax], dim=-1), pq))
        fq = torch.where(sel, nq, fq)
        fo = torch.where(sel, no, fo)
        axl = torch.where(sel, ax, axl)
    node = pack.node[lig]
    coords = _gather(fo, node) + _qrotate(_gather(fq, node), pack.lc[lig])
    return coords, fo, axl


def fk_packed(rigid, tors, pack: DockPack, lane_lig=None):
    """Kernel-equivalent FK in plain torch: (P, 8), (P, M) -> coords
    (P, N, 3).  lane_lig overrides the pack's lane -> ligand index (e.g.
    for a stream of S candidates per lane)."""
    return _fk(rigid, tors, pack, lane_lig)[0]


def _pair_terms(terms: VinaTerms, d, fac_hyd, fac_hb, want_deriv):
    """Vina-family energy (and d/dd) at surface distance d."""
    e = torch.zeros_like(d)
    de = torch.zeros_like(d) if want_deriv else None
    for (off, width, w) in terms.gauss:
        inv_w = 1.0 / width
        dd = (d - off) * inv_w
        gv = torch.exp(-dd * dd)
        e = e + w * gv
        if want_deriv:
            de = de + (w * -2.0 * inv_w) * gv * dd
    for (off, w) in terms.repulsion:
        dd = d - off
        neg = dd < 0.0
        e = e + w * torch.where(neg, dd * dd, 0.0)
        if want_deriv:
            de = de + w * torch.where(neg, 2.0 * dd, 0.0)
    for (good, bad, w), fac in ([(t, fac_hyd) for t in terms.hydrophobic]
                                + [(t, fac_hb) for t in terms.hbond]):
        inv = 1.0 / (good - bad)
        frac = (d - bad) * inv
        wf = w * fac
        e = e + wf * torch.clamp(frac, 0.0, 1.0)
        if want_deriv:
            inside = (frac > 0.0) & (frac < 1.0)
            de = de + torch.where(inside, wf * inv, 0.0)
    return e, de


def _curl_factor(e, v):
    """curl.h:37-42: (capped energy, gradient scale)."""
    tmp = v / torch.clamp(v + torch.clamp(e, min=0.0), min=EPSILON_FL)
    cap = e > 0.0
    return torch.where(cap, e * tmp, e), torch.where(cap, tmp * tmp, 1.0)


def _energy(terms: VinaTerms, coords, ap, rec, scal, want_deriv):
    """Receptor part of the exact Vina energy of heavy coords (P, N, 3).
    Returns (per-atom e (P, N), e_metro (P,), gatom (P, N, 3) or None).

    Receptor part mirrors non_cache.cpp:127-180 (clamp, slope penalty,
    per-atom curl at v_inter, and the same raw sums capped at v_metro for
    the Metropolis energy); intra mirrors model.cu:22-36 (per-pair curl at
    v_intra) on unclamped coords, in _intra."""
    v_intra, v_inter, slope, v_metro = scal[0], scal[1], scal[2], scal[3]
    lo, hi = scal[4:7], scal[7:10]
    heavy = ap[..., 4]
    adj = torch.maximum(torch.minimum(coords, hi), lo)
    oob = torch.sum(torch.abs(coords - adj), dim=-1)
    # per-component (P, N, K) differences: reductions run over K only
    dx, dy, dz = (adj[..., c, None] - rec[:, c] for c in range(3))
    r2 = dx * dx + dy * dy + dz * dz
    valid = ((r2 < terms.cutoff_sqr) & (rec[:, 7] > 0.0)
             & (heavy[..., None] > 0.0))
    r2c = torch.clamp(r2, min=1e-12)
    rinv = torch.rsqrt(r2c)
    d = r2c * rinv - (ap[..., 0, None] + rec[:, 3])
    fac_hyd = ap[..., 1, None] * rec[:, 4]
    # h_bond_possible is a boolean OR (everything.h:479): clamp so donor+
    # acceptor vs donor+acceptor pairs do not double-count
    fac_hb = torch.clamp(ap[..., 2, None] * rec[:, 6]
                         + ap[..., 3, None] * rec[:, 5], max=1.0)
    e, de = _pair_terms(terms, d, fac_hyd, fac_hb, want_deriv)
    e_a = torch.sum(torch.where(valid, e, 0.0), dim=-1)         # (P, N)
    e_curl, gsc = _curl_factor(e_a, v_inter)
    e_curl_m, _ = _curl_factor(e_a, v_metro)
    e_inter = heavy * (e_curl + slope * oob)
    e_met = torch.sum(heavy * (e_curl_m + slope * oob), dim=-1)
    gatom = None
    if want_deriv:
        gr = torch.where(valid, de * rinv, 0.0)
        gxyz = torch.stack([torch.sum(gr * dx, dim=-1),
                            torch.sum(gr * dy, dim=-1),
                            torch.sum(gr * dz, dim=-1)], dim=-1)    # (P, N, 3)
        inbox = (coords == adj).to(torch.float32)
        gatom = heavy[..., None] * (gxyz * gsc[..., None] * inbox
                                    + slope * torch.sign(coords - adj))
    return e_inter, e_met, gatom


def _intra(terms: VinaTerms, coords, ap, imask, v_intra, want_deriv):
    """Intra-ligand pairs as a dense masked N x N block with per-pair curl
    at v_intra; returns per-row energy halves and row gradients."""
    dx, dy, dz = (coords[:, :, None, c] - coords[:, None, :, c]
                  for c in range(3))                              # (P, N, N)
    r2 = dx * dx + dy * dy + dz * dz
    r2c = torch.clamp(r2, min=1e-12)
    rinv = torch.rsqrt(r2c)
    r = r2c * rinv
    rad, phi, don, acc = (ap[..., c] for c in range(4))
    d = r - (rad[:, :, None] + rad[:, None, :])
    fac_hyd = phi[:, :, None] * phi[:, None, :]
    fac_hb = torch.clamp(don[:, :, None] * acc[:, None, :]
                         + acc[:, :, None] * don[:, None, :], max=1.0)
    e, de = _pair_terms(terms, d, fac_hyd, fac_hb, want_deriv)
    tmp = v_intra / torch.clamp(v_intra + torch.clamp(e, min=0.0),
                                min=EPSILON_FL)
    cap = e > 0.0
    e = torch.where(cap, e * tmp, e)
    valid = (r2 < terms.cutoff_sqr) & (imask > 0.0)
    e_row = 0.5 * torch.sum(torch.where(valid, e, 0.0), dim=-1)  # (P, N)
    g = None
    if want_deriv:
        de = torch.where(cap, de * tmp * tmp, de)
        gr = torch.where(valid, de * rinv, 0.0)
        g = torch.stack([torch.sum(gr * dx, dim=-1),
                         torch.sum(gr * dy, dim=-1),
                         torch.sum(gr * dz, dim=-1)], dim=-1)
    return e_row, g


def _node_add(dst, idx, src):
    """dst (P, M, 3) plus the rows of src (P, N, 3) added into rows idx (P,
    N) of dim 1, as scatter_add but by a masked sum over N: its sums come
    out the same in every run on either device, where scatter_add's atomics
    on the card add in another order each time and so move an Armijo test
    now and then.  A row is selected, not multiplied by 0, so an inf stays
    in its own node."""
    mine = idx[..., None] == torch.arange(dst.shape[1], device=src.device)
    return dst + torch.where(mine[..., None], src[:, :, None], 0.0).sum(1)


def _fk_backward(coords, gatom, fo, axl, pack: DockPack, lane_lig):
    """tree.h:374-393: atom gradients -> per-node force and torque (about
    the node's own origin), passed up the tree deepest layer first, then
    the DOF gradient [force(3), torque(3), axis . torque per torsion]."""
    lig = lane_lig.long()
    node = pack.node[lig].long()                               # (P, N)
    parent = pack.parent[lig].long()
    layer = pack.layer[lig]
    p, m = parent.shape
    rel = coords - _gather(fo, node)
    F = torch.zeros((p, m, 3), dtype=torch.float32, device=coords.device)
    Tq = _node_add(F, node, _cross(rel, gatom))
    F = _node_add(F, node, gatom)
    for lyr in range(pack.num_layers, 0, -1):
        sel = (layer == lyr)[..., None]
        po = _gather(fo, parent)
        fc = torch.where(sel, F, 0.0)
        tc = torch.where(sel, Tq + _cross(fo - po, F), 0.0)
        F = _node_add(F, parent, fc)
        Tq = _node_add(Tq, parent, tc)
    gt = torch.sum(axl * Tq, dim=-1)                            # (P, M)
    g = torch.cat([F[:, 0], Tq[:, 0], gt[:, 1:]], dim=1)
    return g * pack.dofmask[lig]


def _eval(terms, rigid, tors, scal, pack: DockPack, want_deriv):
    """Fused value (+ DOF gradient) of poses: (e, e_metro, g, coords)."""
    lig = pack.lane_lig
    coords, fo, axl = _fk(rigid, tors, pack, lig)
    # atom rows past the pack's largest heavy count are padding: no energy,
    # no gradient (the kernel's atom loops stop at each pose's own count)
    ne = pack.max_heavy
    crd = coords[:, :ne]
    ap = pack.ap[lig.long(), :ne]
    e_inter, e_met, gatom = _energy(terms, crd, ap, pack.rec, scal,
                                    want_deriv)
    e_row, g_intra = _intra(terms, crd, ap, pack.imask[lig.long(), :ne, :ne],
                            scal[0], want_deriv)
    e = torch.sum(e_inter + e_row, dim=-1)
    g = None
    if want_deriv:
        gatom = torch.nn.functional.pad(gatom + g_intra,
                                        (0, 0, 0, coords.shape[1] - ne))
        g = _fk_backward(coords, gatom, fo, axl, pack, lig)
    return e, e_met, g, coords


def eval_fg_plain(terms: VinaTerms, rigid, tors, scal, pack: DockPack):
    """K1, plain: fused value + DOF gradient of every lane's pose.
    Returns e (L,), e_metro (L,), g (L, D), coords (L, N, 3)."""
    return _eval(terms, rigid, tors, scal, pack, True)


def debug_grad(terms: VinaTerms, rigid, tors, scal, pack: DockPack):
    """K7, the debug_grad mode of the JAX kernel (pallas_dock.py:960-974),
    as a view of K1's outputs: (rigid, tors, stats, coords) with the energy
    in stats[:, 0] and the initial DOF gradient laid into the coordinate
    output, DOF row r of a lane at coords[l, r % N, r // N] (the rows
    past D are zero)."""
    e, _, g, _ = eval_fg(terms, rigid, tors, scal, pack)
    lanes, d = g.shape
    n = pack.dims[0]
    if 3 * n < d:
        raise ValueError(f"{d} DOFs do not fit the (N={n}, 3) coordinates")
    gd = torch.nn.functional.pad(g, (0, 3 * n - d))
    stats = torch.nn.functional.pad(e[:, None], (0, 7))
    return rigid, tors, stats, gd.reshape(lanes, 3, n).permute(0, 2, 1)


def _increment(rigid, tors, p, alpha):
    """conf.h:113-118: pos += a p[:3]; quat = rotvec(a p[3:6]) * quat;
    tors = normalize(tors + normalize(a p[6:]))."""
    a = alpha[:, None]
    pos = rigid[:, 0:3] + a * p[:, 0:3]
    q = Q.quaternion_increment(rigid[:, 3:7], a * p[:, 3:6])
    dt = torch.cat([torch.zeros_like(p[:, :1]), a * p[:, 6:]], dim=1)
    tors_new = Q.normalize_angle(tors + Q.normalize_angle(dt))
    rigid_new = torch.cat([pos, q, torch.zeros_like(pos[:, :1])], dim=1)
    return rigid_new, tors_new


def _bfgs_update(h, p, y, alpha):
    """bfgs_update (bfgs.h:52-66): returns (h + outer, ok_h)."""
    yp = torch.sum(y * p, dim=1)
    ok_h = (alpha * yp) >= EPSILON_FL
    mhy = -torch.einsum("lij,lj->li", h, y)
    yhy = -torch.sum(y * mhy, dim=1)
    r_ = 1.0 / torch.clamp(alpha * yp, min=EPSILON_FL)
    coef1 = (alpha * r_)[:, None, None]
    coef2 = (alpha * alpha * (r_ * r_ * yhy + r_))[:, None, None]
    outer = coef1 * (mhy[:, :, None] * p[:, None, :]
                     + p[:, :, None] * mhy[:, None, :])
    outer = outer + coef2 * (p[:, :, None] * p[:, None, :])
    return h + outer, ok_h


def _first_scale(h, y, p, alpha, eye):
    """First-step Hessian scaling (bfgs.h:481-486), NaN-proofed."""
    yy = torch.sum(y * y, dim=1)
    yp = torch.sum(y * p, dim=1)
    scale = torch.where(torch.abs(yy) > EPSILON_FL,
                        alpha * yp / torch.clamp(yy, min=EPSILON_FL), 1.0)
    scale = torch.where(scale == scale, scale, 1.0)
    return eye * scale[:, None, None]


class _GroupStop:
    """K8, plain: the group stop of the JAX kernel's BFGS loops
    (pallas_dock.py:715-720).  Lanes form groups of GROUP consecutive
    lanes; after every iteration (tick) each group sums its lanes' done
    flags, and once the sum reaches int(done_frac * GROUP) the loop ends for
    every lane of the group.  The JAX block is padded to GROUP lanes with
    inert lanes (zero masks, zero gradient), which read done from the first
    iteration on and count toward the target; the port has no such lanes and
    adds their number to the last group's sum.  `votes` (groups, slots)
    keeps the real lanes' count at every iteration a group met, -1 where it
    did not."""

    def __init__(self, lanes: int, done_frac: float, device, slots: int):
        self.target = float(int(done_frac * GROUP))
        groups = max((lanes + GROUP - 1) // GROUP, 1)
        self.grp = torch.arange(lanes, device=device) // GROUP
        self.pad = torch.zeros(groups, dtype=torch.float32, device=device)
        self.pad[-1] = float(groups * GROUP - lanes)
        self.halted = torch.zeros(lanes, dtype=torch.bool, device=device)
        self.iters = torch.zeros(lanes, dtype=torch.float32, device=device)
        self.first = torch.arange(groups, device=device) * GROUP
        self.votes = torch.full((groups, max(slots, 1)), -1,
                                dtype=torch.int32, device=device)

    def vote(self, donef, it: int):
        """Count the flags after iteration `it`; returns the lanes whose
        group stops here (they have run it + 1 iterations)."""
        live = ~self.halted
        cnt = self.pad.clone().index_add_(0, self.grp,
                                          (donef & live).float())
        met = live[self.first]      # a group halts as a whole
        self.votes[:, it] = torch.where(met, (cnt - self.pad).int(), -1)
        newly = (cnt >= self.target)[self.grp] & live
        self.iters = torch.where(newly, float(it + 1), self.iters)
        self.halted = self.halted | newly
        return newly

    def finish(self, ran: int):
        """Iterations each lane's group ran; `ran` for one never stopped."""
        return torch.where(self.halted, self.iters, float(ran))


def _bfgs_run_plain(terms: VinaTerms, rigid0, tors0, scal, pack: DockPack,
                    maxiters: int, num_trials: int, ls_factor: float,
                    async_ls: bool, done_frac: float = 1.0, votes=None):
    """One truncated BFGS per lane (bfgs.h:357-502) in either line-search
    mode.  Returns (rigid, tors, f, metro, trial evals, iterations, accepted
    iterations, last_rigid, last_tors, group iterations); last_rigid and
    last_tors are the pose of the
    JAX loop's last evaluation, whose coordinates its in-kernel MC returns:
    in lockstep mode the final iterate before the restore-if-not-improved,
    under async_ls the trial point of the lane's last tick, accepted or not
    (a tick that finds no descent direction still evaluates its trial).  In
    the JAX kernel a finished lane goes on evaluating trial points while
    other lanes of its block run; this is what a lane alone in its block
    returns.

    Lockstep mode: a value per Armijo trial, then a value+gradient at the
    accepted point.  async_ls (bfgs_run_async): each lane walks its own
    (iteration, trial) pair, one value+gradient per tick for at most
    maxiters * num_trials + 1 ticks; a lane with no descent direction is
    done at once.  The counters then are active ticks and accepts.

    done_frac < 1 (K8): the loops end group by group (_GroupStop).  The
    flag a lane votes is the JAX loop's own.  In lockstep mode it is not
    sticky (:818-819): a lane that moved reads |g|^2 < 1e-4 at its new
    point; so does, at its unchanged point, a lane that is converged or has
    no descent direction; a lane that ran out of trials reads done at that
    iteration and at every second one after it (in between it is excused
    from the line search and reads |g|^2 < 1e-4 like the others).  Under
    async_ls the flag is the lane's own stop and is sticky (:923-928).  The
    last value returned is the number of iterations (ticks) each lane's
    group ran, zero when uncoupled.  A target of 0 (done_frac < 1/GROUP) is
    reached before the first iteration, as in the JAX loop's test (:733,
    :869): no iteration runs.  A list passed as `votes` receives the groups'
    done counts by iteration (_GroupStop.votes)."""
    lanes = rigid0.shape[0]
    dev = rigid0.device
    log2f = float(np.log2(ls_factor))
    f_init, met_init, g, _ = _eval(terms, rigid0, tors0, scal, pack, True)
    d = g.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    dofm = pack.dofmask[pack.lane_lig.long()]
    h = eye.expand(lanes, d, d).clone()
    rigid, tors, f0, met = rigid0, tors0, f_init, met_init
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    n_trials = torch.zeros(lanes, dtype=torch.float32, device=dev)
    n_iters = torch.zeros_like(n_trials)
    n_acc = torch.zeros_like(n_trials)
    group = (_GroupStop(lanes, done_frac, dev,
                        _run_slots(maxiters, num_trials, async_ls))
             if done_frac < 1.0 else None)
    g_iters = torch.zeros_like(n_trials)
    if group is not None and group.target <= 0.0:
        last_rigid, last_tors = rigid0, tors0
    elif async_ls:
        tl = torch.zeros_like(n_trials)
        itl = torch.zeros_like(n_trials)
        last_rigid, last_tors = rigid0, tors0
        max_ticks = maxiters * num_trials + 1
        for tick in range(max_ticks):
            p = -torch.einsum("lij,lj->li", h, g) * dofm
            pg = torch.sum(p * g, dim=1)
            entered = ~done
            done = done | (pg >= 0.0)
            active = ~done
            alpha = torch.exp2(-tl * log2f)
            r_t, t_t = _increment(rigid, tors, p, alpha)
            last_rigid = torch.where(entered[:, None], r_t, last_rigid)
            last_tors = torch.where(entered[:, None], t_t, last_tors)
            if bool(active.any()):
                f1, fm1, g1, _ = _eval(terms, r_t, t_t, scal, pack, True)
                okb = active & ((f1 - f0) < C0 * alpha * pg)
                n_trials += active.float()
                n_acc += okb.float()
                y = g1 - g
                h = torch.where((okb & (itl == 0.0))[:, None, None],
                                _first_scale(h, y, p, alpha, eye), h)
                conv = torch.sum(g1 * g1, dim=1) < 1e-4
                itl = itl + okb.float()
                stuck = active & ~okb & (tl + 1.0 >= float(num_trials))
                done = (done | (okb & (conv | (itl >= float(maxiters))))
                        | stuck)
                h_upd, ok_h = _bfgs_update(h, p, y, alpha)
                h = torch.where((okb & ok_h & ~done)[:, None, None], h_upd, h)
                rigid = torch.where(okb[:, None], r_t, rigid)
                tors = torch.where(okb[:, None], t_t, tors)
                g = torch.where(okb[:, None], g1, g)
                f0 = torch.where(okb, f1, f0)
                met = torch.where(okb, fm1, met)
                tl = torch.where(okb, 0.0, torch.where(active, tl + 1.0, tl))
            elif group is None:
                break
            if group is not None:
                done = done | group.vote(done, tick)
                if bool(group.halted.all()):
                    break
        n_iters = n_acc.clone()
        if group is not None:
            g_iters = group.finish(max_ticks)
    else:
        stuck_it = torch.full((lanes,), -1, dtype=torch.long, device=dev)
        for it in range(maxiters):
            p = -torch.einsum("lij,lj->li", h, g) * dofm
            pg = torch.sum(p * g, dim=1)
            done = done | (pg >= 0.0)
            active = ~done
            n_iters += active.float()
            accepted = torch.zeros_like(done)
            trig, ttors = rigid, tors
            alpha = torch.zeros_like(f0)
            f1 = f0
            fm1 = met
            for t in range(num_trials):
                pend = active & ~accepted
                if not bool(pend.any()):
                    break
                a_t = torch.full_like(f0, 2.0 ** (-t * log2f))
                r_t, t_t = _increment(rigid, tors, p, a_t)
                e_t, m_t, _, _ = _eval(terms, r_t, t_t, scal, pack, False)
                n_trials += pend.float()
                ok = pend & ((e_t - f0) < C0 * a_t * pg)
                trig = torch.where(ok[:, None], r_t, trig)
                ttors = torch.where(ok[:, None], t_t, ttors)
                alpha = torch.where(ok, a_t, alpha)
                f1 = torch.where(ok, e_t, f1)
                fm1 = torch.where(ok, m_t, fm1)
                accepted = accepted | ok
            # a lane that exhausted every trial is deterministically stuck
            stuck_now = active & ~accepted
            done = done | stuck_now
            step = active & accepted
            n_acc += step.float()
            if bool(step.any()):
                _, _, g_new, _ = _eval(terms, trig, ttors, scal, pack, True)
                g_new = torch.where(step[:, None], g_new, g)
                y = g_new - g
                if it == 0:
                    h = torch.where(step[:, None, None],
                                    _first_scale(h, y, p, alpha, eye), h)
                conv = torch.sum(g_new * g_new, dim=1) < 1e-4
                h_upd, ok_h = _bfgs_update(h, p, y, alpha)
                h = torch.where((step & ok_h & ~conv)[:, None, None], h_upd,
                                h)
                rigid = torch.where(step[:, None], trig, rigid)
                tors = torch.where(step[:, None], ttors, tors)
                g = g_new
                f0 = torch.where(step, f1, f0)
                met = torch.where(step, fm1, met)
                done = done | (step & conv)
            elif group is None:
                break
            if group is not None:
                stuck_it = torch.where(stuck_now, it, stuck_it)
                small = torch.sum(g * g, dim=1) < 1e-4
                donef = small | ((stuck_it >= 0)
                                 & ((it - stuck_it) % 2 == 0))
                done = done | group.vote(donef, it)
                if bool(group.halted.all()):
                    break
        last_rigid, last_tors = rigid, tors
        if group is not None:
            g_iters = group.finish(maxiters)
    # restore original if not improved (bfgs.h:491, NaN-safe)
    improved = f0 <= f_init
    rigid = torch.where(improved[:, None], rigid, rigid0)
    tors = torch.where(improved[:, None], tors, tors0)
    f_out = torch.where(improved, f0, f_init)
    met_out = torch.where(improved, met, met_init)
    if votes is not None and group is not None:
        votes.append(group.votes)
    return (rigid, tors, f_out, met_out, n_trials, n_iters, n_acc,
            last_rigid, last_tors, g_iters)


def bfgs_minimize_plain(terms: VinaTerms, rigid0, tors0, scal,
                        pack: DockPack, maxiters: int, want_metro: bool = True,
                        num_trials: int = NUM_TRIALS, ls_factor: float = 2.0,
                        *, async_ls: bool = False, done_frac: float = 1.0,
                        votes: Optional[list] = None):
    """K2 (and K4 with async_ls, K8 with done_frac < 1), plain: one
    truncated BFGS per lane (bfgs.h:357-502).

    Armijo backtracking with first accept (alpha = ls_factor^-t, t <
    num_trials, c0 = 1e-4), first-step Hessian scaling, the update guard
    and the NaN-safe restore-if-not-improved.  A lane stops for good once
    it converges (|g|^2 < 1e-4), has no descent direction, or exhausts
    every trial without an accept — from then on its state can no longer
    change.  Returns rigid (L, 8), tors (L, M), stats (L, 8) = [f, metro,
    trial evals, iterations, accepted iterations, 0...], coords (L, N, 3);
    under async_ls stats rows 2 and 3 are the lane's active ticks and
    accepts (pallas_dock.py:888-889).  With done_frac < 1 the loops end
    group by group (_bfgs_run_plain) and stats row 5 is the number of
    iterations (ticks) the lane's group ran; it is what the JAX kernel's
    lockstep loop counts in its stats row 3.  A list passed as `votes`
    then receives one int32 tensor (groups, iterations): how many of a
    group's real lanes read done after each iteration the group ran, -1
    from its stop on (what K8's barrier words hold)."""
    (rigid, tors, f_out, met_out, n_trials, n_iters, n_acc, _, _,
     g_iters) = _bfgs_run_plain(terms, rigid0, tors0, scal, pack, maxiters,
                                num_trials, ls_factor, async_ls, done_frac,
                                votes)
    if not want_metro:
        met_out = torch.zeros_like(met_out)
    coords = fk_packed(rigid, tors, pack)
    z = torch.zeros_like(f_out)
    stats = torch.stack([f_out, met_out, n_trials, n_iters, n_acc, g_iters,
                         z, z], 1)
    return rigid, tors, stats, coords


def _gyration(coords, rigid, ap):
    """Heavy-atom RMS distance from the root origin (model.cpp:1002)."""
    hv = ap[..., 4]
    d2 = torch.sum(hv * torch.sum((coords - rigid[:, None, 0:3]) ** 2, -1), -1)
    cnt = torch.clamp(torch.sum(hv, dim=-1), min=1.0)
    return torch.sqrt(d2 / cnt)


def _rand_sphere(u):
    """Uniform point in the unit ball from 5 uniforms (random_inside_sphere:
    normal direction x cbrt(U))."""
    u1 = torch.clamp(u[:, 0], min=1e-7)
    u3 = torch.clamp(u[:, 2], min=1e-7)
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    n1 = r1 * torch.cos(2.0 * math.pi * u[:, 1])
    n2 = r1 * torch.sin(2.0 * math.pi * u[:, 1])
    n3 = r2 * torch.cos(2.0 * math.pi * u[:, 3])
    inv = torch.rsqrt(n1 * n1 + n2 * n2 + n3 * n3 + 1e-12)
    rad = torch.exp(torch.log(torch.clamp(u[:, 4], min=1e-7)) / 3.0)
    sc = inv * rad
    return torch.stack([n1 * sc, n2 * sc, n3 * sc], dim=1)


def _mutate(rigid, tors, gr, u, dofm, amp):
    """One-DOF mutation (mutate.cpp:35-73): position, orientation, or one
    torsion redraw, drawn uniformly from uniforms u[:, 0:12]."""
    hasrig = dofm[:, 0]
    ntors = torch.sum(dofm[:, 6:], dim=1)
    lo_row = 2.0 * (1.0 - hasrig)
    span = ntors + 2.0 - lo_row
    which = torch.minimum(torch.floor(lo_row + u[:, 0] * span), ntors + 1.0)
    s = _rand_sphere(u[:, 1:6])
    pos_sel = (which < 0.5)[:, None]
    pos = torch.where(pos_sel, rigid[:, 0:3] + amp * s, rigid[:, 0:3])
    o = _rand_sphere(u[:, 6:11])
    rs = amp / torch.clamp(gr, min=EPSILON_FL)
    q = Q.quaternion_increment(rigid[:, 3:7], rs[:, None] * o)
    ori_sel = ((which >= 0.5) & (which < 1.5) & (gr > EPSILON_FL))[:, None]
    quat = torch.where(ori_sel, q, rigid[:, 3:7])
    m = tors.shape[1]
    rows = torch.arange(m, device=tors.device, dtype=torch.float32)[None, :]
    row_sel = (rows == (which - 1.0)[:, None]) & (which >= 1.5)[:, None]
    newt = (u[:, 11] * (2.0 * math.pi) - math.pi)[:, None]
    tors_new = torch.where(row_sel, newt, tors)
    rigid_new = torch.cat([pos, quat, torch.zeros_like(pos[:, :1])], dim=1)
    return rigid_new, tors_new


def _window_uniforms(draws: int, lanes: int, generator, dev,
                     lane_offset: int = 0, lane_total: Optional[int] = None):
    """A window's uniforms (draws, N_DRAWS, lanes) for lanes lane_offset..
    of a batch of lane_total lanes: drawn for the whole batch, sliced."""
    total = lane_offset + lanes if lane_total is None else int(lane_total)
    if lane_offset < 0 or lane_offset + lanes > total:
        raise ValueError(f"lanes {lane_offset}..{lane_offset + lanes} "
                         f"outside a batch of {total}")
    u = torch.rand((draws, N_DRAWS, total), generator=generator,
                   dtype=torch.float32, device=dev)
    if total == lanes:
        return u
    return u[:, :, lane_offset:lane_offset + lanes].contiguous()


def async_mc_window_plain(terms: VinaTerms, rigid0, tors0, scal,
                          pack: DockPack, ecur, mc_steps: int,
                          tick_budget: int, maxiters: int,
                          num_trials: int = NUM_TRIALS,
                          ls_factor: float = 2.0, uniforms=None,
                          generator: Optional[torch.Generator] = None,
                          trace: bool = False, warm_ls: bool = False,
                          lane_offset: int = 0,
                          lane_total: Optional[int] = None):
    """K3 (and K6 with warm_ls), plain: a window of mc_steps Monte Carlo
    steps per lane (monte_carlo.cpp:99-148), each lane a state machine over
    (step, BFGS iteration, Armijo trial) advanced by one fused
    value+gradient eval per tick, at most mc_steps * tick_budget ticks.

    Tick k draws N_DRAWS uniforms per lane: uniforms[k, 0:12] feed the
    mutation of the chain state (used by lanes that open a candidate this
    tick), uniforms[k, 12] the Metropolis test of lanes that complete one.
    uniforms (ticks, 13, L) is taken as given when supplied, else drawn
    from `generator`: for lanes 0..lane_total-1 of the whole batch
    (lane_total defaults to lane_offset + L), of which this call's lanes
    are lane_offset..lane_offset+L-1, so a shard draws what the unsharded
    call draws for its lanes (the kernel keys its stream on lane_offset +
    lane).

    warm_ls: a lane's Armijo exponent starts at max(wa - 1, 0) + trial
    instead of the trial count, where wa is the exponent of its last
    accepted step, reset to 0 at each new candidate
    (pallas_dock.py:1150-1152, :1231-1233).

    Returns the final chain state (rigid, tors), stats (L, 8) = [e, e,
    evals, accepted BFGS steps, completed steps, 0...], chain coords
    (L, N, 3), and the completion-indexed stream: row j of a lane holds its
    j-th completed candidate, srigid (L, S, 8), stors (L, S, M), sstat
    (L, S, 3) = (metro energy, accepted, 1); rows never completed are
    zero.  trace=True appends a dict that, for each stream row, names the
    mutated start its BFGS ran from (start_rigid (L, S, 8), start_tors
    (L, S, M)) and the tick it completed at (done_tick (L, S), -1 if
    never), so a test can replay every step; and, per tick, the Armijo
    exponent each lane's trial used (exponent (ticks, L), NaN on a tick
    that evaluated a mutated start or found no descent direction) and
    whether the trial was accepted (accepted (ticks, L))."""
    lanes, m = tors0.shape
    dev = rigid0.device
    s_total = mc_steps * tick_budget
    log2f = float(np.log2(ls_factor))
    if uniforms is None:
        uniforms = _window_uniforms(s_total, lanes, generator, dev,
                                    lane_offset, lane_total)
    if uniforms.shape[0] < s_total:
        raise ValueError("uniforms hold fewer ticks than the window budget")
    lig = pack.lane_lig.long()
    dofm = pack.dofmask[lig]
    ap = pack.ap[lig]
    d = dofm.shape[1]
    amp, temp = scal[10], scal[11]
    eye = torch.eye(d, dtype=torch.float32, device=dev)

    coords0 = fk_packed(rigid0, tors0, pack)
    gr_cur = _gyration(coords0, rigid0, ap)
    crig, ctors, e_cur = rigid0, tors0, ecur.clone()
    rigid, tors = rigid0, tors0
    g = torch.zeros((lanes, d), dtype=torch.float32, device=dev)
    h = eye.expand(lanes, d, d).clone()
    zf = torch.zeros(lanes, dtype=torch.float32, device=dev)
    f0, met, gr_cand, tl, itl, stepc, wa = zf, zf, gr_cur, zf, zf, zf, zf
    start = torch.ones(lanes, dtype=torch.bool, device=dev)
    n_eval, n_ok = zf, zf
    srig = torch.zeros((lanes, mc_steps, 8), dtype=torch.float32, device=dev)
    stor = torch.zeros((lanes, mc_steps, m), dtype=torch.float32, device=dev)
    sstat = torch.zeros((lanes, mc_steps, 3), dtype=torch.float32, device=dev)
    lane_ix = torch.arange(lanes, device=dev)
    if trace:
        st_rig = torch.zeros_like(srig)
        st_tor = torch.zeros_like(stor)
        st_tick = torch.full((lanes, mc_steps), -1, dtype=torch.int64,
                             device=dev)
        cur_rig, cur_tor = rigid0, tors0
        tr_exp, tr_acc = [], []
    for tick in range(s_total):
        active = stepc < mc_steps
        if not bool(active.any()):
            break
        u = uniforms[tick].T                                     # (L, 13)
        mrig, mtors = _mutate(crig, ctors, gr_cur, u, dofm, amp)
        p = -torch.einsum("lij,lj->li", h, g) * dofm
        pg = torch.sum(p * g, dim=1)
        expnt = torch.clamp(wa - 1.0, min=0.0) + tl if warm_ls else tl
        alpha = torch.exp2(-expnt * log2f)
        trig, ttors = _increment(rigid, tors, p, alpha)
        erig = torch.where(start[:, None], mrig, trig)
        etors = torch.where(start[:, None], mtors, ttors)
        f1, fm1, g1, ecrd = _eval(terms, erig, etors, scal, pack, True)
        gy1 = _gyration(ecrd, erig, ap)
        n_eval = n_eval + active.float()

        is_start = start & active
        is_bfgs = ~start & active
        nodesc = is_bfgs & (pg >= 0.0)
        okb = is_bfgs & ~nodesc & ((f1 - f0) < C0 * alpha * pg)
        n_ok = n_ok + okb.float()

        y = g1 - g
        h = torch.where((okb & (itl == 0.0))[:, None, None],
                        _first_scale(h, y, p, alpha, eye), h)
        h_upd, ok_h = _bfgs_update(h, p, y, alpha)
        h = torch.where((okb & ok_h)[:, None, None], h_upd, h)
        h = torch.where(is_start[:, None, None], eye, h)

        conv_ok = okb & (torch.sum(g1 * g1, dim=1) < 1e-4)
        itl_acc = itl + okb.float()
        budget_ok = okb & (itl_acc >= float(maxiters))
        rejb = is_bfgs & ~okb & ~nodesc
        stuck = rejb & (tl + 1.0 >= float(num_trials))
        cdone = nodesc | stuck | conv_ok | budget_ok

        upd = okb | is_start
        rigid = torch.where(upd[:, None], erig, rigid)
        tors = torch.where(upd[:, None], etors, tors)
        g = torch.where(upd[:, None], g1, g)
        f0 = torch.where(upd, f1, f0)
        met = torch.where(upd, fm1, met)
        gr_cand = torch.where(upd, gy1, gr_cand)
        itl = torch.where(is_start, 0.0, itl_acc)
        tl = torch.where(is_start | okb, 0.0, torch.where(rejb, tl + 1.0, tl))
        wa = torch.where(is_start, 0.0, torch.where(okb, expnt, wa))

        # step completion: Metropolis at the candidate's metro energy
        e_new = met
        macc = cdone & ((e_new < e_cur)
                        | (u[:, 12] < torch.exp((e_cur - e_new) / temp)))
        crig = torch.where(macc[:, None], rigid, crig)
        ctors = torch.where(macc[:, None], tors, ctors)
        e_cur = torch.where(macc, e_new, e_cur)
        gr_cur = torch.where(macc, gr_cand, gr_cur)
        if trace:
            tr_exp.append(torch.where(is_bfgs & ~nodesc, expnt,
                                      float("nan")))
            tr_acc.append(okb)
            cur_rig = torch.where(is_start[:, None], mrig, cur_rig)
            cur_tor = torch.where(is_start[:, None], mtors, cur_tor)
        if bool(cdone.any()):
            li = lane_ix[cdone]
            row = stepc[cdone].long()
            srig[li, row] = rigid[cdone]
            stor[li, row] = tors[cdone]
            sstat[li, row] = torch.stack(
                [e_new[cdone], macc[cdone].float(),
                 torch.ones_like(e_new[cdone])], dim=1)
            if trace:
                st_rig[li, row] = cur_rig[cdone]
                st_tor[li, row] = cur_tor[cdone]
                st_tick[li, row] = tick
        stepc = stepc + cdone.float()
        start = torch.where(cdone, True, torch.where(is_start, False, start))

    coords = fk_packed(crig, ctors, pack)
    z = torch.zeros_like(e_cur)
    stats = torch.stack([e_cur, e_cur, n_eval, n_ok, stepc, z, z, z], 1)
    out = (crig, ctors, stats, coords, srig, stor, sstat)
    if trace:
        out += (dict(start_rigid=st_rig, start_tors=st_tor,
                     done_tick=st_tick, exponent=torch.stack(tr_exp),
                     accepted=torch.stack(tr_acc)),)
    return out


def replay_mc_window_plain(terms: VinaTerms, rigid0, tors0, scal,
                           pack: DockPack, ecur, stream, uniforms,
                           maxiters: int = 1, num_trials: int = NUM_TRIALS,
                           ls_factor: float = 2.0, warm_ls: bool = False):
    """Step by step, the plain version of each stream row of a K3 window
    that completed all its steps on supplied uniforms: from that window's
    own chain head, the plain one-step window on the uniforms of the ticks
    the row began at (the mutation by the start tick's draws, then the
    candidate search at `maxiters`, under warm_ls if set).  Each row is
    held to its own start, so a window whose chain heads carry earlier
    rows' float32 differences is still compared at the bound of one
    candidate search.

    stream = (srigid (L, S, 8), stors (L, S, M), sstat (L, S, 3)) of the
    window under test.  Returns per-row energies (L, S), positions
    (L, S, 3), the Metropolis decisions recomputed from the window's own
    energies and the row's completion-tick uniform (L, S), and each lane's
    ticks (L,)."""
    srig, stor, sstat = stream
    lanes, s_steps = sstat.shape[:2]
    temp = scal[11]
    dev = rigid0.device
    ix = torch.arange(lanes, device=dev)
    budget = 1 + maxiters * num_trials
    span = torch.arange(budget, device=dev)[:, None]
    crig, ctors, e_cur = rigid0, tors0, ecur.clone()
    tick = torch.zeros(lanes, dtype=torch.long, device=dev)
    es, pos, accs = [], [], []
    for j in range(s_steps):
        # each lane's next `budget` ticks of draws: the start tick, then
        # one tick per Armijo trial (a start with no descent direction
        # still spends the tick that finds it out)
        tk = torch.clamp(tick[None, :] + span, max=uniforms.shape[0] - 1)
        u_j = uniforms[tk, :, ix[None, :]].permute(0, 2, 1).contiguous()
        out = async_mc_window_plain(terms, crig, ctors, scal, pack, e_cur, 1,
                                    budget, maxiters, num_trials, ls_factor,
                                    uniforms=u_j, warm_ls=warm_ls)
        done = tick + out[2][:, 2].long() - 1
        ek = sstat[:, j, 0]
        accs.append((ek < e_cur) | (uniforms[done, 12, ix]
                                    < torch.exp((e_cur - ek) / temp)))
        es.append(out[6][:, 0, 0])
        pos.append(out[4][:, 0, :3])
        kacc = sstat[:, j, 1] > 0.5
        crig = torch.where(kacc[:, None], srig[:, j], crig)
        ctors = torch.where(kacc[:, None], stor[:, j], ctors)
        e_cur = torch.where(kacc, ek, e_cur)
        tick = done + 1
    return (torch.stack(es, 1), torch.stack(pos, 1), torch.stack(accs, 1),
            tick)


def lockstep_mc_window_plain(terms: VinaTerms, rigid0, tors0, scal,
                             pack: DockPack, ecur, mc_steps: int,
                             maxiters: int, num_trials: int = NUM_TRIALS,
                             ls_factor: float = 2.0, async_ls: bool = False,
                             uniforms=None,
                             generator: Optional[torch.Generator] = None,
                             trace: bool = False, done_frac: float = 1.0,
                             lane_offset: int = 0,
                             lane_total: Optional[int] = None):
    """K5, plain: a step-indexed window of mc_steps Monte Carlo steps per
    lane (pallas_dock.py mc_body :1290): FK of the chain state, gyration,
    one-DOF mutation, one whole BFGS (in either line-search mode),
    Metropolis with one uniform.  No tick budget: every step completes.

    Step k draws N_DRAWS uniforms per lane: uniforms[k, 0:12] feed the
    mutation, uniforms[k, 12] the Metropolis test.  uniforms (steps, 13, L)
    is taken as given when supplied, else drawn from `generator` for the
    whole batch's lanes and sliced at lane_offset, as in
    async_mc_window_plain.

    Returns the final chain state (rigid, tors), stats (L, 8) = [e, e,
    trial evals, iterations, accepted iterations, 0...], coords (L, N, 3),
    and the step-indexed stream srigid (L, S, 8), stors (L, S, M), sstat
    (L, S, 3) = (metro energy, accepted, trial evals of the step).  The
    coordinates are those of the last step's last BFGS evaluation, not of
    the final chain state: the JAX kernel returns the coordinates of its
    last FK (:1320-1322).  That is the last iterate before the restore in
    lockstep mode and the last tick's trial point under async_ls
    (_bfgs_run_plain).  trace=True appends a dict with the mutated start of
    every step (start_rigid (L, S, 8), start_tors (L, S, M)).  With
    done_frac < 1 (K8) every step's BFGS ends group by group, and stats row
    5 sums the iterations (ticks) the lane's group ran over the steps."""
    lanes, m = tors0.shape
    dev = rigid0.device
    if uniforms is None:
        uniforms = _window_uniforms(mc_steps, lanes, generator, dev,
                                    lane_offset, lane_total)
    if uniforms.shape[0] < mc_steps:
        raise ValueError("uniforms hold fewer steps than the window")
    lig = pack.lane_lig.long()
    dofm, ap = pack.dofmask[lig], pack.ap[lig]
    amp, temp = scal[10], scal[11]
    crig, ctors, e_cur = rigid0, tors0, ecur.clone()
    last_rig, last_tor = rigid0, tors0
    n_trials = torch.zeros(lanes, dtype=torch.float32, device=dev)
    n_iters = torch.zeros_like(n_trials)
    n_acc = torch.zeros_like(n_trials)
    g_iters = torch.zeros_like(n_trials)
    srig, stor, sstat, st_rig, st_tor = [], [], [], [], []
    for step in range(mc_steps):
        u = uniforms[step].T                                     # (L, 13)
        gr = _gyration(fk_packed(crig, ctors, pack), crig, ap)
        mrig, mtors = _mutate(crig, ctors, gr, u, dofm, amp)
        (nrig, ntor, _f, e_new, tr, it, ac, last_rig, last_tor,
         gi) = _bfgs_run_plain(terms, mrig, mtors, scal, pack, maxiters,
                               num_trials, ls_factor, async_ls, done_frac)
        g_iters = g_iters + gi
        n_trials = n_trials + tr
        n_iters = n_iters + it
        n_acc = n_acc + ac
        acc = (e_new < e_cur) | (u[:, 12] < torch.exp((e_cur - e_new) / temp))
        srig.append(nrig)
        stor.append(ntor)
        sstat.append(torch.stack([e_new, acc.float(), tr], dim=1))
        st_rig.append(mrig)
        st_tor.append(mtors)
        crig = torch.where(acc[:, None], nrig, crig)
        ctors = torch.where(acc[:, None], ntor, ctors)
        e_cur = torch.where(acc, e_new, e_cur)
    coords = fk_packed(last_rig, last_tor, pack)
    z = torch.zeros_like(e_cur)
    stats = torch.stack([e_cur, e_cur, n_trials, n_iters, n_acc, g_iters, z,
                         z], 1)

    def stack(rows, width):
        if rows:
            return torch.stack(rows, dim=1)
        return torch.zeros((lanes, 0, width), dtype=torch.float32, device=dev)

    out = (crig, ctors, stats, coords, stack(srig, 8), stack(stor, m),
           stack(sstat, 3))
    if trace:
        out += (dict(start_rigid=stack(st_rig, 8),
                     start_tors=stack(st_tor, m)),)
    return out


def replay_lockstep_window_plain(terms: VinaTerms, rigid0, tors0, scal,
                                 pack: DockPack, ecur, stream, uniforms,
                                 maxiters: int, num_trials: int = NUM_TRIALS,
                                 ls_factor: float = 2.0,
                                 async_ls: bool = False,
                                 done_frac: float = 1.0):
    """Step by step, the plain version of each stream row of a K5 window on
    supplied uniforms: the plain one-step window from that window's own
    chain head on the step's uniforms.  Returns per-row energies (L, S),
    positions (L, S, 3), trial evaluations (L, S), the Metropolis decisions
    recomputed from the window's own energies (L, S), the coordinates
    (L, N, 3) the plain last step returns, and the iterations (ticks) each
    lane's group ran in each step (L, S; zero when uncoupled), whose sum
    over the steps is what the window reports in stats row 5."""
    srig, stor, sstat = stream
    s_steps = sstat.shape[1]
    temp = scal[11]
    crig, ctors, e_cur = rigid0, tors0, ecur.clone()
    es, pos, trials, accs, giters = [], [], [], [], []
    coords = fk_packed(rigid0, tors0, pack)
    for j in range(s_steps):
        out = lockstep_mc_window_plain(terms, crig, ctors, scal, pack, e_cur,
                                       1, maxiters, num_trials, ls_factor,
                                       async_ls, uniforms=uniforms[j:j + 1],
                                       done_frac=done_frac)
        ek = sstat[:, j, 0]
        accs.append((ek < e_cur) | (uniforms[j, 12]
                                    < torch.exp((e_cur - ek) / temp)))
        es.append(out[6][:, 0, 0])
        pos.append(out[4][:, 0, :3])
        trials.append(out[6][:, 0, 2])
        giters.append(out[2][:, 5])
        coords = out[3]
        kacc = sstat[:, j, 1] > 0.5
        crig = torch.where(kacc[:, None], srig[:, j], crig)
        ctors = torch.where(kacc[:, None], stor[:, j], ctors)
        e_cur = torch.where(kacc, ek, e_cur)
    return (torch.stack(es, 1), torch.stack(pos, 1), torch.stack(trials, 1),
            torch.stack(accs, 1), coords, torch.stack(giters, 1))


# --------------------------------------------------------------------------
# CUDA kernels (csrc/fused_dock.cu), bound with ctypes
# --------------------------------------------------------------------------

class _PackArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "lc", "ap", "node", "parent", "layer", "relax", "relo", "imask",
        "dofmask", "nheavy", "rec", "lane_lig")]
        + [(f, ctypes.c_int) for f in ("L", "N", "M", "LY", "K", "D",
                                        "rec_tile")])


class _TermArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in ("ng", "nr", "nh", "nb")]
                + [(f, ctypes.c_float * 4) for f in ("g_off", "g_width",
                                                     "g_w")]
                + [(f, ctypes.c_float * 2) for f in (
                    "r_off", "r_w", "h_good", "h_bad", "h_w", "b_good",
                    "b_bad", "b_w")]
                + [("cutoff_sqr", ctypes.c_float)])


def _term_args(terms: VinaTerms) -> _TermArgs:
    a = _TermArgs()
    a.ng, a.nr = len(terms.gauss), len(terms.repulsion)
    a.nh, a.nb = len(terms.hydrophobic), len(terms.hbond)
    for i, (off, width, w) in enumerate(terms.gauss):
        a.g_off[i], a.g_width[i], a.g_w[i] = off, width, w
    for i, (off, w) in enumerate(terms.repulsion):
        a.r_off[i], a.r_w[i] = off, w
    for i, (good, bad, w) in enumerate(terms.hydrophobic):
        a.h_good[i], a.h_bad[i], a.h_w[i] = good, bad, w
    for i, (good, bad, w) in enumerate(terms.hbond):
        a.b_good[i], a.b_bad[i], a.b_w[i] = good, bad, w
    a.cutoff_sqr = terms.cutoff_sqr
    return a


_PACK_DTYPES = {"lc": torch.float32, "ap": torch.float32,
                "node": torch.int32, "parent": torch.int32,
                "layer": torch.int32, "relax": torch.float32,
                "relo": torch.float32, "imask": torch.float32,
                "dofmask": torch.float32, "nheavy": torch.int32,
                "rec": torch.float32, "lane_lig": torch.int32}


def _check(t, name, shape, dtype, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pack_args(pack: DockPack, device) -> _PackArgs:
    n, m, ly, k, lanes = pack.dims
    g = pack.lc.shape[0]
    d = 6 + m - 1
    shapes = {"lc": (g, n, 3), "ap": (g, n, 6), "node": (g, n),
              "parent": (g, m), "layer": (g, m), "relax": (g, m, 3),
              "relo": (g, m, 3), "imask": (g, n, n), "dofmask": (g, d),
              "nheavy": (g,), "rec": (k, 8), "lane_lig": (lanes,)}
    a = _PackArgs()
    for f, shape in shapes.items():
        t = getattr(pack, f)
        _check(t, f"pack.{f}", shape, _PACK_DTYPES[f], device)
        setattr(a, f, t.data_ptr())
    a.L, a.N, a.M, a.LY, a.K, a.D = lanes, n, m, ly, k, d
    a.rec_tile = smem_plan(n, m, d, k).rec_tile
    return a


def _raise_on(code: int, name: str):
    if code != 0:
        from gnina_tpu_torch.ops import _cuda

        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{_cuda.error_string(code)}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _addr(struct):
    """Host address of a ctypes struct (the caller keeps it alive)."""
    return ctypes.c_void_p(ctypes.addressof(struct))


class _Made:
    """What one call of a launch function made: the kernel launches (a host
    int the C entry point sets) and, under K8, the lanes' overruns."""

    def __init__(self):
        self.n = ctypes.c_int(0)
        self.overrun = None


class _KernelWrapper:
    """A kernel's Python entry point: plain version on CPU tensors, the
    CUDA kernel on CUDA tensors.  `launches` counts the launches of the
    kernel, as the C entry point reports them: one per call, or with
    done_frac < 1 (K8) one cooperative launch per set of co-resident groups
    (at most 256 lanes a launch on 132 SMs, so a call at 800 lanes makes
    four).  `calls` counts the wrapper calls that launched.
    `launches_by_lanes` splits the launches by the call's lane count
    (`calls_by_lanes` the calls) and `launches_by_mode` by the kernel mode
    the call selected (the keyword named `mode_flag`: async_ls on K2 and K5,
    warm_ls on K3); `launches_coupled` counts the launches with done_frac <
    1.  The fill that zeroes K8's scratch is PyTorch's and is not counted.
    Every plain and launch function takes its mode flag and done_frac by
    keyword only, so the count cannot miss a flag passed by position.
    After a call with done_frac < 1 on the card, `overrun` holds a (L,)
    int32 tensor on the card: the iterations (ticks) each lane ran past its
    group's stop, summed over the call's runs, before it took its state at
    the stop back from K8's ring (csrc/fused_dock.cu GroupSync).  Which
    lanes run ahead is up to the scheduler; no output depends on it."""

    def __init__(self, name, plain, launch, mode_flag=None):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.mode_flag = mode_flag
        self.reset()

    def reset(self):
        self.launches = 0
        self.calls = 0
        self.launches_by_lanes = collections.Counter()
        self.calls_by_lanes = collections.Counter()
        self.launches_by_mode = collections.Counter()
        self.launches_coupled = 0
        self.overrun = None

    def __call__(self, terms: VinaTerms, rigid, tors, scal, pack: DockPack,
                 *args, **kw):
        if rigid.device.type == "cpu":
            return self.plain(terms, rigid, tors, scal, pack, *args, **kw)
        if rigid.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device "
                             f"{rigid.device}")
        made = _Made()
        try:
            return self._launch(made, terms, rigid, tors, scal, pack, *args,
                                **kw)
        finally:
            with _COUNT_LOCK:   # shards launch from threads of their own
                self._count(made, rigid, kw)

    def _count(self, made, rigid, kw):
        n = made.n.value
        if made.overrun is not None:
            self.overrun = made.overrun
        self.launches += n
        self.calls += int(n > 0)
        self.launches_by_lanes[int(rigid.shape[0])] += n
        self.calls_by_lanes[int(rigid.shape[0])] += int(n > 0)
        self.launches_by_mode[bool(kw.get(self.mode_flag, False))] += n
        if kw.get("done_frac", 1.0) < 1.0:
            self.launches_coupled += n


def _common_checks(rigid, tors, scal, pack: DockPack):
    dev = rigid.device
    n, m, ly, k, lanes = pack.dims
    _check(rigid, "rigid", (lanes, 8), torch.float32, dev)
    _check(tors, "tors", (lanes, m), torch.float32, dev)
    _check(scal, "scal", (12,), torch.float32, dev)
    return dev, n, m, lanes


def _launch_eval_fg(made, terms, rigid, tors, scal, pack):
    from gnina_tpu_torch.ops import _cuda

    dev, n, m, lanes = _common_checks(rigid, tors, scal, pack)
    pa = _pack_args(pack, dev)
    e = torch.empty(lanes, dtype=torch.float32, device=dev)
    em = torch.empty_like(e)
    g = torch.empty((lanes, pa.D), dtype=torch.float32, device=dev)
    coords = torch.empty((lanes, n, 3), dtype=torch.float32, device=dev)
    ta = _term_args(terms)
    code = _cuda.lib().gt_eval_fg(
        _addr(pa), _addr(ta), _ptr(rigid), _ptr(tors),
        _ptr(scal), _ptr(e), _ptr(em), _ptr(g), _ptr(coords), _stream(),
        ctypes.byref(made.n))
    _raise_on(code, "eval_fg")
    return e, em, g, coords


def ring_floats(m: int) -> int:
    """Floats of one K8 ring record (csrc/fused_dock.cu ring_floats): the
    iterate (8 + M), the trial point (8 + M), f, the Metropolis energy and
    the three counters."""
    return 2 * (8 + m) + 5


def k8_scratch_words(lanes: int, m: int, run_slots: int, runs: int) -> int:
    """32-bit words of K8's scratch (csrc/fused_dock.cu GroupSync) for
    `runs` runs of `run_slots` iterations (ticks) each: per group the done
    words (runs x run_slots) and a leave count a run, per lane an overrun
    count and a ring of run_slots records."""
    if min(lanes, m) < 1 or min(run_slots, runs) < 0:
        raise ValueError(f"K8 scratch for lanes={lanes}, m={m}, "
                         f"run_slots={run_slots}, runs={runs}")
    groups = -(-lanes // GROUP)
    return (groups * runs * run_slots + groups * runs + lanes
            + lanes * run_slots * ring_floats(m))


class _GroupScratch(NamedTuple):
    """K8's scratch of one call: the zeroed buffer the kernel takes, its
    done words (groups, runs x run_slots) and lane overruns (L,) as views,
    and the target count."""

    buf: torch.Tensor
    words: torch.Tensor
    overrun: torch.Tensor
    per_group: int
    target: int


def _group_scratch(lanes, m, run_slots, runs, done_frac, device):
    """K8's scratch, or None when uncoupled (done_frac = 1)."""
    if not 0.0 < done_frac <= 1.0:
        raise ValueError(f"done_frac {done_frac} outside (0, 1]")
    if done_frac >= 1.0 or lanes == 0:
        return None
    groups = -(-lanes // GROUP)
    per_group = int(run_slots) * int(runs)
    buf = torch.zeros(k8_scratch_words(lanes, m, run_slots, runs),
                      dtype=torch.int32, device=device)
    n_words = groups * per_group
    over0 = n_words + groups * runs
    return _GroupScratch(buf, buf[:n_words].view(groups, per_group),
                         buf[over0:over0 + lanes], per_group,
                         int(done_frac * GROUP))


def _scratch_args(gs):
    """The kernel's (gsync, slots_per_group, done_target) arguments."""
    if gs is None:
        return _ptr(None), 0, 0
    return _ptr(gs.buf), gs.per_group, gs.target


def _run_slots(maxiters, num_trials, async_ls):
    """Iterations (ticks) one BFGS run can take."""
    return maxiters * num_trials + 1 if async_ls else maxiters


def _launch_bfgs(made, terms, rigid, tors, scal, pack, maxiters,
                 want_metro=True, num_trials=NUM_TRIALS, ls_factor=2.0,
                 *, async_ls=False, done_frac=1.0, votes=None):
    from gnina_tpu_torch.ops import _cuda

    dev, n, m, lanes = _common_checks(rigid, tors, scal, pack)
    pa = _pack_args(pack, dev)
    gs = _group_scratch(lanes, m, _run_slots(maxiters, num_trials, async_ls),
                        1, done_frac, dev)
    orig = torch.empty_like(rigid)
    otor = torch.empty_like(tors)
    stats = torch.zeros((lanes, 8), dtype=torch.float32, device=dev)
    coords = torch.empty((lanes, n, 3), dtype=torch.float32, device=dev)
    ta = _term_args(terms)
    code = _cuda.lib().gt_bfgs_minimize(
        _addr(pa), _addr(ta), _ptr(rigid), _ptr(tors),
        _ptr(scal), int(maxiters), int(bool(want_metro)), int(num_trials),
        float(np.log2(ls_factor)), int(bool(async_ls)), _ptr(orig),
        _ptr(otor), _ptr(stats), _ptr(coords), *_scratch_args(gs), _stream(),
        ctypes.byref(made.n))
    _raise_on(code, "bfgs_minimize")
    if gs is not None:
        made.overrun = gs.overrun
        if votes is not None:
            votes.append(_votes_of(gs.words, lanes))
    return orig, otor, stats, coords


def _votes_of(w, lanes):
    """K8's done words (groups, iterations) after a launch as the plain
    version's votes: int32, the done count of a group's real lanes at every
    iteration the group met, -1 where it did not.  A word holds the
    arrivals in its high half: every block of the group, or none."""
    groups = w.shape[0]
    nblocks = torch.full((groups, 1), GROUP, dtype=torch.int32,
                         device=w.device)
    nblocks[-1] = lanes - (groups - 1) * GROUP
    arrived = w >> 16
    if not bool(((arrived == 0) | (arrived == nblocks)).all()):
        raise RuntimeError("bfgs_minimize: a group met without all of its "
                           "blocks")
    return torch.where(arrived == nblocks, w & 0xFFFF, -1)


def _mc_outputs(rigid, tors, n, mc_steps):
    """Zeroed outputs of a MC window: final state, stats, coords, stream."""
    lanes, m = tors.shape
    f = dict(dtype=torch.float32, device=rigid.device)
    return (torch.empty_like(rigid), torch.empty_like(tors),
            torch.zeros((lanes, 8), **f), torch.empty((lanes, n, 3), **f),
            torch.zeros((lanes, mc_steps, 8), **f),
            torch.zeros((lanes, mc_steps, m), **f),
            torch.zeros((lanes, mc_steps, 3), **f))


def _check_mc_inputs(rigid, tors, scal, pack, ecur, uniforms, n_draws):
    dev, n, m, lanes = _common_checks(rigid, tors, scal, pack)
    _check(ecur, "ecur", (lanes,), torch.float32, dev)
    if uniforms is not None:
        if uniforms.shape[0] < n_draws:
            raise ValueError("uniforms hold fewer draws than the window "
                             "needs")
        _check(uniforms, "uniforms", (uniforms.shape[0], N_DRAWS, lanes),
               torch.float32, dev)
    return dev, n


def _launch_mc(made, terms, rigid, tors, scal, pack, ecur, mc_steps,
               tick_budget, maxiters, num_trials=NUM_TRIALS, ls_factor=2.0, *,
               uniforms=None, seed=0, generator=None, warm_ls=False,
               lane_offset=0, lane_total=None):
    from gnina_tpu_torch.ops import _cuda

    # the kernel draws from its own Philox stream, keyed on the global lane
    del generator, lane_total
    dev, n = _check_mc_inputs(rigid, tors, scal, pack, ecur, uniforms,
                              mc_steps * tick_budget)
    pa = _pack_args(pack, dev)
    out = _mc_outputs(rigid, tors, n, mc_steps)
    ta = _term_args(terms)
    code = _cuda.lib().gt_async_mc_window(
        _addr(pa), _addr(ta), _ptr(rigid), _ptr(tors),
        _ptr(scal), _ptr(ecur), _ptr(uniforms),
        ctypes.c_uint32(int(seed) & 0xFFFFFFFF), int(lane_offset),
        int(mc_steps), int(tick_budget), int(maxiters), int(num_trials),
        float(np.log2(ls_factor)), int(bool(warm_ls)),
        *[_ptr(x) for x in out], _stream(), ctypes.byref(made.n))
    _raise_on(code, "async_mc_window")
    return out


def _launch_lockstep_mc(made, terms, rigid, tors, scal, pack, ecur, mc_steps,
                        maxiters, num_trials=NUM_TRIALS, ls_factor=2.0, *,
                        async_ls=False, uniforms=None, seed=0,
                        generator=None, done_frac=1.0, lane_offset=0,
                        lane_total=None):
    from gnina_tpu_torch.ops import _cuda

    # the kernel draws from its own Philox stream, keyed on the global lane
    del generator, lane_total
    dev, n = _check_mc_inputs(rigid, tors, scal, pack, ecur, uniforms,
                              mc_steps)
    pa = _pack_args(pack, dev)
    gs = _group_scratch(rigid.shape[0], tors.shape[1],
                        _run_slots(maxiters, num_trials, async_ls), mc_steps,
                        done_frac, dev)
    out = _mc_outputs(rigid, tors, n, mc_steps)
    ta = _term_args(terms)
    code = _cuda.lib().gt_lockstep_mc_window(
        _addr(pa), _addr(ta), _ptr(rigid), _ptr(tors),
        _ptr(scal), _ptr(ecur), _ptr(uniforms),
        ctypes.c_uint32(int(seed) & 0xFFFFFFFF), int(lane_offset),
        int(mc_steps), int(maxiters), int(num_trials),
        float(np.log2(ls_factor)),
        int(bool(async_ls)), *[_ptr(x) for x in out], *_scratch_args(gs),
        _stream(), ctypes.byref(made.n))
    _raise_on(code, "lockstep_mc_window")
    if gs is not None:
        made.overrun = gs.overrun
    return out


def _seeded(rigid, uniforms, seed, generator):
    """The plain versions' generator: the caller's, else one seeded like
    the kernel's stream (not the same numbers)."""
    if uniforms is None and generator is None:
        generator = torch.Generator(device=rigid.device)
        generator.manual_seed(int(seed))
    return generator


def _mc_plain(terms, rigid, tors, scal, pack, ecur, mc_steps, tick_budget,
              maxiters, num_trials=NUM_TRIALS, ls_factor=2.0, *,
              uniforms=None, seed=0, generator=None, warm_ls=False,
              lane_offset=0, lane_total=None):
    return async_mc_window_plain(
        terms, rigid, tors, scal, pack, ecur, mc_steps, tick_budget,
        maxiters, num_trials, ls_factor, uniforms=uniforms,
        generator=_seeded(rigid, uniforms, seed, generator), warm_ls=warm_ls,
        lane_offset=lane_offset, lane_total=lane_total)


def _lockstep_mc_plain(terms, rigid, tors, scal, pack, ecur, mc_steps,
                       maxiters, num_trials=NUM_TRIALS, ls_factor=2.0, *,
                       async_ls=False, uniforms=None, seed=0, generator=None,
                       done_frac=1.0, lane_offset=0, lane_total=None):
    return lockstep_mc_window_plain(
        terms, rigid, tors, scal, pack, ecur, mc_steps, maxiters, num_trials,
        ls_factor, async_ls, uniforms=uniforms,
        generator=_seeded(rigid, uniforms, seed, generator),
        done_frac=done_frac, lane_offset=lane_offset, lane_total=lane_total)


# K1: eval_fg(terms, rigid, tors, scal, pack)
eval_fg = _KernelWrapper("eval_fg", eval_fg_plain, _launch_eval_fg)
# K2: bfgs_minimize(terms, rigid, tors, scal, pack, maxiters, want_metro,
#                   num_trials, ls_factor, async_ls=False, done_frac=1.0);
#     async_ls is K4, done_frac < 1 is K8
bfgs_minimize = _KernelWrapper("bfgs_minimize", bfgs_minimize_plain,
                               _launch_bfgs, mode_flag="async_ls")
# K3: async_mc_window(terms, rigid, tors, scal, pack, ecur, mc_steps,
#                     tick_budget, maxiters, num_trials, ls_factor,
#                     uniforms=None, seed=0, generator=None, warm_ls=False,
#                     lane_offset=0, lane_total=None);
#     warm_ls is K6; lane_offset: the global index of lane 0 (the stream's
#     key), lane_total: the whole batch's lanes (the plain draw)
async_mc_window = _KernelWrapper("async_mc_window", _mc_plain, _launch_mc,
                                 mode_flag="warm_ls")
# K5: lockstep_mc_window(terms, rigid, tors, scal, pack, ecur, mc_steps,
#                        maxiters, num_trials, ls_factor, async_ls=False,
#                        uniforms=None, seed=0, generator=None, done_frac=1.0,
#                        lane_offset=0, lane_total=None)
lockstep_mc_window = _KernelWrapper("lockstep_mc_window", _lockstep_mc_plain,
                                    _launch_lockstep_mc,
                                    mode_flag="async_ls")

KERNELS = (eval_fg, bfgs_minimize, async_mc_window, lockstep_mc_window)


class FusedBfgs:
    """Handle binding one scoring function and pack to the kernels, with
    the JAX handle's call shape: __call__ runs K2 (K4 under async_ls),
    run_mc runs K3 (K6 under warm_ls) or, with async_mc off, K5.  done_frac
    < 1 (K8) couples the BFGS loops of K2/K4 and K5 by groups of 128 lanes;
    the async window (K3/K6) does not read it, as in the JAX kernel."""

    def __init__(self, sf: ScoringFunction, pack: DockPack, maxiters: int,
                 want_metro: bool = True, mc_steps: int = 0,
                 num_trials: int = NUM_TRIALS, ls_factor: float = 2.0,
                 tick_budget: int = 16, async_ls: bool = False,
                 async_mc: bool = True, warm_ls: bool = False,
                 done_frac: float = 1.0, lane_offset: int = 0,
                 lane_total: Optional[int] = None):
        terms = extract_vina_terms(sf)
        if terms is None:
            raise ValueError("scoring function outside the fused family")
        self.terms = terms
        self.pack = pack
        self.n, self.m = pack.dims[0], pack.dims[1]
        self.maxiters = int(maxiters)
        self.want_metro = bool(want_metro)
        self.mc_steps = int(mc_steps)
        self.num_trials = int(num_trials)
        self.ls_factor = float(ls_factor)
        self.tick_budget = int(tick_budget)
        self.async_ls = bool(async_ls)
        self.async_mc = bool(async_mc)
        self.warm_ls = bool(warm_ls)
        self.done_frac = float(done_frac)
        # the MC windows' place in a sharded batch (lane_offset: the global
        # index of this pack's lane 0; lane_total: the batch's lanes)
        self.lane_offset = int(lane_offset)
        self.lane_total = lane_total
        if not 0.0 < self.done_frac <= 1.0:
            raise ValueError(f"done_frac {done_frac} outside (0, 1]")

    def __call__(self, rigid, tors, scal):
        return bfgs_minimize(self.terms, rigid, tors, scal, self.pack,
                             self.maxiters, self.want_metro,
                             self.num_trials, self.ls_factor,
                             async_ls=self.async_ls,
                             done_frac=self.done_frac)

    def run_mc(self, rigid, tors, scal, seed, ecur, uniforms=None):
        """mc_steps MC steps per lane from (rigid, tors, ecur): returns
        (rigid', tors', stats, coords, step_rigid, step_tors, step_stat).
        The stream is completion-indexed with a completed flag in
        step_stat[..., 2] under async_mc, step-indexed with every row valid
        otherwise."""
        if not self.mc_steps:
            raise ValueError("built without mc_steps: use __call__")
        if self.async_mc:
            return async_mc_window(
                self.terms, rigid, tors, scal, self.pack, ecur,
                self.mc_steps, self.tick_budget, self.maxiters,
                self.num_trials, self.ls_factor, uniforms=uniforms,
                seed=seed, warm_ls=self.warm_ls,
                lane_offset=self.lane_offset, lane_total=self.lane_total)
        return lockstep_mc_window(
            self.terms, rigid, tors, scal, self.pack, ecur, self.mc_steps,
            self.maxiters, self.num_trials, self.ls_factor,
            async_ls=self.async_ls, uniforms=uniforms, seed=seed,
            done_frac=self.done_frac, lane_offset=self.lane_offset,
            lane_total=self.lane_total)
