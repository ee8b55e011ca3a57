"""The CUDA voxeliser (csrc/voxelize.cu, ops/voxelize.voxelize_cuda)
against the plain voxeliser of ops/voxelize.py, on a card.  Imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_voxelize_cuda.py -q

Without a card every test skips (marker `cuda`).  The plain voxeliser is
held against the JAX package in test_torch_cnn.py.

Tolerance: grid values are of order 1, and a float32 sum over a few dozen
atoms taken in another order than the plain matrix product's differs by a
few ulps, so max |kernel - plain| <= 1e-5 (a bfloat16 or TF32 path would
miss it by orders of magnitude).
"""

import types

import numpy as np
import pytest
import torch

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.models.scorer import MAX_POSE_BATCH, CNNScorer, \
    _lig_typing, _pose_from_outputs, _rec_typing
from gnina_tpu_torch.ops import voxelize as vox

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scorer(card):
    return CNNScorer(device=card)        # the default three-model ensemble


@pytest.fixture(scope="module")
def receptor():
    """The lattice pocket at protein density (40 A cube, cavity 9 A)."""
    return fx.receptor(fx.ligand_center(fx.ligand()), 0, cube=40.0,
                       cavity=9.0)


def _ligand(size_class: str):
    """(types, coords (N, 3)): the fixture ligand (19 atoms), or two copies
    of it side by side (38 atoms) for the larger class."""
    lig = fx.ligand()
    if size_class == "A":
        return lig.types, lig.orig_coords
    c = lig.orig_coords - lig.orig_coords.mean(0)
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    coords = np.concatenate([c - [2.5, 0, 0], c @ rot.T + [2.5, 0, 0]])
    return (np.concatenate([lig.types, lig.types]),
            coords + lig.orig_coords.mean(0))


def _chunk(scorer, rec, size_class: str, b: int, seed: int):
    """A rescore chunk of b poses of one ligand, turned and moved about the
    pocket, padded to prepare_multi's chunk: (prep, tensors on the card)."""
    t, x = _ligand(size_class)
    rng = np.random.default_rng(seed)
    mid = x.mean(0)
    poses = []
    for _ in range(b):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, v = q[0], q[1:]
        m = ((w * w - v @ v) * np.eye(3) + 2 * np.outer(v, v)
             + 2 * w * np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                                 [-v[1], v[0], 0]]))
        poses.append((x - mid) @ m.T + mid + rng.normal(scale=2.0, size=3))
    coords = np.stack(poses).astype(np.float32)
    prep = scorer.prepare_multi(rec, [(types.SimpleNamespace(types=t),
                                       coords)])
    dev = scorer.device
    a = [torch.as_tensor(v, device=dev) for v in prep["rec"]] + [
        torch.as_tensor(prep[k], device=dev)
        for k in ("coords", "types", "mask", "centers")]
    return prep, a


def _plain(m0, a, win):
    """The plain voxeliser's grids of a chunk (the receptor through the
    x-sorted window plus the ligand), as the rescore computes them on the
    CPU, here on the card."""
    rc, rt, rm, lc, lt, lm, centers = a
    kw = dict(num_channels=m0.num_channels, npoints=m0.grid_points,
              resolution=m0.resolution, radius_scale=m0.radius_scale)
    rch, rr = _rec_typing(m0, rt)
    lch, lr = _lig_typing(m0, lt)
    with torch.no_grad():
        return (vox.voxelize_windowed(rc, rch, rr, rm, centers, window=win,
                                      **kw)
                + vox.voxelize_batch(lc, lch, lr, lm, centers, **kw))


def _max_err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("size_class", ["A", "B"])
def test_kernel_matches_plain_at_the_rescore_shapes(scorer, receptor,
                                                    size_class):
    """A full chunk of 128 poses through voxelize_group (one launch, the
    kernel) against the plain voxeliser: within 1e-5, contiguous, in the
    (B, 28, 48, 48, 48) layout, with receptor and ligand density."""
    prep, a = _chunk(scorer, receptor, size_class, MAX_POSE_BATCH, 1)
    assert prep["bp"] == MAX_POSE_BATCH
    m0 = scorer.models[0]
    before = vox.voxelize_cuda.launches
    with torch.no_grad():
        got = scorer.voxelize_group(m0, *a, prep["win"])
    torch.cuda.synchronize()
    assert vox.voxelize_cuda.launches == before + 1
    assert tuple(got.shape) == (MAX_POSE_BATCH, 28, 48, 48, 48)
    assert got.is_contiguous()
    want = _plain(m0, a, prep["win"])
    assert float(want[:, :14].max()) > 0.5 and float(want[:, 14:].max()) > 0.5
    assert _max_err(got, want) <= TOL


def test_a_padded_chunk_and_two_launches(scorer, receptor):
    """100 poses padded to 128 by repeating the last: the padding's grids
    equal the last pose's bit for bit, the chunk matches the plain grids,
    and a second launch gives the same bits."""
    prep, a = _chunk(scorer, receptor, "B", 100, 2)
    assert prep["b"] == 100 and prep["bp"] == MAX_POSE_BATCH
    m0 = scorer.models[0]
    with torch.no_grad():
        g1 = scorer.voxelize_group(m0, *a, prep["win"])
        g2 = scorer.voxelize_group(m0, *a, prep["win"])
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    assert torch.equal(g1[100:], g1[99:100].expand(28, -1, -1, -1, -1))
    assert _max_err(g1, _plain(m0, a, prep["win"])) <= TOL


def test_the_ensemble_scores_from_kernel_grids(scorer, receptor):
    """Each model's pose score and affinity from the kernel's grids within
    1e-5 of those from the plain grids."""
    prep, a = _chunk(scorer, receptor, "A", MAX_POSE_BATCH, 3)
    m0 = scorer.models[0]
    with torch.no_grad():
        got = scorer.voxelize_group(m0, *a, prep["win"])
        want = _plain(m0, a, prep["win"])
        for m in scorer.models:
            s1, a1, _ = _pose_from_outputs(m, m.module(got))
            s0, a0, _ = _pose_from_outputs(m, m.module(want))
            assert _max_err(s1, s0) <= TOL, m.name
            assert _max_err(a1, a0) <= TOL, m.name


def test_the_receptor_alone(scorer, receptor):
    """receptor_grids on the card (no ligand atoms) against
    voxelize_windowed."""
    prep, a = _chunk(scorer, receptor, "A", 16, 4)
    m0 = scorer.models[0]
    rc, rt, rm, _lc, _lt, _lm, centers = a
    with torch.no_grad():
        got = scorer.receptor_grids(m0, rc, rt, rm, centers, prep["win"])
        rch, rr = _rec_typing(m0, rt)
        want = vox.voxelize_windowed(rc, rch, rr, rm, centers,
                                     window=prep["win"], num_channels=28)
    assert float(got[:, 14:].abs().max()) == 0.0
    assert _max_err(got, want) <= TOL


def _edge_system(card, center, seed: int):
    """A receptor sorted by x with masked rows last and channel -1 rows
    among the present ones, atoms outside the cube, one atom exactly 1.5 r
    (3 A at r = 2 A) from a grid point, and 4 ligand poses with masked and
    channel -1 atoms, about `center`."""
    rng = np.random.default_rng(seed)
    k = 900
    xyz = center + rng.uniform(-20.0, 20.0, (k, 3))
    xyz[:40] = center + rng.uniform(20.0, 30.0, (40, 3))   # outside the cube
    # grid point (10, 24, 24) of pose 0, as grid_points_1d rounds it
    point = (center.astype(np.float32) - np.float32(0.5 * 47 / 2)
             + np.float32([5.0, 12.0, 12.0]))
    xyz[40] = point + np.float32([3.0, 0.0, 0.0])
    chan = rng.integers(-1, 14, k)
    chan[40] = 3
    rad = rng.uniform(1.2, 2.2, k).astype(np.float32)
    rad[40] = 2.0
    mask = np.ones(k, bool)
    mask[-60:] = False
    xyz[-60:] = center                   # masked rows sit in the pocket
    order = np.argsort(np.where(mask, xyz[:, 0], 1e9), kind="stable")
    rec = [xyz[order].astype(np.float32), chan[order], rad[order], mask]
    b, n_lig = 4, 24
    lig = [center + rng.normal(scale=3.0, size=(b, n_lig, 3)),
           rng.integers(-1, 14, (b, n_lig)) + 14,
           rng.uniform(1.2, 2.2, (b, n_lig)).astype(np.float32),
           rng.uniform(size=(b, n_lig)) > 0.2]
    lig[1][lig[1] == 13] = -1
    centers = (center + np.array([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1],
                                  [-1.1, 0.7, 0.4], [2.0, 1.0, -1.5]])
               ).astype(np.float32)
    t = lambda v: torch.as_tensor(np.asarray(v), device=card)
    rec = [t(rec[0]), t(rec[1]).long(), t(rec[2]), t(rec[3])]
    lig = [t(lig[0].astype(np.float32)), t(lig[1]).long(), t(lig[2]),
           t(lig[3])]
    return rec, lig, t(centers)


@pytest.mark.parametrize("center", [(16.6, -8.5, 14.4), (40.0, -40.0, 40.0)])
def test_edge_cases(card, center):
    """Atoms at exactly 1.5 r, outside the cube, masked and channel -1,
    about a centre near the origin and one 40 A from it on each axis."""
    rec, lig, centers = _edge_system(card, np.array(center), 5)
    x = rec[0][:, 0].cpu().numpy()[rec[3].cpu().numpy()]
    win = vox.slab_window_size(x, 1.5 * 2.2 + 0.5)
    kw = dict(num_channels=28, npoints=48, resolution=0.5)
    with torch.no_grad():
        got = vox.voxelize_cuda(*rec, centers, ligand=lig, **kw)
        want = (vox.voxelize_windowed(*rec, centers, window=win, **kw)
                + vox.voxelize_batch(*lig, centers, **kw))
    assert float(want.max()) > 0.5
    assert _max_err(got, want) <= TOL


def test_more_atoms_than_one_pass_holds(card):
    """3,000 atoms in a 7 A cube: a tile gathers more than its 512 shared
    rows, and the further passes add to the stored grid.  A channel sums
    some 200 atoms to values near 10, so the bar is 1e-5 of the largest."""
    rng = np.random.default_rng(6)
    k = 3000
    xyz = rng.uniform(-3.5, 3.5, (k, 3)).astype(np.float32)
    xyz = xyz[np.argsort(xyz[:, 0], kind="stable")]
    t = lambda v: torch.as_tensor(v, device=card)
    rec = [t(xyz), t(rng.integers(0, 14, k)).long(),
           t(rng.uniform(1.2, 2.2, k).astype(np.float32)),
           torch.ones(k, dtype=torch.bool, device=card)]
    centers = t(np.array([[0.0, 0.0, 0.0], [5.0, -5.0, 2.0]], np.float32))
    kw = dict(num_channels=28, npoints=48, resolution=0.5)
    with torch.no_grad():
        got = vox.voxelize_cuda(*rec, centers, **kw)
        want = vox.voxelize_windowed(*rec, centers, window=k, **kw)
    scale = float(want.abs().max())
    assert scale > 5.0
    assert _max_err(got, want) <= TOL * scale


def test_refuses_what_it_does_not_take(card):
    """A CPU tensor, a wrong type and too many channels raise."""
    rec, lig, centers = _edge_system(card, np.array([0.0, 0.0, 0.0]), 7)
    kw = dict(num_channels=28, npoints=48, resolution=0.5)
    with pytest.raises(ValueError):
        vox.voxelize_cuda(*rec, centers.cpu(), **kw)
    with pytest.raises(ValueError):
        vox.voxelize_cuda(rec[0], rec[1].float(), *rec[2:], centers, **kw)
    with pytest.raises(RuntimeError):
        vox.voxelize_cuda(*rec, centers, num_channels=65, npoints=8)
