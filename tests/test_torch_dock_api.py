"""The ported docking route's entry points on the CPU: dock_batch, dock and
score_only give poses that are the JAX package's exact rescore of their
confs, sorted and deduplicated, the same for the same seed; jobs outside
the fused route raise (test_torch_dock_modes.py docks under every search
setting of the route and under the default settings).

Energies are held to the JAX exact rescore within 1e-3 kcal/mol, plus
0.005 kcal/mol for each atom pair whose squared distance lies within 2e-3
A^2 of the 8 A cutoff: the energy steps there (a pair entering the cutoff
adds its gauss tail, at most ~0.0035 kcal/mol for these atom types), and
two float32 implementations that round r^2 differently legitimately fall on
either side of the step."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.constants import IS_HYDROGEN
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu.docking import exact_split as jexact_split
from gnina_tpu.ops import energy as jenergy
from gnina_tpu.ops import fk as jfk
from gnina_tpu.types import Conf as JConf
from gnina_tpu.types import pad_ligand as jpad_ligand
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.scoring.weighted import build_scoring_function

SETTINGS = dict(cnn_scoring="none", num_mc_steps=64, exhaustiveness=4,
                num_mc_saved=9)
BOX = 12.0
CUTOFF_SQR = 64.0
STEP_BAND = 2e-3      # A^2 around the cutoff
STEP_ALLOW = 0.005    # kcal/mol per pair in the band


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    lig = fx.ligand()
    path = os.path.join(str(tmp_path_factory.mktemp("api")), "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed=5,
                                     cube=18.0))
    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    return dict(path=path, lig=lig, rec=tingest.Receptor.from_file(path),
                center=np.asarray(center, np.float32),
                size=np.full(3, BOX, np.float32))


@pytest.fixture(scope="module")
def docked(system):
    eng = DockingEngine(DockSettings(**SETTINGS), device="cpu")
    lig, rec = system["lig"], system["rec"]
    run = lambda seed: eng.dock_batch(rec, [lig, lig], system["center"],
                                      system["size"], seed=seed)
    return {"a": run(7), "b": run(7), "c": run(8)}


@pytest.fixture(scope="module")
def jax_side(system):
    """The JAX receptor, ligand and a jitted exact rescore + FK."""
    rec = jingest.Receptor.from_file(system["path"])
    lig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    sf = JEngine(JSettings(**SETTINGS)).sf
    center, size = system["center"], system["size"]
    pruned = rec.pruned(center, size / 2, margin=sf.cutoff)
    lig_d = jpad_ligand(lig, 24, 4, 96)
    rec_d = jpad_receptor(pruned.coords, pruned.types, pruned.charges, 512)
    efn = jenergy.make_energy_fn(sf, 4)
    box = jenergy.Box(lo=jnp.asarray(center - size / 2),
                      hi=jnp.asarray(center + size / 2))
    cap = jnp.full((3,), 1000.0, jnp.float32)

    @jax.jit
    def score(pos, quat, tors):
        def one(p, q, t):
            c = JConf(p, q, t)
            inter, intra = jexact_split(efn, lig_d, rec_d, c, box, 1e3, cap)
            return inter, intra, jfk.fk_coords(lig_d, c, 4)
        return jax.vmap(one)(pos, quat, tors)

    ci = {"num_tors": np.float32(lig.num_tors),
          "num_heavy_atoms": np.float32(lig.num_heavy_atoms),
          "num_hydrophobic_atoms": np.float32(lig.num_hydrophobic_atoms),
          "ligand_lengths_sum": np.float32(lig.ligand_length),
          "num_ligands": np.float32(1.0)}
    return dict(rec=rec, lig=lig, sf=sf, pruned=pruned, score=score, ci=ci)


def _step_allowance(coords, lig, rec_coords, lo, hi):
    """STEP_ALLOW for every receptor and intra pair in the cutoff band."""
    heavy = ~IS_HYDROGEN[lig.types]
    c = np.asarray(coords, np.float64)[heavy]
    adj = np.clip(c, lo, hi)
    r2 = ((adj[:, None, :] - np.asarray(rec_coords, np.float64)[None])
          ** 2).sum(-1)
    n = int((np.abs(r2 - CUTOFF_SQR) < STEP_BAND).sum())
    full = np.asarray(coords, np.float64)
    for a, b in lig.pairs:
        if abs(((full[a] - full[b]) ** 2).sum() - CUTOFF_SQR) < STEP_BAND:
            n += 1
    return STEP_ALLOW * n


def test_poses_are_jax_exact_rescore(system, docked, jax_side):
    """Each pose's energy and intramolecular energy are the JAX exact
    rescore of its conf (model.cu exact split + conf-independent terms)
    within 1e-3 kcal/mol (+ the cutoff-step allowance), and its
    coordinates the JAX FK of its conf within 1e-4 A."""
    lo = system["center"] - system["size"] / 2
    hi = system["center"] + system["size"] / 2
    n = 0
    for key in ("a", "c"):
        for poses in docked[key]:
            assert poses
            k = len(poses)
            pad = 9 - k        # one compiled shape: num_modes poses

            def stack(f):
                return np.stack([getattr(p, f) for p in poses]
                                + [getattr(poses[0], f)] * pad)

            inter, intra, coords = jax_side["score"](
                stack("conf_position"), stack("conf_orientation"),
                stack("conf_torsions"))
            e = np.asarray(jax_side["sf"].conf_independent(
                jax_side["ci"], np.asarray(inter, np.float32)))[:k]
            intra = np.asarray(intra)[:k]
            coords = np.asarray(coords)[:k, :poses[0].coords.shape[0]]
            for i, p in enumerate(poses):
                tol = 1e-3 + _step_allowance(p.coords, jax_side["lig"],
                                             jax_side["pruned"].coords,
                                             lo, hi)
                assert abs(p.energy - e[i]) <= tol, (key, i, p.energy, e[i])
                assert abs(p.intramol - intra[i]) <= tol, (key, i)
                np.testing.assert_allclose(p.coords, coords[i], atol=1e-4)
                n += 1
    assert n >= 4 * 3


def test_poses_sorted_deduplicated_and_in_box(system, docked):
    heavy = ~IS_HYDROGEN[system["lig"].types]
    lo = system["center"] - system["size"] / 2 - 1e-3
    hi = system["center"] + system["size"] / 2 + 1e-3
    for key in ("a", "c"):
        assert len(docked[key]) == 2
        for poses in docked[key]:
            e = [p.energy for p in poses]
            assert e == sorted(e)
            assert 1 <= len(poses) <= 9
            for i in range(len(poses)):
                c = poses[i].coords[heavy]
                assert np.isfinite(c).all()
                assert ((c >= lo) & (c <= hi)).all()
                for j in range(i):
                    d2 = ((c - poses[j].coords[heavy]) ** 2).sum(1).mean()
                    assert np.sqrt(d2) > 1.0, (key, i, j)


def test_same_seed_same_poses(docked):
    for pa, pb in zip(docked["a"], docked["b"]):
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            assert x.energy == y.energy
            np.testing.assert_array_equal(x.coords, y.coords)
    assert [p.energy for p in docked["a"][0]] != \
        [p.energy for p in docked["c"][0]]


def test_dock_is_a_batch_of_one(system):
    eng = DockingEngine(DockSettings(cnn_scoring="none", num_mc_steps=32,
                                     exhaustiveness=2, num_mc_saved=9),
                        device="cpu")
    one = eng.dock(system["rec"], system["lig"], system["center"],
                   system["size"], seed=3)
    batch = eng.dock_batch(system["rec"], [system["lig"]], system["center"],
                           system["size"], seed=3)
    assert [p.energy for p in one] == [p.energy for p in batch[0]]
    assert one and one[0].coords.shape == (system["lig"].num_atoms, 3)


def test_score_only_matches_jax(system, jax_side):
    """score_only (through K1's plain version) against the JAX engine's
    score_only on the same receptor: energy and intramolecular energy
    within 1e-3 kcal/mol (+ the cutoff-step allowance)."""
    eng = DockingEngine(DockSettings(**SETTINGS), device="cpu")
    got = eng.score_only(system["rec"], system["lig"])
    want = JEngine(JSettings(**SETTINGS)).score_only(jax_side["rec"],
                                                     jax_side["lig"])
    rec = system["rec"]
    tol = 1e-3 + _step_allowance(got.coords, jax_side["lig"], rec.coords,
                                 np.full(3, -1e8), np.full(3, 1e8))
    assert abs(got.energy - want.energy) <= tol
    assert abs(got.intramol - want.intramol) <= tol
    np.testing.assert_allclose(got.coords, want.coords, atol=1e-4)


def _vdw_sf():
    return build_scoring_function("custom", [
        ("gauss(o=0,_w=0.5,_c=8)", -0.035579),
        ("vdw(i=4,_j=8,_s=0,_^=100,_c=8)", 0.01)])


# settings that later porting has brought onto the fused route: they
# dock instead of raising
_PORTED = {"cnn_rescore": dict(cnn_scoring="rescore"),
           "cnn_sort_score": dict(sort_order="CNNscore"),
           "cnn_sort_affinity": dict(sort_order="CNNaffinity"),
           "lockstep_mc": dict(fused_async_mc=False),
           "async_ls": dict(fused_async_ls=True),
           "warm_ls": dict(fused_warm_ls=True),
           "done_frac": dict(fused_done_frac=0.9),
           # the general path: fused_search="off" and non-vina terms
           "fused_search_off": dict(fused_search="off"),
           "non_vina_terms": {},
           # flex atoms take the general path; a ligand without rigid DOF
           # (a covalent complex's tree) docks by its torsions
           "flex": {}, "covalent": {},
           # a CNN-in-the-loop mode without a scorer docks without the CNN
           # on the fused route, as in the JAX engine
           "cnn_in_loop": dict(cnn_scoring="all")}


@pytest.mark.parametrize("case", [
    "fused_search_off", "cnn_rescore", "cnn_sort_score", "cnn_sort_affinity",
    "cnn_in_loop", "canonical_shapes", "non_vina_terms", "flex",
    "covalent", "lockstep_mc", "async_ls", "warm_ls", "done_frac"])
def test_jobs_outside_the_fused_route_raise(system, case):
    """Each job the fused route does not take raises, from dock_batch and
    from score_only, instead of running with made-up CNN fields or
    another route's settings.  The cases since ported (the CNN rescore and
    sort orders, which without a scorer mean no CNN as in the JAX engine;
    lockstep MC; the async and warm line searches; the done_frac group
    stop; fused_search="off" and non-vina terms, on the general path; flex
    atoms, on the general path, and a ligand without rigid DOF; a
    CNN-in-the-loop mode, which without a scorer means no CNN) no longer
    raise: they dock and score."""
    settings = dict(SETTINGS)
    sf = None
    lig = system["lig"]
    match = "ROADMAP.md"
    if case == "flex":
        lig = dataclasses.replace(lig, num_lig_atoms=lig.num_atoms - 2)
    elif case == "covalent":
        lig = dataclasses.replace(lig, has_rigid_dof=False)
    if case in _PORTED:
        settings.update(num_mc_steps=16, exhaustiveness=1, **_PORTED[case])
        sf = _vdw_sf() if case == "non_vina_terms" else None
        eng = DockingEngine(DockSettings(**settings), sf=sf, device="cpu")
        assert eng._fused_route([lig]) == (case not in (
            "fused_search_off", "non_vina_terms", "flex"))
        res = eng.dock_batch(system["rec"], [lig], system["center"],
                             system["size"], seed=0)[0]
        assert res and all(p.cnnscore == 0.0 for p in res)
        if case.startswith("cnn_sort"):
            # stable sort on the stored 0.0 scores: the container's order
            assert len({p.energy for p in res}) == len(res)
        else:
            e = [p.energy for p in res]
            assert e == sorted(e)
        assert np.isfinite(eng.score_only(system["rec"], lig).energy)
        return
    if case == "canonical_shapes":
        settings["canonical_shapes"] = True
        match = "canonical_shapes"
    eng = DockingEngine(DockSettings(**settings), sf=sf, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        eng.dock_batch(system["rec"], [lig], system["center"],
                       system["size"], seed=0)
    with pytest.raises(NotImplementedError, match=match):
        eng.score_only(system["rec"], lig)


def test_settings_defaults_match_jax():
    """Every DockSettings field of the JAX package exists here with the
    same default."""
    jf = {f.name: f.default for f in dataclasses.fields(JSettings)}
    tf = {f.name: f.default for f in dataclasses.fields(DockSettings)}
    assert jf == tf


def test_cuda_wrappers_refuse_other_devices():
    """A wrapper given a tensor on neither the CPU nor a card raises
    instead of running anything."""
    from gnina_tpu_torch.ops import fused_dock as fd

    t = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fd.eval_fg(None, t, t, t, None)
