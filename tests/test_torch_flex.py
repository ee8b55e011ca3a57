"""Flexible side chains in the port against the JAX package.

The inputs are the port's receptor with real residues
(_fixtures.flex_receptor_pdb_text: eight standard residues lining the
synthetic cavity, in a 24 A cube) and the minout.sdf ligand, read from the
same files by each package's own readers.  --flexdist 3.5 selects SER45,
CYS74, GLU37 and PHE68 (7 flex torsions); every structure, tree, pair list
and energy of the port is held to JAX's: host arrays exactly, FK within
1e-5 A, energies within 1e-4 relative, score_only and minimize within
1e-4 kcal/mol.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnina_tpu import docking as jdocking
from gnina_tpu.chem import flexinfo as jflex
from gnina_tpu.chem import ingest as jingest
from gnina_tpu.chem.tree_build import attach_flex as jattach
from gnina_tpu.ops import energy as jenergy
from gnina_tpu.ops import fk as jfk
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import Conf as JConf
from gnina_tpu.types import pad_ligand as jpad_ligand
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import docking as tdocking
from gnina_tpu_torch.chem import flexinfo as tflex
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem.tree_build import attach_flex as tattach
from gnina_tpu_torch.ops import energy as tenergy
from gnina_tpu_torch.ops import fk as tfk
from gnina_tpu_torch.scoring.builtin import get_scoring_function as tget_sf
from gnina_tpu_torch.types import Conf as TConf
from gnina_tpu_torch.types import initial_conf as tinitial_conf
from gnina_tpu_torch.types import pad_ligand as tpad_ligand
from gnina_tpu_torch.types import pad_receptor as tpad_receptor

CUBE = 24.0
N_PAD, M_PAD, P_PAD, K_PAD = 48, 12, 256, 2048


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
    tlig = fx.ligand()
    path = tmp_path_factory.mktemp("flex") / "rec.pdb"
    path.write_text(fx.flex_receptor_pdb_text(tlig, seed=1, cube=CUBE))
    jrec = jingest.Receptor.from_file(str(path))
    trec = tingest.Receptor.from_file(str(path))
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    keys = jflex.select_flex_residues(jrec, flexdist=3.5,
                                      flexdist_coords=jlig.orig_coords)
    jfr = [jflex.extract_flex_residue(jrec, k) for k in keys]
    tfr = [tflex.extract_flex_residue(trec, k) for k in keys]
    return dict(path=str(path), jrec=jrec, trec=trec, jlig=jlig, tlig=tlig,
                keys=keys, jfr=jfr, tfr=tfr,
                jrigid=jflex.strip_flex_from_receptor(jrec, jfr),
                trigid=tflex.strip_flex_from_receptor(trec, tfr),
                jc=jattach(jlig, jfr), tc=tattach(tlig, tfr))


def _arrays(obj):
    """Every numpy array and scalar field of a dataclass, by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name),
                          (np.ndarray, int, float, bool, str, tuple))}


def assert_same_fields(a, b):
    fa, fb = _arrays(a), _arrays(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


def test_both_packages_read_the_residues(system):
    """The fixture's ATOM records reach both readers: the same coordinates,
    types and residue keys, eight standard residues in chain A."""
    j, t = system["jrec"], system["trec"]
    np.testing.assert_array_equal(j.coords, t.coords)
    np.testing.assert_array_equal(j.types, t.types)
    res = {(a.resname, a.chain, a.resnum) for a in t.mol.atoms
           if a.resname != "UNK"}
    assert res == {(n, fx.FLEX_CHAIN, r) for n, r, _ in fx.FLEX_RESIDUES}
    assert [(a.chain, a.resnum, a.name) for a in j.mol.atoms] == \
        [(a.chain, a.resnum, a.name) for a in t.mol.atoms]


@pytest.mark.parametrize("how", ["distance", "spec", "flex_max",
                                 "flex_limit"])
def test_select_flex_residues(system, how):
    """Selection by distance (the fixture's four, closest first, ALA
    skipped), by spec (ALA and a hetero residue named too: both skipped),
    with flex_max (the closest two) and with flex_limit (raises)."""
    lig = system["jlig"].orig_coords
    kw = dict(distance=dict(flexdist=3.5, flexdist_coords=lig),
              spec=dict(flexres="A:11,A:74,A:89,Z:3"),
              flex_max=dict(flexdist=3.5, flexdist_coords=lig, flex_max=2),
              flex_limit=dict(flexdist=3.5, flexdist_coords=lig,
                              flex_limit=3))[how]
    if how == "flex_limit":
        for mod, rec in ((jflex, "jrec"), (tflex, "trec")):
            with pytest.raises(RuntimeError, match="flex_limit"):
                mod.select_flex_residues(system[rec], **kw)
        return
    jk = jflex.select_flex_residues(system["jrec"], **kw)
    tk = tflex.select_flex_residues(system["trec"], **kw)
    assert jk == tk
    want = dict(distance=list(fx.FLEXDIST_35),
                spec=[("A", 11, ""), ("A", 74, "")],
                flex_max=list(fx.FLEXDIST_35[:2]))[how]
    assert tk == want


def test_extract_and_attach(system):
    """extract_flex_residue's FlexResidues and attach_flex's complex:
    every array equal; the complex holds the ligand, 16 flex atoms and 8
    inflex anchors, and its FK at the null conf gives the input."""
    for j, t in zip(system["jfr"], system["tfr"]):
        assert_same_fields(j, t)
        assert [a.name for a in j.atoms_mol.atoms] == \
            [a.name for a in t.atoms_mol.atoms]
    jc, tc = system["jc"], system["tc"]
    assert_same_fields(jc, tc)
    np.testing.assert_array_equal(jc.other_pairs, tc.other_pairs)
    assert [m[:4] for m in jc.flex_meta] == [m[:4] for m in tc.flex_meta]
    assert tc.lig_atoms == 19 and tc.movable_atoms == 35
    assert tc.num_atoms == 43 and tc.num_torsions == 10
    td = tpad_ligand(tc, N_PAD, M_PAD, P_PAD, device="cpu")
    x = tfk.fk_coords(td, tinitial_conf(tc, M_PAD - 1, device="cpu"),
                      int(tc.layer.max())).numpy()
    np.testing.assert_allclose(x[:tc.num_atoms], tc.orig_coords, rtol=0,
                               atol=1e-4)


def test_strip_flex_from_receptor(system):
    j, t = system["jrigid"], system["trigid"]
    np.testing.assert_array_equal(j.coords, t.coords)
    np.testing.assert_array_equal(j.types, t.types)
    np.testing.assert_array_equal(j.charges, t.charges)
    # side chains and CA/C go, backbone N and O stay
    assert len(t.types) == len(system["trec"].types) - 24


def test_flex_from_pdbqt(system):
    """A flex PDBQT of the four residues (_fixtures.flex_pdbqt_text) parses
    to the same FlexResidues in both packages."""
    text = fx.flex_pdbqt_text(system["trec"], system["keys"])
    j, t = jflex.flex_from_pdbqt(text), tflex.flex_from_pdbqt(text)
    assert [f.key for f in t] == list(system["keys"])
    for a, b in zip(j, t):
        assert_same_fields(a, b)


def _padded(system):
    jd = jpad_ligand(system["jc"], N_PAD, M_PAD, P_PAD)
    td = tpad_ligand(system["tc"], N_PAD, M_PAD, P_PAD, device="cpu")
    return jd, td


def test_pad_ligand_other_pairs(system):
    jd, td = _padded(system)
    q = len(system["tc"].other_pairs)
    assert td.opair_a.shape[0] == -(-q // 32) * 32
    for name in ("opair_a", "opair_b", "opair_mask", "opair_ff"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, name)),
                                      getattr(td, name).numpy(), name)
    assert int(td.opair_ff.sum()) > 0          # flex-flex pairs exist
    wide = tpad_ligand(system["tc"], N_PAD, M_PAD, P_PAD, q_pad=1024,
                       device="cpu")
    assert wide.opair_a.shape[0] == 1024


def random_confs(n, center, t, seed):
    rng = np.random.default_rng(seed)
    pos = center + rng.uniform(-2.0, 2.0, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tors = rng.uniform(-np.pi, np.pi, (n, t))
    return [np.asarray(x, np.float32) for x in (pos, q, tors)]


def both_confs(arrs):
    import jax.numpy as jnp

    return (JConf(*[jnp.asarray(a) for a in arrs]),
            TConf(*[torch.as_tensor(a) for a in arrs]))


def test_fk_of_the_combined_tree(system):
    """FK of ligand + flex tree on random confs (torsions of the flex
    nodes too): every atom within 1e-5 A; the inflex anchors never move."""
    import jax

    jd, td = _padded(system)
    tc = system["tc"]
    layers = int(tc.layer.max())
    jc, tcf = both_confs(random_confs(6, fx.ligand_center(tc), M_PAD - 1,
                                      seed=3))
    jx = np.asarray(jax.vmap(lambda c: jfk.fk_coords(jd, c, layers))(jc))
    tx = tfk.fk_coords(td, tcf, layers).numpy()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    anchors = slice(tc.movable_atoms, tc.num_atoms)
    np.testing.assert_array_equal(tx[:, anchors],
                                  np.broadcast_to(tc.orig_coords[anchors],
                                                  tx[:, anchors].shape))


def _energy_setup(system, center):
    jsf, tsf = jget_sf("vina"), tget_sf("vina")
    pr = system["jrigid"].pruned(center, np.full(3, 8.0), margin=8.0)
    assert len(pr.types) <= K_PAD
    jrd = jpad_receptor(pr.coords, pr.types, pr.charges, K_PAD)
    trd = tpad_receptor(pr.coords, pr.types, pr.charges, K_PAD,
                        device="cpu")
    layers = int(system["tc"].layer.max())
    return (jenergy.make_energy_fn(jsf, layers), jrd,
            tenergy.make_energy_fn(tsf, layers), trd)


def close_rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("fn", ["eval_other", "total_energy", "eval_deriv",
                                "exact_split"])
def test_flex_energies(system, fn):
    """The other pairs at v[2], the total energy, its DOF gradient and the
    flex-aware exact split on random confs near the cavity (caps at the
    forcecap, a box penalty at slope 10): within 1e-4 relative of JAX's
    (atol 1e-4 of the largest value)."""
    import jax
    import jax.numpy as jnp

    from gnina_tpu.ops.energy import Box as JBox

    center = fx.ligand_center(system["tc"])
    jd, td = _padded(system)
    jefn, jrd, tefn, trd = _energy_setup(system, center)
    jc, tcf = both_confs(random_confs(8, center, M_PAD - 1, seed=5))
    lo, hi = (center - 8.0).astype(np.float32), (center + 8.0).astype(
        np.float32)
    jbox = JBox(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    tbox = tenergy.Box(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi))
    v = [1000.0, 1000.0, 1000.0]
    jv = jnp.asarray(v, jnp.float32)
    if fn == "eval_other":
        j = jax.vmap(lambda c: jefn.eval_other(jd, c, 1000.0))(jc)
        t = tefn.eval_other(td, tcf, 1000.0)
        assert float(np.abs(np.asarray(j)).max()) > 0
        close_rel(t.numpy(), j, 1e-4)
    elif fn == "total_energy":
        j = jax.vmap(lambda c: jefn.eval_energy(jd, jrd, c, jbox, 10.0,
                                                jv))(jc)
        t = tefn.eval_energy(td, trd, tcf, tbox, 10.0, v)
        close_rel(t.numpy(), j, 1e-4)
    elif fn == "eval_deriv":
        je, jg = jax.vmap(lambda c: jefn.eval_deriv(jd, jrd, c, jbox, 10.0,
                                                    jv))(jc)
        te, tg = tefn.eval_deriv(td, trd, tcf, tbox, 10.0, v)
        close_rel(te.numpy(), je, 1e-4)
        close_rel(tg.numpy(), jg, 1e-4)
    else:
        ja, ji = jax.vmap(lambda c: jdocking.exact_split(
            jefn, jd, jrd, c, jbox, 10.0, jv))(jc)
        with torch.no_grad():
            ta, ti = tdocking.exact_split(tefn, td, trd, tcf, tbox, 10.0, v)
        close_rel(ta.numpy(), ja, 1e-4)
        close_rel(ti.numpy(), ji, 1e-4)
        # a ligand-only complex splits into inter and intra alone
        plain = td._replace(opair_mask=torch.zeros_like(td.opair_mask),
                            heavy_mask=td.lig_heavy_mask)
        with torch.no_grad():
            pa, pi = tdocking.exact_split(tefn, plain, trd, tcf, tbox, 10.0,
                                          v)
            inter = tefn.eval_inter(plain, trd, tcf, tbox, 10.0, v[1])
            intra = tefn.eval_intra(plain, tcf, v[0])
        np.testing.assert_array_equal(pa.numpy(), inter.numpy())
        np.testing.assert_array_equal(pi.numpy(), intra.numpy())


@pytest.mark.parametrize("mode", ["score_only", "minimize"])
def test_score_only_and_minimize_of_a_flex_complex(system, mode):
    """DockingEngine.score_only and .minimize (5 BFGS iterations) of the
    flex complex against the stripped receptor: energy and intramolecular
    energy within 1e-4 kcal/mol of JAX's; minimize also the coordinates
    within 1e-4 A and the RMSD within 1e-4.  (Two float32 codes part
    further with every iteration: on this complex by 1e-4 kcal/mol after
    10 and 1e-3 after 20.)"""
    kw = dict(cnn_scoring="none", minimize_iters=5)
    je = jdocking.DockingEngine(jdocking.DockSettings(**kw))
    te = tdocking.DockingEngine(tdocking.DockSettings(**kw), device="cpu")
    j = getattr(je, mode)(system["jrigid"], system["jc"])
    t = getattr(te, mode)(system["trigid"], system["tc"])
    assert abs(t.energy - j.energy) <= 1e-4, (t.energy, j.energy)
    assert abs(t.intramol - j.intramol) <= 1e-4, (t.intramol, j.intramol)
    assert t.intramol != 0.0
    if mode == "minimize":
        np.testing.assert_allclose(t.coords, j.coords, rtol=0, atol=1e-4)
        assert abs(t.rmsd - j.rmsd) <= 1e-4
        assert t.energy < te.score_only(system["trigid"],
                                        system["tc"]).energy


def test_general_path_grids_take_flex_types_and_other_pairs(system):
    """The general path's search energy with flex residues (shown, not new
    code): _populate_cache gives every movable heavy type a slot, the flex
    atoms' too, and the grid energy of _energy_fns_for is the grids' inter
    energy of every movable heavy atom plus the intra pairs at v[0] plus
    the other pairs at v[2], on a 4 A box."""
    tc = system["tc"]
    eng = tdocking.DockingEngine(tdocking.DockSettings(cnn_scoring="none"),
                                 device="cpu")
    center = fx.ligand_center(tc)
    lo, hi = (center - 2.0).astype(np.float32), (center + 2.0).astype(
        np.float32)
    _, _, tefn, trd = _energy_setup(system, center)
    grids = eng._populate_cache([tc], trd, lo, hi)
    movable = {int(t) for t in tc.types[:tc.movable_atoms] if t > 1}
    flex_only = movable - {int(t) for t in tc.types[:tc.lig_atoms]}
    assert flex_only                       # the flex atoms bring new types
    gridded = set(np.nonzero(grids.type_gridded.numpy())[0].tolist())
    assert movable <= gridded
    td = tpad_ligand(tc, N_PAD, M_PAD, P_PAD, device="cpu")
    box = tenergy.Box(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi))
    fns = eng._energy_fns_for(tefn, td, trd, box, grids, tefn.max_layers)
    _jc, tcf = both_confs(random_confs(4, center, M_PAD - 1, seed=9))
    v = [1.0, 20.0, 3.0]
    with torch.no_grad():
        e = fns["eval_energy"](tcf, v)
        coords = tfk.fk_coords(td, tcf, tefn.max_layers)
        inter = tdocking.cg.cache_inter_energy(
            grids, coords, td.types, td.charges, td.heavy_mask, 1e3, v[1])
        intra = tefn.eval_intra(td, tcf, v[0])
        other = tefn.eval_other(td, tcf, v[2])
    assert float(other.abs().max()) > 0
    np.testing.assert_allclose(e.numpy(), (inter + intra + other).numpy(),
                               rtol=1e-6, atol=1e-4)
