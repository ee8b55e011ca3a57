"""The general docking path's modules against the JAX package's: the other
built-in scoring functions and --custom_scoring files, the AD4 user grid
(--user_grid), the per-type search grids (ops/cache_grid.py) and the
legacy steepest descent (ops/ssd.py, --simple_ascent).

Both sides get the same inputs: the minout.sdf ligand and a synthetic
receptor of _fixtures.py, read by each package's own ingest (so padded
identically), maps, term files and charges written from a numpy seed.
Tolerances are stated at each comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu.ops import cache_grid as jcg
from gnina_tpu.ops import user_grid as jug
from gnina_tpu.ops.energy import make_energy_fn as jmake_energy_fn
from gnina_tpu.ops.ssd import SSDParams as JSSDParams
from gnina_tpu.ops.ssd import ssd as jssd
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.scoring.builtin import scoring_function_from_file as jsf_file
from gnina_tpu.types import Conf as JConf
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.ops import bfgs as tbfgs
from gnina_tpu_torch.ops import cache_grid as tcg
from gnina_tpu_torch.ops import user_grid as tug
from gnina_tpu_torch.ops.ssd import SSDParams, ssd
from gnina_tpu_torch.scoring.builtin import builtin_names, \
    get_scoring_function, scoring_function_from_file
from gnina_tpu_torch.types import Conf as TConf

NEW_BUILTINS = ("dkoes_scoring", "dkoes_scoring_old", "dkoes_fast",
                "ad4_scoring")
CUSTOM = """# a term file in the reference's custom_terms format
-0.035579 gauss(o=0,_w=0.5,_c=8)
0.840245 repulsion(o=0,_c=8)
0.0099 vdw(i=4,_j=8,_s=0,_^=100,_c=8)
0.1465 electrostatic(i=1,_^=100,_c=8)
-0.587439 non_dir_h_bond(g=-0.7,_b=0,_c=8)
1.923 num_tors_div
"""
BOX = 8.0


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
    d = tmp_path_factory.mktemp("general")
    tlig = fx.ligand()
    center = fx.ligand_center(tlig)
    path = d / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=3, cube=18.0))
    custom = d / "custom.score"
    custom.write_text(CUSTOM)
    return dict(dir=d, center=center, custom=str(custom),
                jlig=next(jingest.iter_ligands(fx.LIGAND_SDF)), tlig=tlig,
                jrec=jingest.Receptor.from_file(str(path)),
                trec=tingest.Receptor.from_file(str(path)))


def sfs(system, name):
    """(JAX, port) scoring functions: a builtin by name, or the term file."""
    if name == "custom":
        return jsf_file(system["custom"]), scoring_function_from_file(
            system["custom"])
    return jget_sf(name), get_scoring_function(name)


def prepared(system, sf=None, tsf=None, size=BOX):
    """Both engines' padded ligand, receptor and box for one search box."""
    size = np.full(3, size, np.float32)
    je = JEngine(JSettings(cnn_scoring="none"), sf=sf)
    te = DockingEngine(DockSettings(cnn_scoring="none"), sf=tsf,
                       device="cpu")
    jl, jr, jbox, jlay, _ = je._prepare(system["jrec"], system["jlig"],
                                        system["center"], size)
    tl, tr, tbox, tlay = te._prepare(system["trec"], system["tlig"],
                                     system["center"], size)
    assert jlay == tlay and jr.coords.shape == tr.coords.shape
    return je, te, (jl, jr, jbox), (tl, tr, tbox), tlay


def random_confs(rng, lanes, lo, hi, t):
    pos = rng.uniform(lo, hi, (lanes, 3))
    q = rng.normal(size=(lanes, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tors = rng.uniform(-np.pi, np.pi, (lanes, t))
    return [np.asarray(a, np.float32) for a in (pos, q, tors)]


def jconf(c):
    return JConf(*[jnp.asarray(a) for a in c])


def tconf(c):
    return TConf(*[torch.as_tensor(a) for a in c])


# ------------------------------------------------ scoring functions ----

def test_builtin_names_match_jax():
    from gnina_tpu.scoring.builtin import builtin_names as jnames

    assert builtin_names() == jnames()


@pytest.mark.parametrize("name", NEW_BUILTINS + ("custom",))
def test_scoring_function_terms_and_score_only_match_jax(system, name):
    """Same terms and weights as JAX's scoring function; term_values within
    rtol 1e-4 / atol 1e-3 (float32 sums of a few thousand pairs, numpy on
    the JAX side); score_only's affinity and intramolecular energy (the
    general path's exact split, not K1) within rtol 1e-4 / atol 1e-4."""
    jsf, tsf = sfs(system, name)
    assert tsf.pair_weights == jsf.pair_weights
    assert tsf.conf_weights == jsf.conf_weights
    assert [type(t).__name__ for t in tsf.pair_terms] == \
        [type(t).__name__ for t in jsf.pair_terms]
    je = JEngine(JSettings(cnn_scoring="none"), sf=jsf)
    te = DockingEngine(DockSettings(cnn_scoring="none"), sf=tsf,
                       device="cpu")
    np.testing.assert_allclose(
        te.term_values(system["trec"], system["tlig"]),
        je.term_values(system["jrec"], system["jlig"]), rtol=1e-4, atol=1e-3)
    jr = je.score_only(system["jrec"], system["jlig"])
    tr = te.score_only(system["trec"], system["tlig"])
    assert not te._fused_route([system["tlig"]])
    np.testing.assert_allclose(tr.energy, jr.energy, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr.intramol, jr.intramol, rtol=1e-4,
                               atol=1e-4)


def test_custom_file_rejects_a_malformed_line(tmp_path):
    p = tmp_path / "bad.score"
    p.write_text("# comment\n0.5\n")
    with pytest.raises(ValueError, match="malformed"):
        scoring_function_from_file(str(p))


# -------------------------------------------------------- user grid ----

def write_map(path, rng, center, n=(17, 15, 13), spacing=0.4):
    """An AD4 map of seeded values around `center`, x fastest."""
    vals = rng.normal(scale=0.5, size=n[0] * n[1] * n[2])
    with open(path, "w") as f:
        f.write("GRID_PARAMETER_FILE test.gpf\nGRID_DATA_FILE test.fld\n"
                "MACROMOLECULE rec.pdbqt\n")
        f.write(f"SPACING {spacing}\n")
        f.write(f"NELEMENTS {n[0] - 1} {n[1] - 1} {n[2] - 1}\n")
        f.write(f"CENTER {center[0]:.3f} {center[1]:.3f} {center[2]:.3f}\n")
        f.write("\n".join(f"{v:.4f}" for v in vals) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def maps(system):
    rng = np.random.default_rng(11)
    path = write_map(system["dir"] / "bias.map", rng, system["center"])
    return dict(path=path, j=jug.read_ad4_map(path, scaling=0.7),
                t=tug.read_ad4_map(path, scaling=0.7, device="cpu"))


def test_read_ad4_map_matches_jax(maps):
    """The grid, its origin, factor and dims exactly; the box centre and
    size the map implies exactly."""
    (jg, jc, js), (tg, tc, ts) = maps["j"], maps["t"]
    for f in jug.UserGrid._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    assert tg.data.shape == (17, 15, 13)


def test_user_grid_energy_and_gradient_match_jax(maps):
    """Per-atom values (interpolated, capped, slope penalty outside) within
    1e-5 and their coordinate gradient within 1e-4, at points inside,
    on the edge and outside the map."""
    jg, tg = maps["j"][0], maps["t"][0]
    rng = np.random.default_rng(12)
    lo = np.asarray(jg.init)
    hi = lo + np.asarray(jg.dims_minus_1) / np.asarray(jg.factor)
    pts = rng.uniform(lo - 2.0, hi + 2.0, (64, 3)).astype(np.float32)
    want = np.asarray(jug.user_grid_atom_energy(jg, jnp.asarray(pts), 3.0))
    jgrad = np.asarray(jax.grad(lambda c: jnp.sum(
        jug.user_grid_atom_energy(jg, c, 3.0)))(jnp.asarray(pts)))
    x = torch.as_tensor(pts).requires_grad_(True)
    got = tug.user_grid_atom_energy(tg, x, 3.0)
    (tgrad,) = torch.autograd.grad(got.sum(), x)
    outside = ((pts < lo) | (pts > hi)).any(1)
    assert 8 < outside.sum() < 56
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-4, atol=1e-4)


def test_user_values_on_lattice_match_jax(maps, system):
    """The user grid sampled at the search lattice (folded into every grid
    slot) within 1e-5."""
    jg, tg = maps["j"][0], maps["t"][0]
    lo = np.asarray(system["center"] - 4.0, np.float32)
    npts = (16, 16, 24)
    want = jug.user_values_on_lattice(jg, lo, jcg.GRANULARITY, npts)
    got = tug.user_values_on_lattice(tg, lo, tcg.GRANULARITY, npts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_energy_with_user_grid_matches_jax(system, maps):
    """make_energy_fn's user-grid hook (added per atom before curl): the
    energy and DOF gradient of random poses in the box within rtol 2e-4 /
    atol 2e-3 (the K1 bounds), and the hook's contribution differs from 0
    by more than the bound."""
    jsf, tsf = sfs(system, "vina")
    _, _, (jl, jr, jbox), (tl, tr, tbox), layers = prepared(system, jsf,
                                                             tsf)
    rng = np.random.default_rng(13)
    c = random_confs(rng, 8, np.asarray(jbox.lo), np.asarray(jbox.hi),
                     jl.num_torsion_slots)
    v = jnp.asarray([10.0, 10.0, 10.0], jnp.float32)
    jfn = jmake_energy_fn(jsf, layers, user_grid=maps["j"][0])
    je, jgr = jax.vmap(lambda cc: jfn.eval_deriv(jl, jr, cc, jbox, 1e3, v))(
        jconf(c))
    from gnina_tpu_torch.ops.energy import make_energy_fn

    tfn = make_energy_fn(tsf, layers, user_grid=maps["t"][0])
    te_, tgr = tfn.eval_deriv(tl, tr, tconf(c), tbox, 1e3, [10.0] * 3)
    np.testing.assert_allclose(te_.numpy(), np.asarray(je), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=1e-3,
                               atol=1e-3 * float(np.abs(jgr).max()))
    plain, _ = make_energy_fn(tsf, layers).eval_deriv(
        tl, tr, tconf(c), tbox, 1e3, [10.0] * 3)
    assert float((te_ - plain).abs().max()) > 1e-2


# ----------------------------------------------------- search grids ----

def populated(system, name, charges_seed=None):
    """JAX's and the port's grids for one scoring function on the same
    padded receptor (random receptor charges when charges_seed is set, so
    the charge grid is not zero)."""
    jsf, tsf = sfs(system, name)
    je, te, (jl, jr, jbox), (tl, tr, tbox), layers = prepared(system, jsf,
                                                              tsf)
    if charges_seed is not None:
        q = np.random.default_rng(charges_seed).normal(
            scale=0.3, size=jr.charges.shape).astype(np.float32)
        q = np.where(np.asarray(jr.mask), q, 0.0).astype(np.float32)
        jr = jr._replace(charges=jnp.asarray(q))
        tr = tr._replace(charges=torch.as_tensor(q))
    lo, hi = np.asarray(jbox.lo), np.asarray(jbox.hi)
    jgrids = je._populate_cache([system["jlig"]], jr, lo, hi)
    tgrids = te._populate_cache([system["tlig"]], tr, lo, hi)
    return dict(jsf=jsf, tsf=tsf, jl=jl, tl=tl, jr=jr, jbox=jbox, tbox=tbox,
                layers=layers, j=jgrids, t=tgrids)


@pytest.fixture(scope="module")
def grids_vina(system):
    return populated(system, "vina")


@pytest.fixture(scope="module")
def grids_ad4(system):
    return populated(system, "ad4_scoring", charges_seed=21)


def cutoff_step(g, ns, charge):
    """The most one receptor pair adds to a grid point just inside the
    cutoff (the JAX terms at r = cutoff - 1e-4 A, every gridded type
    against every receptor atom): what a grid point moves by when float32
    round-off of |p|^2 + |a|^2 - 2 p.a puts a pair at the cutoff on the
    other side of it."""
    from gnina_tpu.ops.energy import _type_param_arrays, gather_params

    sf, jr = g["jsf"], g["jr"]
    tables = _type_param_arrays(sf)
    slots = np.asarray(g["j"].slot_of_type)
    types = np.nonzero(np.asarray(g["j"].type_gridded))[0]
    assert len(types) == ns and sorted(slots[types]) == list(range(ns))
    pa = {k: v[:, None] for k, v in gather_params(
        tables, jnp.asarray(types)).items()}
    pb = {k: v[None, :] for k, v in gather_params(tables, jr.types).items()}
    r = jnp.full((len(types), jr.types.shape[0]), sf.cutoff - 1e-4)
    qb = jr.charges[None, :]
    e0 = sf.eval_pair(pa, pb, r, qa=jnp.zeros_like(r), qb=qb)
    if charge:
        e0 = sf.eval_pair(pa, pb, r, qa=jnp.ones_like(r), qb=qb) - e0
    return float(jnp.max(jnp.where(jr.mask[None, :], jnp.abs(e0), 0.0)))


def assert_grid_close(got, want, step):
    """Within float32 round-off of a sum over the receptor atoms (rtol
    1e-5, atol 1e-4 of the grid's scale) at all but a few points (at most
    1 in 2,000), each off by no more than two cutoff steps."""
    err = np.abs(got - want)
    loose = err > 1e-5 * np.abs(want) + 1e-4 * float(np.abs(want).max())
    assert loose.mean() <= 5e-4, (loose.sum(), err.max())
    assert float(err[loose].max(initial=0.0)) <= 2 * step + 1e-4, \
        (err.max(), step)


@pytest.mark.parametrize("which", ["vina", "ad4"])
def test_populate_matches_jax(which, grids_vina, grids_ad4):
    """The per-type grids of the gridded types equal JAX's within float32
    round-off (assert_grid_close: the same |p|^2 + |a|^2 - 2 p.a distances
    on both sides, summed in another order, so a pair at the cutoff can
    fall on the other side of it), and the charge grid likewise when the
    terms need one; slot maps, origin and dims exactly."""
    g = grids_vina if which == "vina" else grids_ad4
    j, t = g["j"], g["t"]
    ns = int(np.asarray(j.type_gridded).sum())
    assert ns >= 4
    for f in ("slot_of_type", "type_gridded", "origin", "dims_minus_1"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    # JAX pads each axis to a multiple of 8 points, never read
    nx, ny, nz = t.data.shape[1:]
    assert (nx, ny, nz) == tuple(int(v) + 1 for v in np.asarray(
        j.dims_minus_1)) and (nx, ny, nz) != j.data.shape[1:]
    assert_grid_close(t.data[:ns].numpy(),
                      np.asarray(j.data)[:ns, :nx, :ny, :nz],
                      cutoff_step(g, ns, False))
    assert (t.data[ns:] == 0).all()
    if which == "ad4":
        assert g["tsf"].has_charge_terms
        jc = np.asarray(j.chargedata)[:ns, :nx, :ny, :nz]
        assert float(np.abs(jc).max()) > 1e-2
        assert_grid_close(t.chargedata[:ns].numpy(), jc,
                          cutoff_step(g, ns, True))
    else:
        assert t.chargedata.shape == (16, 1, 1, 1)


@pytest.mark.parametrize("which", ["vina", "ad4"])
def test_cache_inter_energy_and_gradient_match_jax(which, grids_vina,
                                                   grids_ad4, system):
    """The trilinear energy of random poses (some atoms outside the box,
    which adds the slope penalty and clamps the interpolation) within
    rtol 1e-4 / atol 1e-3, and its coordinate gradient within 1e-3 of the
    gradient's scale: the clamp's zero and the penalty's +-slope
    included.  Both read the same cells, so the gap is the grids'."""
    g = grids_vina if which == "vina" else grids_ad4
    rng = np.random.default_rng(31)
    lo, hi = np.asarray(g["jbox"].lo), np.asarray(g["jbox"].hi)
    c = random_confs(rng, 8, lo - 1.0, hi + 1.0, g["jl"].num_torsion_slots)
    from gnina_tpu.ops import fk as jfk
    from gnina_tpu_torch.ops import fk as tfk

    jcoords = jax.vmap(lambda cc: jfk.fk_coords(g["jl"], cc, g["layers"]))(
        jconf(c))
    tcoords = tfk.fk_coords(g["tl"], tconf(c), g["layers"])
    np.testing.assert_allclose(tcoords.numpy(), np.asarray(jcoords),
                               atol=1e-5)
    jl, tl = g["jl"], g["tl"]

    def jf(x):
        return jnp.sum(jax.vmap(lambda xx: jcg.cache_inter_energy(
            g["j"], xx, jl.types, jl.charges, jl.heavy_mask, 1e3,
            jnp.float32(10.0)))(x))

    x = jnp.asarray(tcoords.numpy())
    want = np.asarray(jax.vmap(lambda xx: jcg.cache_inter_energy(
        g["j"], xx, jl.types, jl.charges, jl.heavy_mask, 1e3,
        jnp.float32(10.0)))(x))
    jgrad = np.asarray(jax.grad(jf)(x))
    tx = tcoords.clone().requires_grad_(True)
    got = tcg.cache_inter_energy(g["t"], tx, tl.types, tl.charges,
                                 tl.heavy_mask, 1e3, 10.0)
    (tgrad,) = torch.autograd.grad(got.sum(), tx)
    out = ((tcoords < torch.as_tensor(lo)) | (tcoords > torch.as_tensor(hi)))
    assert out.any(-1).any(-1).sum() >= 2
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-3 * float(np.abs(jgrad).max()))


def test_user_grid_folds_into_the_search_grids(system, maps):
    """With a user grid the engine adds its lattice values to every
    gridded slot (cache.cpp:177), as JAX's engine does: within the grids'
    bounds of test_populate_matches_jax."""
    jsf, tsf = sfs(system, "vina")
    _, _, (jl, jr, jbox), (tl, tr, tbox), _ = prepared(system, jsf, tsf)
    je = JEngine(JSettings(cnn_scoring="none"), sf=jsf,
                 user_grid=maps["j"][0])
    te = DockingEngine(DockSettings(cnn_scoring="none"), sf=tsf,
                       device="cpu", user_grid=maps["t"][0])
    lo, hi = np.asarray(jbox.lo), np.asarray(jbox.hi)
    j = je._populate_cache([system["jlig"]], jr, lo, hi)
    t = te._populate_cache([system["tlig"]], tr, lo, hi)
    ns = int(np.asarray(j.type_gridded).sum())
    step = cutoff_step(dict(jsf=jsf, jr=jr, j=j), ns, False)
    # the unpadded points, and the cells whose 8 corners lie among them
    nx, ny, nz = t.data.shape[1:]
    assert_grid_close(t.data[:ns].numpy(),
                      np.asarray(j.data)[:ns, :nx, :ny, :nz], step)
    assert_grid_close(
        t.cells.reshape(16, nx, ny, nz, 8)[:ns, :-1, :-1, :-1].numpy(),
        np.asarray(j.cells).reshape((16,) + j.data.shape[1:] + (8,))[
            :ns, :nx - 1, :ny - 1, :nz - 1], step)
    uv = tug.user_values_on_lattice(maps["t"][0], lo, tcg.GRANULARITY,
                                    t.data.shape[1:])
    assert float(uv.abs().max()) > 0.1


# -------------------------------------------------------------- ssd ----

def test_ssd_on_a_quadratic_matches_jax():
    """The steepest descent on |pos - c|^2 + |tors|^2 from seeded starts:
    the same accepted steps, so the minimum and energy within 1e-5."""
    rng = np.random.default_rng(41)
    lanes = 6
    center = np.asarray([1.0, -2.0, 0.5], np.float32)
    pos = rng.normal(size=(lanes, 3)).astype(np.float32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (lanes, 1))
    tors = rng.normal(scale=0.5, size=(lanes, 2)).astype(np.float32)

    def jf(c):
        d = c.position - jnp.asarray(center)
        return (jnp.sum(d * d) + jnp.sum(c.torsions ** 2),
                jnp.concatenate([2 * d, jnp.zeros(3), 2 * c.torsions]))

    def tf(c):
        d = c.position - torch.as_tensor(center)
        e = torch.sum(d * d, -1) + torch.sum(c.torsions ** 2, -1)
        return e, torch.cat([2 * d, torch.zeros(d.shape), 2 * c.torsions],
                            -1)

    for par, tpar in ((JSSDParams(evals=300), SSDParams(evals=300)),
                      (JSSDParams(evals=7), SSDParams(evals=7))):
        want = jax.vmap(lambda c: jssd(jf, c, par))(jconf((pos, q, tors)))
        got = ssd(tf, tconf((pos, q, tors)), tpar)
        np.testing.assert_allclose(got.f0.numpy(), np.asarray(want.f0),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.x.position.numpy(),
                                   np.asarray(want.x.position), atol=1e-5)
    # a frozen DOF mask never moves the pose
    mask = torch.zeros(8, dtype=torch.bool)
    frozen = ssd(tf, tconf((pos, q, tors)), SSDParams(), dof_mask=mask)
    assert torch.equal(frozen.x.position, torch.as_tensor(pos))


def test_ssd_on_the_ligand_energy_matches_jax(system):
    """--simple_ascent's minimiser (bfgs dispatches type "simple" to it) on
    the ligand's energy from jittered crystal poses, 20 trials.  Both
    minimisers descend JAX's exact energy (the port's through a wrapper
    of the jitted JAX function): the energy is discontinuous at the 8 A
    cutoff, and the two packages' distances differ in float32 round-off,
    so on their own energies a pose at the cutoff can take a step on one
    side and not the other.  The same trials are accepted, and XLA fuses
    JAX's whole loop (increments and energy) into one program, so each
    trial's values differ in float32 rounding, which the factor (up 1.6x
    each accepted trial) carries forward: energies within 5e-3 kcal/mol
    and positions within 1e-3 A (measured 2.5e-3 and 7.5e-5); on the
    port's own energy every pose descends."""
    jsf, tsf = sfs(system, "vina")
    _, _, (jl, jr, jbox), (tl, tr, tbox), layers = prepared(system, jsf,
                                                             tsf, size=12.0)
    rng = np.random.default_rng(42)
    lanes = 6
    pos = (system["jlig"].orig_coords[0][None]
           + 0.3 * rng.normal(size=(lanes, 3))).astype(np.float32)
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (lanes, 1))
    tors = (0.2 * rng.normal(size=(lanes, jl.num_torsion_slots))).astype(
        np.float32)
    v = jnp.asarray([10.0, 10.0, 10.0], jnp.float32)
    jfn = jmake_energy_fn(jsf, layers)
    jderiv = jax.jit(jax.vmap(
        lambda c: jfn.eval_deriv(jl, jr, c, jbox, 1e3, v)))
    want = jax.jit(jax.vmap(lambda c: jssd(
        lambda x: jfn.eval_deriv(jl, jr, x, jbox, 1e3, v), c,
        JSSDParams(evals=20))))(jconf((pos, q, tors)))

    def via_jax(c):
        e, g = jderiv(jconf([x.numpy() for x in c]))
        return torch.as_tensor(np.asarray(e)), torch.as_tensor(np.asarray(g))

    par = tbfgs.MinimizeParams(maxiters=20, type="simple")
    got = tbfgs.bfgs(via_jax, tconf((pos, q, tors)), par)
    np.testing.assert_allclose(got.f0.numpy(), np.asarray(want.f0),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(got.x.position.numpy(),
                               np.asarray(want.x.position), atol=1e-3)
    from gnina_tpu_torch.ops.energy import make_energy_fn

    tfn = make_energy_fn(tsf, layers)

    def own(c):
        return tfn.eval_deriv(tl, tr, c, tbox, 1e3, [10.0] * 3)

    start = own(tconf((pos, q, tors)))[0]
    assert (tbfgs.bfgs(own, tconf((pos, q, tors)), par).f0 <= start).all()
    assert (want.f0 < np.asarray(via_jax(tconf((pos, q, tors)))[0])).all()


def sequential_line_search(f_val, x, g, f0, p):
    """bfgs.h:73-91 as the reference writes it: trial k = 0..9 at alpha
    0.5^k, the first with sufficient decrease taken; if none, the last
    trial's point with alpha 0.5^10."""
    from gnina_tpu_torch.ops.fk import conf_increment

    pg = torch.sum(p * g, dim=-1)
    found = torch.zeros(f0.shape[0], dtype=torch.bool)
    alpha = torch.full_like(f0, 0.5 ** 10)
    x_new, f1 = x, f0
    for k in range(10):
        a = 0.5 ** k
        xk = conf_increment(x, p, a)
        fk = f_val(xk)
        ok = ~found & ((fk - f0) < 1e-4 * a * pg)
        take = ok | (~found if k == 9 else torch.zeros_like(found))
        x_new = tbfgs._where_conf(take, xk, x_new)
        f1 = torch.where(take, fk, f1)
        alpha = torch.where(ok, a, alpha)
        found = found | ok
    return tbfgs.LineSearchResult(alpha=alpha, x_new=x_new, f1=f1)


def test_batched_trials_give_the_sequential_search(system, monkeypatch):
    """The fast line search's ten Armijo trials in one batched call give
    the reference's sequential search exactly: the same BFGS result with
    sequential_line_search in its place, and with lazy trials (each
    evaluated only for the poses that still search, as the CNN
    refinement takes them)."""
    jsf, tsf = sfs(system, "vina")
    _, _, _, (tl, tr, tbox), layers = prepared(system, jsf, tsf, size=12.0)
    from gnina_tpu_torch.ops.energy import make_energy_fn

    tfn = make_energy_fn(tsf, layers)
    rng = np.random.default_rng(43)
    c = tconf(random_confs(rng, 6, tbox.lo.numpy(), tbox.hi.numpy(),
                           tl.num_torsion_slots))

    def f(x):
        return tfn.eval_deriv(tl, tr, x, tbox, 1e3, [10.0] * 3)

    def fv(x):
        return tfn.eval_energy(tl, tr, x, tbox, 1e3, [10.0] * 3)

    b = tbfgs.bfgs(f, c, tbfgs.MinimizeParams(maxiters=6), f_val=fv)
    lazy = tbfgs.bfgs(f, c, tbfgs.MinimizeParams(maxiters=6),
                      f_val=lambda x, rows=None: fv(x), lazy_trials=True)
    assert torch.equal(lazy.f0, b.f0)
    assert all(torch.equal(x, y) for x, y in zip(lazy.x, b.x))
    monkeypatch.setattr(tbfgs, "fast_line_search", sequential_line_search)
    a = tbfgs.bfgs(f, c, tbfgs.MinimizeParams(maxiters=6), f_val=fv)
    assert torch.equal(a.f0, b.f0)
    assert all(torch.equal(x, y) for x, y in zip(a.x, b.x))
    assert not torch.equal(a.x.position, c.position)


def test_ssd_params_match_jax():
    assert dataclasses.asdict(SSDParams()) == dataclasses.asdict(
        JSSDParams())
