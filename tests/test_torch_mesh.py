"""Device meshes and sharded docking in the port (gnina_tpu_torch/parallel/
mesh.py, ops/fused_dock.build_pack(shards=), the MC windows' lane_offset,
DockingEngine.dock_batch(mesh=)) on the CPU.

A Mesh that names the CPU twice stands for two cards: each shard runs on
it from a thread of its own, as shards on distinct cards do.

- make_mesh refuses a dp x tp that does not cover the devices, and a
  machine without a card unless devices are named;
- build_pack(shards=2) lays the lanes out as the JAX package's does, array
  by array and lane by lane (its per-shard pad included: the inert lanes
  are zero in both);
- the plain MC windows (K3, K5) with lane_offset draw, for a shard, the
  columns of the unsharded window's draw: each half of a batch equals the
  whole's columns exactly;
- a sharded dock_batch equals the unsharded one at fused_done_frac = 1 on
  the fused route (in-kernel async windows, lockstep windows, host-driven
  steps) and on the general path: the same poses (coordinates within
  1e-5 A) and energies within 1e-5 kcal/mol, for a batch that does not
  divide into the shards (3 ligands over 2, padded with a copy of the
  last: the padded batch is what both runs dock).
"""

import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.ops import pallas_dock as jpd
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.ops import mc
from gnina_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, \
    shard_ligand_batch
from gnina_tpu_torch.scoring.builtin import get_scoring_function

CPU2 = Mesh.of(["cpu", "cpu"])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    lig = fx.ligand()
    path = str(tmp_path_factory.mktemp("mesh") / "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed=5,
                                     cube=18.0))
    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    tligs = list(tingest.iter_ligands(fx.LIGAND_SDF))[:3]
    jligs = list(jingest.iter_ligands(fx.LIGAND_SDF))[:3]
    return dict(path=path, rec=tingest.Receptor.from_file(path),
                jrec=jingest.Receptor.from_file(path), tligs=tligs,
                jligs=jligs, center=np.asarray(center, np.float32),
                size=np.full(3, 12.0, np.float32))


# ------------------------------------------------------------------ meshes --

def test_mesh_shape_and_errors(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert mesh.row(1) == [torch.device("cpu")] * 2
    assert make_mesh(2, devices=["cpu"] * 4).shape == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError, match=r"dp\*tp = 2\*2 != 3 devices"):
        make_mesh(devices=["cpu"] * 3, dp=2, tp=2)
    with pytest.raises(ValueError, match="dp\\*tp"):
        make_mesh(devices=["cpu"] * 3, tp=2)
    with pytest.raises(ValueError, match="5 devices asked for"):
        make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_and_replicate_place_per_device():
    x = torch.arange(12.0).reshape(6, 2)
    tree = {"a": x, "b": (x[:, 0], 3)}
    parts = shard_ligand_batch(Mesh.of(["cpu"] * 3), tree)
    assert len(parts) == 3
    assert torch.equal(torch.cat([p["a"] for p in parts]), x)
    assert torch.equal(parts[1]["b"][0], x[2:4, 0]) and parts[1]["b"][1] == 3
    with pytest.raises(ValueError, match="not a multiple"):
        shard_ligand_batch(Mesh.of(["cpu"] * 4), tree)
    reps = replicate(Mesh.of(["cpu"] * 2), tree)
    assert len(reps) == 2 and all(torch.equal(r["a"], x) for r in reps)


# -------------------------------------------------------- the lane layout --

def _port_lane_arrays(pack):
    """The port's pack in JAX's per-lane layout (..., L)."""
    lig = pack.lane_lig.long()
    n, m, ly = pack.lc.shape[1], pack.parent.shape[1], pack.num_layers
    lanes = len(lig)
    nodeoh = torch.zeros((m, n, lanes))
    parentoh = torch.zeros((m, m, lanes))
    laymask = torch.zeros((ly, m, lanes))
    for li in range(lanes):
        g = int(lig[li])
        for a in range(int(pack.nheavy[g])):
            nodeoh[int(pack.node[g, a]), a, li] = 1.0
        for mi in range(1, m):
            if int(pack.layer[g, mi]) > 0:
                parentoh[mi, int(pack.parent[g, mi]), li] = 1.0
                laymask[int(pack.layer[g, mi]) - 1, mi, li] = 1.0
    return {"lc": pack.lc[lig].permute(2, 1, 0),
            "ap": pack.ap[lig].permute(2, 1, 0),
            "nodeoh": nodeoh, "parentoh": parentoh,
            "relax": pack.relax[lig].permute(2, 1, 0),
            "relo": pack.relo[lig].permute(2, 1, 0), "laymask": laymask,
            "imask": pack.imask[lig].permute(1, 2, 0),
            "dofmask": pack.dofmask[lig].T}


@pytest.mark.parametrize("shards,ligs,e", [(2, 2, 4), (2, 3, 2), (1, 2, 4)],
                         ids=["2x(2x4)", "2x(3x2)", "1x(2x4)"])
def test_build_pack_shards_match_jax_layout(system, shards, ligs, e):
    """Array by array against the JAX package's build_pack(shards=): the
    port's lanes, one per JAX lane.  JAX pads every layout to its block of
    128 lanes; the port pads only a sharded one (shards=1 is compared over
    the real lanes)."""
    rec = system["rec"]
    kr = len(rec.types)
    tp = fd.build_pack(system["tligs"][:ligs], rec.coords, rec.types,
                       np.ones(kr, np.float32), e,
                       get_scoring_function("vina").table, m_pad=8,
                       device="cpu", shards=shards)
    jp = jpd.build_pack(system["jligs"][:ligs], rec.coords, rec.types,
                        np.zeros(kr, np.float32), np.ones(kr, np.float32), e,
                        jget_sf("vina").table, m_pad=8, shards=shards)
    lanes = ligs * e
    if shards > 1:
        lps_pad = -(-(lanes // shards) // fd.GROUP) * fd.GROUP
        assert tp.lanes == shards * lps_pad == np.asarray(jp.lc).shape[2]
        assert tp.pad_lig == ligs
    else:
        assert tp.lanes == lanes and tp.pad_lig == -1
    got = _port_lane_arrays(tp)
    for name, want in got.items():
        ref = np.asarray(getattr(jp, name))[..., :tp.lanes]
        assert ref.shape == tuple(want.shape), name
        assert np.array_equal(want.numpy(), ref), name
    assert np.array_equal(tp.heavy_idx[:ligs], jp.heavy_idx)
    assert np.array_equal(tp.rec.numpy(), np.asarray(jp.rec))


def test_pack_shards_are_the_real_lanes(system):
    rec = system["rec"]
    kr = len(rec.types)
    args = (rec.coords, rec.types, np.ones(kr, np.float32), 2,
            get_scoring_function("vina").table)
    whole = fd.build_pack(system["tligs"][:2], *args, m_pad=8, device="cpu")
    sharded = fd.build_pack(system["tligs"][:2], *args, m_pad=8,
                            device="cpu", shards=2)
    assert torch.equal(sharded.real_lanes().lane_lig, whole.lane_lig)
    for i in range(2):
        part = sharded.shard(i, 2)
        alone = fd.build_pack(system["tligs"][i:i + 1], *args, m_pad=8,
                              device="cpu")
        assert part.lanes == 2 and part.pad_lig == -1
        for k in ("lc", "ap", "node", "parent", "layer", "relax", "relo",
                  "imask", "dofmask", "nheavy", "lane_lig"):
            a, b = getattr(part, k), getattr(alone, k)
            assert torch.equal(a[..., :b.shape[-1]] if k == "imask" else a,
                               b) or torch.equal(
                a[tuple(slice(0, d) for d in b.shape)], b), k


# -------------------------------------------- the windows' lane offsets --

@pytest.mark.parametrize("which", ["async", "lockstep"])
def test_offset_windows_draw_the_whole_batchs_columns(system, which):
    """Lanes 0-3 and 4-7 of an 8-lane window, each run alone with its
    lane_offset and the batch's lane count, equal the whole window's
    columns: the plain versions draw the batch's uniforms and take their
    lanes' columns (the kernels key their Philox stream on
    lane_offset + lane)."""
    rec = system["rec"]
    kr = len(rec.types)
    sf = get_scoring_function("vina")
    pack = fd.build_pack(system["tligs"][:2], rec.coords, rec.types,
                         np.ones(kr, np.float32), 4, sf.table, m_pad=8,
                         device="cpu")
    gen = torch.Generator().manual_seed(3)
    lo, hi = (system["center"] - 6.0), (system["center"] + 6.0)
    carry = mc.mc_init(8, 8, mc.MCParams(), lo, hi, pack.dims[0], gen,
                       lambda r, t: fd.fk_packed(r, t, pack), device="cpu")
    scal = fd.scal_vector(10.0, 1.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                          device="cpu")
    ecur = torch.full((8,), 1e3)
    terms = fd.extract_vina_terms(sf)

    def run(lanes, offset, total):
        sub = slice(lanes[0], lanes[1])
        pk = pack.with_lanes(pack.lane_lig[sub])
        args = (terms, carry.rigid[sub].contiguous(),
                carry.tors[sub].contiguous(), scal, pk, ecur[sub].contiguous())
        kw = dict(seed=11, lane_offset=offset, lane_total=total)
        if which == "async":
            return fd.async_mc_window(*args, 4, 4, 3, **kw)
        return fd.lockstep_mc_window(*args, 4, 3, **kw)

    whole = run((0, 8), 0, None)
    halves = [run((0, 4), 0, 8), run((4, 8), 4, 8)]
    for k, w in enumerate(whole):
        got = torch.cat([h[k] for h in halves])
        assert torch.equal(got, w), k
    # a first shard that does not name the batch's lanes draws other
    # numbers (the batch defaults to lane_offset + its own lanes)
    alone = run((0, 4), 0, None)
    assert not torch.equal(alone[4], whole[4][:4])
    with pytest.raises(ValueError, match="outside a batch"):
        run((4, 8), 6, 8)


# ------------------------------------------------------- sharded docking --

ROUTES = {
    "inkernel": dict(),
    "lockstep": dict(fused_async_mc=False),
    "host": dict(fused_mc_in_kernel=False, num_mc_steps=8),
    "general": dict(fused_search="off", num_mc_steps=8),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_dock_equals_unsharded(system, route):
    settings = dict(cnn_scoring="none", num_mc_steps=16, exhaustiveness=2,
                    num_mc_saved=4, num_modes=3)
    settings.update(ROUTES[route])
    eng = DockingEngine(DockSettings(**settings), device="cpu")
    ligs = system["tligs"]
    rest = (system["center"], system["size"])
    # the mesh pads the 3 ligands with a copy of the last: the unsharded
    # run of the padded batch draws the same numbers
    whole = eng.dock_batch(system["rec"], ligs + ligs[-1:], *rest,
                           seed=5)[:3]
    sharded = eng.dock_batch(system["rec"], ligs, *rest, seed=5, mesh=CPU2)
    assert len(whole) == len(sharded) == 3
    for a, b in zip(whole, sharded):
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            assert abs(ra.energy - rb.energy) <= 1e-5
            assert abs(ra.intramol - rb.intramol) <= 1e-5
            assert np.abs(ra.coords - rb.coords).max() <= 1e-5
            assert np.isfinite(rb.coords).all()
