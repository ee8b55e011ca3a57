"""The traffic generator (dockbench/gen): each size class falls in one of
the screen's shape buckets, no heavy atoms three or more bonds apart come
closer than the traffic's minimum, a run docks no molecule twice and every
seed the same molecules, the same seed gives the same files, and the
port's ingest reads every record."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import gen, lookup  # noqa: E402
from dockbench.gen import library  # noqa: E402


def small_traffic():
    t = lookup.traffic("screen_druglike")
    t.update(ligands_per_call=4, rounds_in_pool=2)
    return t


@pytest.fixture(scope="module")
def screen(tmp_path_factory):
    return gen.Screen(small_traffic(), str(tmp_path_factory.mktemp("gen")))


def _port_ligands(text, tmp_path):
    from gnina_tpu_torch.chem import ingest

    p = tmp_path / "ligs.sdf"
    p.write_text(text)
    return list(ingest.iter_ligands(str(p)))


@pytest.mark.parametrize("k", [0, 1])
def test_each_class_fills_one_screen_bucket(screen, tmp_path, k):
    cls, ligs, _ = screen.call(2 ** 31 + 5, k)
    rng = screen.t["classes"][cls]
    port = _port_ligands(gen.sdf_text(ligs), tmp_path)
    assert len(port) == len(ligs)

    def up(x, m):
        return -(-x // m) * m

    keys = {(up(p.num_atoms, 8), up(p.num_nodes, 4)) for p in port}
    assert len(keys) == 1
    for p in port:
        assert rng["atoms"][0] <= p.num_atoms <= rng["atoms"][1]
        assert rng["torsions"][0] <= p.num_torsions <= rng["torsions"][1]


def test_no_molecule_twice_in_a_run_and_the_same_for_every_seed(screen):
    rounds = screen.t["rounds_in_pool"]
    n = len(screen.t["call_classes"]) * rounds
    def molecule(lig):
        return (tuple(lig.elems), tuple(lig.bonds),
                np.round(lig.coords, 3).tobytes())

    warm = {molecule(l) for c in screen.t["classes"]
            for l, _ in screen.warmup(c)}
    seen = []
    for k in range(n):
        cls, ligs, _ = screen.call(2 ** 31 + 5, k)
        _, other, _ = screen.call(17, k)
        assert [l.name for l, _ in ligs] == [l.name for l, _ in other]
        seen += [molecule(l) for l, _ in ligs]
    assert len(set(seen)) == len(seen) and not warm & set(seen)
    # past the pool's rounds the first round's molecules come again
    assert [l.name for l, _ in screen.call(3, n)[1]] == \
        [l.name for l, _ in screen.call(3, 0)[1]]


def test_no_close_nonbonded_heavy_pairs(screen):
    for pool in screen.pools.values():
        for lig in (lig for sl in pool for lig in sl):
            assert library.conformer_ok(lig, lig.coords,
                                        screen.t["min_nonbonded"],
                                        screen.t["max_span"])
    # the input pose of a call is a rigid motion of the pool's conformer
    _, ligs, _ = screen.call(11, 0)
    for lig, x in ligs:
        assert library.conformer_ok(lig, x, screen.t["min_nonbonded"],
                                    screen.t["max_span"])


def test_same_seed_same_files(tmp_path):
    a = gen.Screen(small_traffic(), str(tmp_path / "a"))
    b = gen.Screen(small_traffic(), str(tmp_path / "b"))
    assert a.receptor_pdb() == b.receptor_pdb()
    for k in range(2):
        ca, cb = a.call(2 ** 33 + 1, k), b.call(2 ** 33 + 1, k)
        assert gen.sdf_text(ca[1]) == gen.sdf_text(cb[1]) and ca[2] == cb[2]
        cc = a.call(2 ** 33 + 2, k)
        assert gen.sdf_text(cc[1]) != gen.sdf_text(ca[1])


def test_inputs_lie_outside_the_box(screen):
    center, size = screen.box()
    _, ligs, _ = screen.call(3, 1)
    for _lig, x in ligs:
        assert np.any(np.abs(x.mean(axis=0) - center) > size / 2)


def test_port_reads_every_record_and_the_receptor(screen, tmp_path):
    from gnina_tpu_torch.chem import ingest

    for k in range(2):
        _, ligs, _ = screen.call(7, k)
        assert [p.name for p in _port_ligands(gen.sdf_text(ligs), tmp_path)] \
            == [l.name for l, _ in ligs]
    p = tmp_path / "rec.pdb"
    p.write_text(screen.receptor_pdb())
    rec = ingest.Receptor.from_file(str(p))
    assert len(rec.types) == len(screen.receptor()[0])
    assert not rec.mol.bonds
