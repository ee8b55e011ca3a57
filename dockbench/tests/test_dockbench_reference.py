"""The reference (dockbench/reference) against the port's plain CPU path on
a few poses: the atom types of the traffic's ligands and receptor, the
rotatable bonds, the Vina affinity of --score_only, and the CNN ensemble's
scores.  The test imports both sides; the reference imports nothing of
the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import gen, lookup  # noqa: E402
from dockbench.reference import check, chem, cnn, vina  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from gnina_tpu_torch.chem import ingest

    t = lookup.traffic("screen_druglike")
    t.update(ligands_per_call=4, rounds_in_pool=1)
    d = tmp_path_factory.mktemp("ref")
    screen = gen.Screen(t, str(d))
    rec_path = d / "rec.pdb"
    rec_path.write_text(screen.receptor_pdb())
    ligs = []
    for k in range(2):
        _, call, _ = screen.call(9, k)
        # each ligand moved into the pocket, so that it has contacts
        call = [(l, x - x.mean(0) + screen.center) for l, x in call]
        p = d / f"call{k}.sdf"
        p.write_text(gen.sdf_text(call))
        ligs += list(zip(chem.parse_sdf(p.read_text()),
                         ingest.iter_ligands(str(p))))
    return screen, str(rec_path), ligs


def _written(port_lig, coords=None):
    from gnina_tpu_torch.chem.sdf import write_sdf_block

    return chem.parse_sdf(write_sdf_block(
        port_lig.mol, coords=port_lig.orig_coords if coords is None
        else coords, name=port_lig.name))[0]


def test_types_and_torsions_match_the_port(setup):
    from gnina_tpu_torch.chem import ingest

    screen, rec_path, ligs = setup
    for given, port in ligs:
        g = check.given(given)
        w = _written(port)
        match = chem.match_to_input(w, given)
        assert match is not None
        assert list(g.types[match]) == [int(x) for x in port.types]
        assert g.num_tors == port.num_tors == port.num_torsions
    rec = ingest.Receptor.from_file(rec_path)
    ref = check.Receptor(open(rec_path).read())
    assert np.array_equal(ref.types, rec.types)


def test_vina_affinity_matches_score_only(setup):
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.docking import DockingEngine, DockSettings

    screen, rec_path, ligs = setup
    rec = ingest.Receptor.from_file(rec_path)
    ref_rec = check.Receptor(open(rec_path).read())
    eng = DockingEngine(DockSettings(cnn_scoring="none"), device="cpu")
    for given, port in ligs:
        r = eng.score_only(rec, port)
        g = check.given(given)
        w = _written(port, r.coords)
        types = g.types[chem.match_to_input(w, given)]
        big = (np.zeros(3), np.full(3, 1e6))
        lo, hi = big[0] - big[1] / 2, big[0] + big[1] / 2
        got = vina.affinity(w.coords[None], types, g.num_tors, ref_rec.xyz,
                            ref_rec.types, lo, hi)[0]
        assert abs(got - r.energy) <= 1e-3 + 1e-4 * abs(r.energy), \
            (port.name, got, r.energy)


def test_cnn_scores_match_the_port(setup):
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.models.scorer import CNNScorer

    screen, rec_path, ligs = setup
    rec = ingest.Receptor.from_file(rec_path)
    ref_rec = check.Receptor(open(rec_path).read())
    names = ["dense_1_3", "dense_1_3_PT_KD_3", "crossdock_default2018_KD_4"]
    scorer = CNNScorer(model_names=names, device="cpu")
    models = cnn.load_models(names, os.path.join(ROOT, "gnina_tpu", "data",
                                                 "models"), "cpu")
    given, port = ligs[-1]
    poses = np.stack([port.orig_coords, port.orig_coords + [0.4, -0.2, 0.1]])
    s, a, _, _ = scorer.score_poses(rec, port, poses)
    w = _written(port)
    types = check.given(given).types[chem.match_to_input(w, given)]
    rs, ra = cnn.score(models, ref_rec.xyz, ref_rec.types,
                       np.stack([w.coords, w.coords + [0.4, -0.2, 0.1]]),
                       types, "cpu")
    np.testing.assert_allclose(rs, s, atol=1e-4)
    np.testing.assert_allclose(ra, a, atol=1e-3)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import dockbench.reference.check, dockbench.roofline, "
            "dockbench.gen; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('gnina_tpu', 'gnina_tpu_torch', 'jax')))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
