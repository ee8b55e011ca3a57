"""The fused route's search settings and the default settings through the
port's engine on the CPU: each of fused_async_ls, fused_async_mc=False,
fused_warm_ls and fused_mc_in_kernel=False docks through the plain
versions; DockingEngine(DockSettings()) docks without a scorer as the JAX
engine does; without a scorer every CNN-in-the-loop mode docks on the
fused route without the CNN, as the JAX engine docks it; the handles get
the flags and window lengths the JAX engine gives them."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.constants import IS_HYDROGEN
from gnina_tpu_torch.docking import DockingEngine, DockSettings

SETTINGS = dict(cnn_scoring="none", num_mc_steps=32, exhaustiveness=2,
                num_mc_saved=9)
BOX = 12.0


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
    path = os.path.join(str(tmp_path_factory.mktemp("modes")), "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed=5,
                                     cube=18.0))
    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    out = dict(lig=lig, rec=tingest.Receptor.from_file(path),
               center=np.asarray(center, np.float32),
               size=np.full(3, BOX, np.float32))
    # the dock under cnn_scoring='none', which the CNN-in-the-loop modes
    # without a scorer must equal
    out["off"] = DockingEngine(DockSettings(**SETTINGS),
                               device="cpu").dock_batch(
        out["rec"], [lig], out["center"], out["size"], seed=0)[0]
    return out


@pytest.mark.parametrize("mode", ["refinement", "metrorescore",
                                  "metrorefine", "all"])
def test_cnn_in_the_loop_modes_without_a_scorer_dock_on_the_fused_route(
        system, mode):
    """With cnn_scorer=None the JAX engine docks every CNN-in-the-loop mode
    as if the CNN were off (has_cnn false, docking.py:976-979; its fused
    route refuses only a job with a scorer, :915): the port takes the
    fused route and docks, CNN fields 0.0, sorted by energy (sort `auto`),
    the same poses as under cnn_scoring='none'."""
    eng = DockingEngine(DockSettings(**dict(SETTINGS, cnn_scoring=mode)),
                        device="cpu")
    assert eng._fused_route([system["lig"]])
    eng._dock_general = None          # the general path is not taken
    res = eng.dock_batch(system["rec"], [system["lig"]], system["center"],
                         system["size"], seed=0)[0]
    assert 1 <= len(res) <= 9
    e = [p.energy for p in res]
    assert e == sorted(e) and np.isfinite(e).all()
    assert all(p.cnnscore == p.cnnaffinity == 0.0 for p in res)
    assert [p.energy for p in system["off"]] == e


def test_default_settings_dock_without_a_scorer(system):
    """DockingEngine(DockSettings()) takes the JAX engine's constructor
    arguments and, with cnn_scorer=None, docks under the default settings
    (cnn_scoring='rescore') without a CNN: CNN fields 0.0, sort auto ->
    Energy.  The MC step count is the heuristic's; it is cut here through
    max_mc_steps only to keep the test short."""
    import inspect

    assert list(inspect.signature(DockingEngine.__init__).parameters) == [
        "self", "settings", "sf", "cnn_scorer", "device", "user_grid"]
    assert list(inspect.signature(JEngine.__init__).parameters) == [
        "self", "settings", "sf", "cnn_scorer", "user_grid"]
    eng = DockingEngine(DockSettings(), device="cpu")
    assert eng.cnn is None and eng.settings.cnn_scoring == "rescore"
    eng.settings = dataclasses.replace(eng.settings, max_mc_steps=16,
                                       exhaustiveness=1)
    res = eng.dock_batch(system["rec"], [system["lig"]], system["center"],
                         system["size"])[0]
    assert 1 <= len(res) <= 9
    e = [p.energy for p in res]
    assert e == sorted(e) and np.isfinite(e).all()
    assert all((p.cnnscore, p.cnnaffinity, p.cnnvariance) == (0.0, 0.0, 0.0)
               for p in res)


_MODES = {
    "async_ls": dict(fused_async_ls=True),
    "lockstep_mc": dict(fused_async_mc=False),
    "lockstep_mc_async_ls": dict(fused_async_mc=False, fused_async_ls=True),
    "warm_ls": dict(fused_warm_ls=True),
    "host_driven": dict(fused_mc_in_kernel=False),
    "host_driven_async_ls": dict(fused_mc_in_kernel=False,
                                 fused_async_ls=True, refine_stride=4),
}


@pytest.fixture(scope="module")
def mode_docks(system):
    """One short dock per search setting, and the default's."""
    base = dict(SETTINGS)
    out = {}
    for name, kw in dict(_MODES, default={}).items():
        eng = DockingEngine(DockSettings(**base, **kw), device="cpu")
        out[name] = eng.dock_batch(system["rec"], [system["lig"]],
                                   system["center"], system["size"],
                                   seed=3)[0]
    return out


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_search_settings_dock_on_the_cpu(system, mode_docks, mode):
    """Each setting of the fused route docks through the plain versions:
    finite, sorted, in-box poses of the right shape.  The async line
    search changes no trajectory (it is the same search per pose), so its
    poses are the default's; the other modes search differently."""
    res = mode_docks[mode]
    assert 1 <= len(res) <= 9
    e = [p.energy for p in res]
    assert e == sorted(e) and np.isfinite(e).all() and e[0] < 0.0
    lo = system["center"] - system["size"] / 2 - 1e-3
    hi = system["center"] + system["size"] / 2 + 1e-3
    heavy = ~IS_HYDROGEN[system["lig"].types]
    for p in res:
        assert p.coords.shape == (system["lig"].num_atoms, 3)
        assert ((p.coords[heavy] >= lo) & (p.coords[heavy] <= hi)).all()
    same_as = {"async_ls": "default", "lockstep_mc_async_ls": "lockstep_mc"}
    if mode in same_as:
        assert e == [p.energy for p in mode_docks[same_as[mode]]]
    elif mode != "host_driven_async_ls":
        assert e != [p.energy for p in mode_docks["default"]]


def test_lockstep_window_is_capped_at_16_steps(system, monkeypatch):
    """The routing follows the JAX engine: a lockstep window is 16 steps at
    most (the async window keeps fused_mc_steps), the host-driven chunk
    runs no window kernel, and the handles carry the line-search flags."""
    from gnina_tpu_torch.ops import fused_dock as fd

    seen = []
    orig = fd.FusedBfgs.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append((self.mc_steps, self.async_mc, self.async_ls,
                     self.warm_ls))

    monkeypatch.setattr(fd.FusedBfgs, "__init__", spy)
    base = dict(SETTINGS, num_mc_steps=16, exhaustiveness=1)

    def handles(**kw):
        seen.clear()
        DockingEngine(DockSettings(**base, **kw), device="cpu").dock_batch(
            system["rec"], [system["lig"]], system["center"], system["size"],
            seed=0)
        return list(seen)

    assert handles(fused_mc_steps=32)[2] == (16, True, False, False)
    lock = handles(fused_async_mc=False, fused_mc_steps=128,
                   fused_async_ls=True, fused_warm_ls=True)
    assert lock == [(0, True, True, False), (0, True, True, False),
                    (16, False, True, True)]
    assert len(handles(fused_mc_in_kernel=False)) == 2
