"""The port's minimisation server and its client (gnina_tpu_torch/tools/
server.py, server_client.py) on the CPU.

The server runs in a thread on 127.0.0.1 at a free port, over a state on
the CPU (DockSettings(cnn_scoring="none", minimize_iters=2)); the client
reads /status, uploads the receptor and minimises a file of three ligands
in one request.  Each result equals the port's DockingEngine.minimize
called directly, and its minimizedAffinity is within 1e-4 kcal/mol of the
JAX engine's minimize on the same inputs (the system near the origin).
Two iterations a stage, not more: the accurate line search interpolates
its step from float32 energies, so the two packages' steps part in the
last digits and later iterations amplify it (at 5 iterations one of the
three ligands ends 8.4e-3 kcal/mol from JAX's, the others within 2e-5;
test_torch_minimize.py bounds the same drift at 3 iterations).
Also: a /minimize before any receptor gives 400, an unknown path 404, a
ligand file that cannot be read 500, and the status counts follow.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.tools import server as srv
from gnina_tpu_torch.tools import server_client as client
from test_torch_gninagrid import write_origin_system

SETTINGS = dict(cnn_scoring="none", minimize_iters=2)
NLIGS = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def start(state):
    """Serve `state` on 127.0.0.1 at a free port: (server, port)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv._make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One round trip: the status before, the receptor upload's answer,
    the results of one /minimize of three ligands, the status after."""
    d = tmp_path_factory.mktemp("server")
    lig, rec = write_origin_system(d, n_ligs=NLIGS)
    state = srv._State(DockSettings(**SETTINGS), device="cpu")
    httpd, port = start(state)
    try:
        before = client.status("127.0.0.1", port)
        results = client.submit("127.0.0.1", port, rec, lig)
        after = client.status("127.0.0.1", port)
        with open(rec) as f:
            upload = client._post(f"http://127.0.0.1:{port}", "/receptor",
                                  f.read(), "pdb")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return dict(lig=lig, rec=rec, state=state, before=before, after=after,
                results=results, upload=upload)


def test_status_and_counts(served):
    assert served["before"] == {"server": "gnina_tpu_torch 0.1.0",
                                "receptor_loaded": False,
                                "ligands_minimized": 0}
    assert served["after"]["receptor_loaded"] is True
    assert served["after"]["ligands_minimized"] == NLIGS
    assert served["upload"] == {
        "atoms": len(tingest.Receptor.from_file(served["rec"]).types)}
    assert served["state"].engine.device.type == "cpu"


def test_results_equal_the_engine(served):
    """Every result key of the JAX server, each value the engine's own
    minimize of that ligand."""
    results = served["results"]
    assert len(results) == NLIGS
    eng = DockingEngine(DockSettings(**SETTINGS), device="cpu")
    rec = tingest.Receptor.from_file(served["rec"])
    for r, lig in zip(results, tingest.iter_ligands(served["lig"])):
        assert list(r) == ["name", "minimizedAffinity", "intramol", "rmsd",
                           "cnnscore", "cnnaffinity"]
        want = eng.minimize(rec, lig)
        assert r["name"] == lig.name
        assert r["minimizedAffinity"] == pytest.approx(want.energy, abs=1e-6)
        assert r["intramol"] == pytest.approx(want.intramol, abs=1e-6)
        assert r["rmsd"] == pytest.approx(want.rmsd, abs=1e-6)
        assert r["cnnscore"] == want.cnnscore
        assert r["cnnaffinity"] == want.cnnaffinity
        assert np.isfinite(r["minimizedAffinity"]) and r["rmsd"] >= 0.0


def test_affinities_match_jax_engine(served):
    eng = JEngine(JSettings(**SETTINGS))
    rec = jingest.Receptor.from_file(served["rec"])
    want = [eng.minimize(rec, lig).energy
            for lig in jingest.iter_ligands(served["lig"])]
    got = [r["minimizedAffinity"] for r in served["results"]]
    assert np.allclose(got, want, rtol=0, atol=1e-4)


def _code(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())
    return 200, None


def test_error_codes(served):
    """400 before a receptor, 404 for an unknown path (GET and POST), 500
    (the message passed on) for a ligand file that cannot be read; none
    of them counts a ligand."""
    state = srv._State(DockSettings(**SETTINGS), device="cpu")
    httpd, port = start(state)
    base = f"http://127.0.0.1:{port}"
    try:
        with open(served["lig"]) as f:
            ligs = f.read()
        code, body = _code(lambda: client._post(base, "/minimize", ligs,
                                                "sdf"))
        assert (code, body) == (400, {"error": "no receptor loaded"})
        code, body = _code(lambda: urllib.request.urlopen(f"{base}/nope"))
        assert (code, body) == (404, {"error": "unknown endpoint"})
        code, body = _code(lambda: client._post(base, "/nope", "x", "sdf"))
        assert (code, body) == (404, {"error": "unknown endpoint"})
        with open(served["rec"]) as f:
            client._post(base, "/receptor", f.read(), "pdb")
        code, body = _code(lambda: client._post(base, "/minimize", "junk",
                                                "nosuchformat"))
        assert code == 500 and body["error"]
        st = client.status("127.0.0.1", port)
        assert st["receptor_loaded"] is True and st["ligands_minimized"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_client_main_writes_results(served, tmp_path, capsys):
    state = srv._State(DockSettings(**SETTINGS), device="cpu")
    httpd, port = start(state)
    out = tmp_path / "results.json"
    try:
        assert client.main(["--port", str(port), "-r", served["rec"], "-l",
                            served["lig"], "-o", str(out)]) == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == NLIGS and "minimizedAffinity=" in lines[0]
    assert json.loads(out.read_text()) == served["results"]


def test_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv._State(DockSettings(**SETTINGS))
