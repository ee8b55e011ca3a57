"""Batch minimization server (gninaserver equivalent).

reference: gninasrc/gninaserver — a network service that minimizes ligand
batches against a preloaded receptor.  This implementation speaks
JSON-over-HTTP (stdlib http.server; the reference used a custom TCP
protocol via boost::asio):

  POST /receptor   body = receptor file text (?format=pdb|pdbqt)
  POST /minimize   body = ligand file text (?format=sdf|pdbqt)
                   -> JSON list of {name, affinity, rmsd, cnnscore, ...}
  GET  /status     -> JSON server info

Ligand batches are minimized together on the accelerator (the reference
queued them across a thread pool).

Counterpart of the JAX package's gnina_tpu/tools/server.py over the
port's DockingEngine.minimize (the general path's BFGS), on the torch
device that --device names (default: the card; --device cpu asks for the
CPU).  The endpoints, status fields, error codes and result keys are the
JAX server's.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from gnina_tpu_torch import __version__
from gnina_tpu_torch.chem import ingest
from gnina_tpu_torch.device import device_from_flag
from gnina_tpu_torch.docking import DockingEngine, DockSettings


class _State:
    def __init__(self, settings: DockSettings, device=None):
        self.engine = DockingEngine(settings, device=device_from_flag(device))
        self.receptor = None
        self.lock = threading.Lock()
        self.count = 0


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/status":
                self._json(200, {
                    "server": f"gnina_tpu_torch {__version__}",
                    "receptor_loaded": state.receptor is not None,
                    "ligands_minimized": state.count,
                })
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            parsed = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n).decode()
            q = parse_qs(parsed.query)
            fmt = q.get("format", ["sdf"])[0]
            try:
                if parsed.path == "/receptor":
                    suffix = ".pdbqt" if fmt == "pdbqt" else ".pdb"
                    with tempfile.NamedTemporaryFile(
                            "w", suffix=suffix, delete=False) as f:
                        f.write(body)
                        path = f.name
                    with state.lock:
                        state.receptor = ingest.Receptor.from_file(path)
                    self._json(200, {"atoms": len(state.receptor.types)})
                elif parsed.path == "/minimize":
                    if state.receptor is None:
                        self._json(400, {"error": "no receptor loaded"})
                        return
                    suffix = "." + fmt
                    with tempfile.NamedTemporaryFile(
                            "w", suffix=suffix, delete=False) as f:
                        f.write(body)
                        path = f.name
                    results = []
                    with state.lock:
                        for lig in ingest.iter_ligands(path):
                            r = state.engine.minimize(state.receptor, lig)
                            state.count += 1
                            results.append({
                                "name": lig.name,
                                "minimizedAffinity": r.energy,
                                "intramol": r.intramol,
                                "rmsd": r.rmsd,
                                "cnnscore": r.cnnscore,
                                "cnnaffinity": r.cnnaffinity,
                            })
                    self._json(200, results)
                else:
                    self._json(404, {"error": "unknown endpoint"})
            except Exception as e:  # per-request isolation, like the
                # reference's per-ligand error handling (main.cpp:406-409)
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *a):
            pass

    return Handler


def serve(port: int = 18888, settings: DockSettings = None, device=None):
    state = _State(settings or DockSettings(cnn_scoring="none"), device)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(state))
    print(f"gnina_tpu_torch server listening on :{port} "
          f"({state.engine.device})")
    httpd.serve_forever()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gnina_tpu_torch_server")
    p.add_argument("--port", type=int, default=18888)
    p.add_argument("--scoring", default="vina")
    p.add_argument("--cnn_scoring", default="none")
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default: the card; "
                        "'cpu' for the CPU)")
    args = p.parse_args(argv)
    serve(args.port, DockSettings(scoring=args.scoring,
                                  cnn_scoring=args.cnn_scoring), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
