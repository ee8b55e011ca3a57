"""Client for the gnina_tpu_torch minimization server (tools/server.py).

The reference ships a socket-protocol client for gninaserver
(gninasrc/gninaserver/client.py: startmin/getmols over raw TCP); this is
its equivalent for the HTTP/JSON redesign: upload a receptor once, then
stream ligand files for minimization and print/save the per-ligand
results.

Usage:
  python -m gnina_tpu_torch.tools.server_client --host H --port P \
      -r rec.pdb -l ligs.sdf [-o results.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def _post(base: str, path: str, body: str, fmt: str):
    req = urllib.request.Request(
        f"{base}{path}?format={fmt}", data=body.encode(),
        headers={"Content-Type": "text/plain"}, method="POST")
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read().decode())


def submit(host: str, port: int, receptor_path: str, ligand_path: str):
    """Upload receptor + minimize ligands; returns the result list."""
    base = f"http://{host}:{port}"
    rfmt = "pdbqt" if receptor_path.endswith(".pdbqt") else "pdb"
    with open(receptor_path) as f:
        _post(base, "/receptor", f.read(), rfmt)
    lfmt = ligand_path.rsplit(".", 1)[-1]
    with open(ligand_path) as f:
        return _post(base, "/minimize", f.read(), lfmt)


def status(host: str, port: int):
    with urllib.request.urlopen(f"http://{host}:{port}/status") as resp:
        return json.loads(resp.read().decode())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gnina_tpu_torch_server_client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=18888)
    p.add_argument("-r", "--receptor", required=True)
    p.add_argument("-l", "--ligands", required=True)
    p.add_argument("-o", "--out", help="write results JSON here")
    args = p.parse_args(argv)

    results = submit(args.host, args.port, args.receptor, args.ligands)
    for r in results:
        print(f"{r['name']}: minimizedAffinity={r['minimizedAffinity']:.4f} "
              f"rmsd={r['rmsd']:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
