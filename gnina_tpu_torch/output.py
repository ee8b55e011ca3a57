"""Result rendering: poses -> SDF/PDBQT with gnina's SD tags.

Counterpart of gnina_tpu/output.py (the reference's result_info,
gninasrc/lib/result_info.cpp), host-side text formatting only: output
molecules carry minimizedAffinity / CNNscore / CNNaffinity / CNNvariance
(and RMSD for --local_only) data fields.
"""

from __future__ import annotations

from typing import List, Optional

from gnina_tpu_torch.chem.sdf import write_sdf_block
from gnina_tpu_torch.chem.tree_build import LigandStruct


def pose_properties(result, cnn_enabled: bool) -> dict:
    props = {"minimizedAffinity": f"{result.energy:.5f}"}
    if result.rmsd >= 0:
        props["RMSD"] = f"{result.rmsd:.5f}"
    if cnn_enabled:
        props["CNNscore"] = f"{result.cnnscore:.10f}"
        props["CNNaffinity"] = f"{result.cnnaffinity:.10f}"
        props["CNN_VS"] = f"{result.cnnscore * result.cnnaffinity:.10f}"
        props["CNNvariance"] = f"{result.cnnvariance:.10f}"
    return props


def write_poses_sdf(lig: LigandStruct, results: List, cnn_enabled: bool,
                    model_name: Optional[str] = None,
                    atom_terms: Optional[List[str]] = None) -> str:
    """atom_terms: per-pose --atom_term_data tables embedded as the
    `atomic_interaction_terms` SD field (result_info.cpp:150-155)."""
    out = []
    for pi, r in enumerate(results):
        props = pose_properties(r, cnn_enabled)
        if atom_terms is not None:
            props["atomic_interaction_terms"] = atom_terms[pi].rstrip("\n")
        out.append(write_sdf_block(lig.mol, coords=r.coords, properties=props,
                                   name=model_name if model_name is not None
                                   else lig.name))
    return "".join(out)


def write_poses_pdbqt(lig: LigandStruct, results: List,
                      cnn_enabled: bool) -> str:
    """Poses as multi-MODEL PDBQT (result_info.cpp:159-176: MODEL/REMARK
    minimizedAffinity [CNNscore/CNNaffinity]/ENDMDL around the ligand).

    The ROOT/BRANCH tree is reconstructed from the kinematic tree the
    docking actually used (node 0 = ROOT, every other node a BRANCH at its
    rotatable bond), so round-tripping the output re-parses to the same
    tree; serials follow emission order as AutoDockTools does, each
    branch's bond atom emitted first.
    """
    from gnina_tpu_torch.chem.pdbqt import _format_atom_line
    from gnina_tpu_torch.constants import DEFAULT_TABLE

    import numpy as np

    n_lig = lig.lig_atoms
    node_atoms = [[] for _ in range(lig.num_nodes)]
    for i in range(n_lig):
        node_atoms[int(lig.node_id[i])].append(i)
    children = [[] for _ in range(lig.num_nodes)]
    for m_ in range(1, lig.num_nodes):
        children[int(lig.parent[m_])].append(m_)

    # child-side bond atom of node m: the node atom bonded to the parent
    # anchor (falls back to the node's first atom)
    adj = {}
    if lig.mol is not None:
        for b in lig.mol.bonds:
            adj.setdefault(b.a, set()).add(b.b)
            adj.setdefault(b.b, set()).add(b.a)

    def bond_atom(m_):
        pa = int(lig.parent_anchor[m_])
        for i in node_atoms[m_]:
            if pa in adj.get(i, ()):
                return i
        return node_atoms[m_][0] if node_atoms[m_] else pa

    def ad_name_of(i):
        a = lig.mol.atoms[i] if lig.mol is not None else None
        if a is not None and getattr(a, "ad_name", ""):
            return a.ad_name
        return DEFAULT_TABLE.ad_names[int(lig.types[i])]

    out = []
    for mi, r in enumerate(results):
        out.append(f"MODEL {mi + 1}\n")
        out.append(f"REMARK minimizedAffinity {r.energy:g}\n")
        if r.rmsd >= 0:
            out.append(f"REMARK minimizedRMSD {r.rmsd:g}\n")
        if cnn_enabled:
            out.append(f"REMARK CNNscore {r.cnnscore:g}\n")
            out.append(f"REMARK CNNaffinity {r.cnnaffinity:g}\n")
        serial = {}
        next_serial = [1]

        def emit_atom(i):
            serial[i] = next_serial[0]
            a = (lig.mol.atoms[i] if lig.mol is not None
                 and i < len(lig.mol.atoms) else None)
            if a is None:
                from gnina_tpu_torch.chem.mol import Atom
                a = Atom()
            out.append(_format_atom_line(serial[i], a, r.coords[i],
                                         ad_name_of(i)) + "\n")
            next_serial[0] += 1

        def emit_node(m_):
            if m_ == 0:
                out.append("ROOT\n")
                for i in node_atoms[0]:
                    emit_atom(i)
                out.append("ENDROOT\n")
                for c in children[0]:
                    emit_node(c)
                return
            pa = int(lig.parent_anchor[m_])
            ca = bond_atom(m_)
            ps = serial.get(pa, 0)
            cs = next_serial[0]
            out.append(f"BRANCH {ps:3d} {cs:3d}\n")
            emit_atom(ca)
            for i in node_atoms[m_]:
                if i != ca:
                    emit_atom(i)
            for c in children[m_]:
                emit_node(c)
            out.append(f"ENDBRANCH {ps:3d} {serial[ca]:3d}\n")

        emit_node(0)
        out.append(f"TORSDOF {lig.torsdof}\n")
        out.append("ENDMDL\n")
    return "".join(out)


def write_flex_pdb(lig: LigandStruct, results: List, rigid=None) -> str:
    """Flexible-residue poses as multi-MODEL PDB (--out_flex; reference:
    result_info.cpp writeFlex).  Each pose writes every flex residue's
    movable atoms at their docked coordinates.

    rigid (--full_flex_output, main.cpp:963): the stripped rigid-receptor
    Molecule; its heavy atoms are written first in every MODEL so the
    output is the entire structure (model.cpp:909-935 write_context with
    a set_rigid receptor, hydrogens deleted per molgetter.cpp:167-170)."""
    if not lig.flex_meta:
        return ""
    out = []
    for mi, r in enumerate(results):
        out.append(f"MODEL     {mi + 1:4d}\n")
        serial = 1
        if rigid is not None:
            for a in rigid.atoms:
                if a.anum == 1:
                    continue
                x, y, z = (float(v) for v in a.coords)
                name = a.name or ""
                nm = name if len(name) >= 4 else f" {name:<3s}"
                out.append(
                    f"ATOM  {serial:5d} {nm:<4s}{(a.resname or 'UNK'):>4s} "
                    f"{str(a.chain or 'A')[:1]:1s}{int(a.resnum):4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {(a.element_name or ''):>2s}\n")
                serial += 1
        for meta in lig.flex_meta:
            key, resname, start, end = meta[0], meta[1], meta[2], meta[3]
            fr = meta[4] if len(meta) > 4 else None
            chain = key[0] if isinstance(key, tuple) else "A"
            resnum = key[1] if isinstance(key, tuple) else 1
            for k in range(start, end):
                name = ""
                element = ""
                if fr is not None and fr.atoms_mol is not None \
                        and k - start < len(fr.atoms_mol.atoms):
                    a = fr.atoms_mol.atoms[k - start]
                    name = a.name or ""
                    element = a.element_name or ""
                x, y, z = (float(v) for v in r.coords[k])
                nm = name if len(name) >= 4 else f" {name:<3s}"
                out.append(
                    f"ATOM  {serial:5d} {nm:<4s}{resname:>4s} "
                    f"{str(chain)[:1]:1s}{int(resnum):4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {element:>2s}\n")
                serial += 1
        out.append("ENDMDL\n")
    return "".join(out)
