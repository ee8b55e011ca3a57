"""Built-in scoring function registry (reference:
gninasrc/lib/builtinscoring.cpp:40-88) and --custom_scoring term files.
vina and vinardo run on the fused route; the other term sets take the
general docking path."""

from __future__ import annotations

from gnina_tpu_torch.constants import DEFAULT_TABLE, VINARDO_TABLE
from gnina_tpu_torch.scoring.weighted import ScoringFunction, build_scoring_function

_BUILTINS = {
    "vina": (DEFAULT_TABLE, [
        ("gauss(o=0,_w=0.5,_c=8)", -0.035579),
        ("gauss(o=3,_w=2,_c=8)", -0.005156),
        ("repulsion(o=0,_c=8)", 0.840245),
        ("hydrophobic(g=0.5,_b=1.5,_c=8)", -0.035069),
        ("non_dir_h_bond(g=-0.7,_b=0,_c=8)", -0.587439),
        ("num_tors_div", 5 * 0.05846 / 0.1 - 1),
    ]),
    "vinardo": (VINARDO_TABLE, [
        ("gauss(o=0,_w=0.8,_c=8)", -0.045),
        ("repulsion(o=0,_c=8)", 0.80),
        ("hydrophobic(g=0.0,_b=2.5,_c=8)", -0.035),
        ("non_dir_h_bond(g=-0.6,_b=0,_c=8)", -0.60),
        ("num_tors_div", 5 * 0.02 / 0.1 - 1),
    ]),
    "dkoes_scoring": (DEFAULT_TABLE, [
        ("vdw(i=4,_j=8,_s=0,_^=100,_c=8)", 0.009900),
        ("non_dir_h_bond(g=-0.7,_b=0,_c=8)", -0.153055),
        ("ad4_solvation(d-sigma=3.6,_s/q=0.01097,_c=8)", 0.048934),
        ("num_tors_sqr", 0.317267),
        ("constant_term", -2.469020),
    ]),
    "dkoes_scoring_old": (DEFAULT_TABLE, [
        ("vdw(i=4,_j=8,_s=0,_^=100,_c=8)", 0.010607),
        ("non_dir_h_bond(g=-0.7,_b=0,_c=8)", 0.197201),
        ("num_tors_sqr", 0.285035),
        ("constant_term", -2.585651),
    ]),
    "dkoes_fast": (DEFAULT_TABLE, [
        ("vdw(i=4,_j=8,_s=0,_^=100,_c=8)", 0.008962),
        ("non_dir_h_bond(g=-0.7,_b=0,_c=8)", 0.387739),
        ("num_tors_sqr", 0.285035),
        ("constant_term", -2.467357),
    ]),
    "ad4_scoring": (DEFAULT_TABLE, [
        ("vdw(i=6,_j=12,_s=0,_^=100,_c=8)", 0.1560),
        ("non_dir_h_bond_lj(o=-0.7,_^=100,_c=8)", 0.0974),
        ("ad4_solvation(d-sigma=3.5,_s/q=0.01097,_c=8)", 0.1159),
        ("electrostatic(i=1,_^=100,_c=8)", 0.1465),
        ("num_tors_add", 0.2744),
    ]),
}
_BUILTINS["default"] = _BUILTINS["vina"]


def builtin_names():
    return sorted(_BUILTINS.keys())


def get_scoring_function(name: str = "vina") -> ScoringFunction:
    if name not in _BUILTINS:
        raise KeyError(f"unknown scoring function {name!r}; available: "
                       f"{builtin_names()}")
    table, descs = _BUILTINS[name]
    return build_scoring_function(name, descs, table)


def scoring_function_from_file(path: str,
                               name: str = "custom") -> ScoringFunction:
    """Parse a --custom_scoring term file: lines of '<weight> <description>'.

    Lines starting with '#' are comments (reference: custom_terms.cpp,
    examples/kitchensink.score)."""
    descs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"malformed custom scoring line: {line!r}")
            w, desc = parts
            descs.append((desc.strip(), float(w)))
    return build_scoring_function(name, descs, DEFAULT_TABLE)
