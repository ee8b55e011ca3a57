"""Built-in scoring functions of the fused docking route (reference:
gninasrc/lib/builtinscoring.cpp:40-88): vina and vinardo."""

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
}
_BUILTINS["default"] = _BUILTINS["vina"]


def builtin_names():
    return sorted(_BUILTINS.keys())


def get_scoring_function(name: str = "vina") -> ScoringFunction:
    if name not in _BUILTINS:
        raise KeyError(f"unknown scoring function {name!r}; available: "
                       f"{builtin_names()} (other term sets take the general "
                       "path, still to port: see ROADMAP.md)")
    table, descs = _BUILTINS[name]
    return build_scoring_function(name, descs, table)
