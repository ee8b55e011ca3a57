"""The best Vina affinity found, negated (-kcal/mol, higher is better):
each ligand's lowest written minimizedAffinity, averaged over the ligands
of the window's first round of calls.  That round docks the same molecules
in every run, whatever the program's pace; the rounds that a faster
program adds dock other molecules and count in lig_per_s alone."""

import numpy as np


def read(ctx):
    best = [-v for c in ctx.calls if c["round"] == 0
            for v in c["best"].values()]
    return float(np.mean(best)) if best else None
