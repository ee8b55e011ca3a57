"""Weighted scoring function: a set of pairwise terms + conf-independent terms.

Replacement for the reference's terms/weighted_terms/precalculate stack
(reference: gninasrc/lib/weighted_terms.h, precalculate.h): the terms are
evaluated analytically instead of from binned r^2 lookup tables.  This
matches the reference's `precalculate_exact` semantics (used there for all
final scoring), so final affinities agree without table-discretization
error.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from gnina_tpu_torch.constants import DEFAULT_TABLE, AtomTypeTable
from gnina_tpu_torch.scoring import terms as T


@dataclasses.dataclass(frozen=True)
class ScoringFunction:
    """Pairwise terms, conf-independent terms, and their weights.

    Pairwise evaluation order and the weight layout follow the reference
    convention: charge-independent, then charge-dependent, then
    conf-independent (weighted_terms.cpp:27-52).
    """

    name: str
    pair_terms: Tuple[T.Term, ...]
    pair_weights: Tuple[float, ...]
    conf_terms: Tuple[T.ConfIndependent, ...]
    conf_weights: Tuple[float, ...]
    table: AtomTypeTable = DEFAULT_TABLE

    @property
    def cutoff(self) -> float:
        return max([t.cutoff for t in self.pair_terms], default=0.0)

    @property
    def has_charge_terms(self) -> bool:
        return any(t.charge_dependent for t in self.pair_terms)

    def eval_pair(self, pa, pb, r, qa=None, qb=None):
        """Weighted sum of all pairwise terms at distance r (broadcasts).

        Does NOT apply the cutoff — callers mask with r^2 < cutoff^2 the same
        way model::eval* do in the reference.
        """
        acc = 0.0
        for t, w in zip(self.pair_terms, self.pair_weights):
            acc = acc + w * t.eval(pa, pb, r, qa=qa, qb=qb)
        return acc

    def conf_independent(self, inputs, e):
        """Apply conf-independent post-processing terms in sequence (float32
        numpy).

        inputs: dict with num_tors, num_heavy_atoms, num_hydrophobic_atoms,
        ligand_lengths_sum, num_ligands (scalars or batched arrays).
        """
        x = np.asarray(e, np.float32)
        inputs = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
        for t, w in zip(self.conf_terms, self.conf_weights):
            x = np.asarray(t.eval(inputs, x, w), np.float32)
        return x


def build_scoring_function(name: str, term_descriptions: Sequence[Tuple[str, float]],
                           table: AtomTypeTable = DEFAULT_TABLE) -> ScoringFunction:
    """Build a ScoringFunction from (description, weight) pairs.

    Enforces the reference's required ordering (usable terms, then
    conf-independent) by partitioning while preserving relative order.
    """
    pair_terms, pair_weights = [], []
    conf_terms, conf_weights = [], []
    for desc, w in term_descriptions:
        t = T.parse_term(desc, table)
        if t is None:
            raise ValueError(f"unrecognized term description: {desc!r}")
        if isinstance(t, T.ConfIndependent):
            conf_terms.append(t)
            conf_weights.append(float(w))
        else:
            pair_terms.append(t)
            pair_weights.append(float(w))
    # charge-independent terms must precede charge-dependent ones in the
    # weight vector (reference: weighted_terms.cpp:27-52); order within each
    # class is preserved.
    order = np.argsort([t.charge_dependent for t in pair_terms], kind="stable")
    pair_terms = [pair_terms[i] for i in order]
    pair_weights = [pair_weights[i] for i in order]
    return ScoringFunction(
        name=name,
        pair_terms=tuple(pair_terms),
        pair_weights=tuple(pair_weights),
        conf_terms=tuple(conf_terms),
        conf_weights=tuple(conf_weights),
        table=table,
    )


def curl(e, v):
    """Soft positive-energy capping: e -> v*e/(v+e) for e>0 (curl.h:37-42).

    Differentiable almost everywhere; the derivative through this expression
    equals the reference's deriv *= (v/(v+e))^2 scaling.  v is a python
    float or a tensor broadcasting against e.
    """
    # The reference skips curl entirely for v >= 0.1*max_fl ("not_max").
    v = torch.as_tensor(v, dtype=e.dtype, device=e.device)
    not_max = v < 0.1 * float(np.finfo(np.float32).max)
    tmp = v / torch.clamp(v + torch.clamp(e, min=0.0), min=T.EPSILON_FL)
    tmp = torch.where(v < T.EPSILON_FL, 0.0, tmp)
    do_cap = (e > 0.0) & not_max
    return torch.where(do_cap, e * tmp, e)
