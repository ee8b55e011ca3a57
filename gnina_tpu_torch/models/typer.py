"""CNN atom-channel typing: FileMappedGninaTyper equivalent.

Maps smina atom types to CNN grid channels from a text map (one channel per
line, multiple smina type names share a channel).  Default rec/lig maps
reproduce gninasrc/lib/torch_model.cpp:16-46.
"""

from __future__ import annotations

import numpy as np

from gnina_tpu_torch.constants import DEFAULT_TABLE, NUM_TYPES

DEFAULT_RECMAP = """AliphaticCarbonXSHydrophobe
AliphaticCarbonXSNonHydrophobe
AromaticCarbonXSHydrophobe
AromaticCarbonXSNonHydrophobe
Bromine Iodine Chlorine Fluorine
Nitrogen NitrogenXSAcceptor
NitrogenXSDonor NitrogenXSDonorAcceptor
Oxygen OxygenXSAcceptor
OxygenXSDonorAcceptor OxygenXSDonor
Sulfur SulfurAcceptor
Phosphorus
Calcium
Zinc
GenericMetal Boron Manganese Magnesium Iron
"""

DEFAULT_LIGMAP = """AliphaticCarbonXSHydrophobe
AliphaticCarbonXSNonHydrophobe
AromaticCarbonXSHydrophobe
AromaticCarbonXSNonHydrophobe
Bromine Iodine
Chlorine
Fluorine
Nitrogen NitrogenXSAcceptor
NitrogenXSDonor NitrogenXSDonorAcceptor
Oxygen OxygenXSAcceptor
OxygenXSDonorAcceptor OxygenXSDonor
Sulfur SulfurAcceptor
Phosphorus
GenericMetal Boron Manganese Magnesium Zinc Calcium Iron
"""

_NAME_TO_ID = {name: i for i, name in enumerate(DEFAULT_TABLE.smina_names)}


class ChannelTyper:
    """smina type id -> channel index (-1 = not gridded)."""

    def __init__(self, map_text: str):
        table = np.full(NUM_TYPES, -1, np.int32)
        nchan = 0
        channel_names = []
        for line in map_text.strip().splitlines():
            names = line.split()
            if not names:
                continue
            for n in names:
                if n not in _NAME_TO_ID:
                    raise ValueError(f"unknown smina type in map: {n!r}")
                table[_NAME_TO_ID[n]] = nchan
            channel_names.append(names[0])
            nchan += 1
        self.table = table
        self.num_channels = nchan
        # per-channel display name = first type on the map line (libmolgrid
        # FileMappedGninaTyper get_type_names; gninagrid dx/map filenames)
        self.channel_names = channel_names
        # per-type radius used for gridding (xs radius, default table)
        self.radii = DEFAULT_TABLE.xs_radius.copy()

    def channels_for(self, types: np.ndarray) -> np.ndarray:
        return self.table[np.asarray(types)]

    def radii_for(self, types: np.ndarray) -> np.ndarray:
        return self.radii[np.asarray(types)]


def default_rec_typer() -> ChannelTyper:
    return ChannelTyper(DEFAULT_RECMAP)


def default_lig_typer() -> ChannelTyper:
    return ChannelTyper(DEFAULT_LIGMAP)
