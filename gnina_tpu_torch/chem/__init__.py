"""Host chemistry: parsers, typing, torsion trees (numpy)."""
