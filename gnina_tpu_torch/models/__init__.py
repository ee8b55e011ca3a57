"""CNN scoring: model registry, op-list runtime and the ensemble scorer."""
