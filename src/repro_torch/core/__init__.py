"""SubTrack++ optimizer: planning, Grassmann geometry, low-rank Adam and
the tree-level transform (counterpart of ``repro.core``)."""
