"""Multi-GPU and multi-process scale-out: device meshes, the process group."""
