"""Device operators: quaternions, FK, energy, fused kernels, MC."""
