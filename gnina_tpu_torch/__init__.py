"""gnina_tpu_torch: the PyTorch/CUDA port of gnina_tpu for one NVIDIA H100.

A second package beside the JAX one.  It imports torch and numpy, never
jax and never gnina_tpu, and does all that the JAX package does: the
fused docking route, `DockingEngine.dock_batch`, in every search setting,
whose kernels (the
fused value+gradient, truncated BFGS in both line-search modes, the async
and lockstep in-kernel Monte Carlo, and the done_frac group stop) are
hand-written CUDA for sm_90a in csrc/fused_dock.cu, built on first CUDA
use; the CNN rescore (models/, ops/voxelize.py), whose convolutions and
matrix products are library calls as in the JAX package; the command line
(`python -m gnina_tpu_torch`, cli.py) with score_only, minimize (ops/bfgs.py),
randomize and the screen, and its writers (output.py,
scoring/atom_terms.py); the rate probes (probes.py, csrc/probes.cu); and
the tools (tools/: gninagrid, gninatyper, gninavis, tognina, fromgnina
with chem/molcache.py, the minimisation server and its client) with
TorchScript import for --cnn_model (models/torchscript_import.py) and for
built-in names (models/registry.py); multi-GPU docking over a device mesh
and multi-process screens (parallel/); CNN training (models/train.py); and
host bond perception in C++ (native/, built with g++ on first use).

Float32 matmuls and convolutions run in full float32: TF32 is switched off
here, at the package's entry, because the pose math (FK origins, RMSD Gram
matrices) loses ~0.06 A at TF32/bf16 input precision and the CNN scores
must match the reference to three decimals.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
