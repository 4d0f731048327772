"""dcd_isaac_tpu: an accelerator-native Dual Curriculum Design (UED) framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
dcd codebase (PAIRED, Minimax, DR, PLR, Robust PLR, REPAIRED, ACCEL, ALP-GMM
over MultiGrid / BipedalWalker / CarRacing).  See SURVEY.md at the repo root.
"""

__version__ = '0.1.0'
