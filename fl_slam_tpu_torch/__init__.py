"""fl_slam_tpu_torch: the PyTorch + CUDA port of the GC-SLAM engine.

The JAX package ``fl_slam_tpu`` is the reference; this package imports
torch and numpy and nothing of JAX or of ``fl_slam_tpu``. The ported main
path is the chunked ``replay`` under ``GCConfig.tpu()``, with the five TPU
kernels on that path as hand-written CUDA for Hopper (``csrc/``): K1
predict + evidence and K2 the scalar belief tail (the K=1 belief chain),
K3 Sinkhorn, K4 moment segment-sum and K5 conditional slab exchange.
``GCConfig.tpu(belief_kernel=False)`` runs the belief chain op by op
instead. Entry points run on the CUDA device unless the caller passes
``device="cpu"``, where each kernel's plain version runs.
"""

__version__ = "0.2.0"
