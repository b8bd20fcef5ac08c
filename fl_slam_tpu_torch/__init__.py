"""fl_slam_tpu_torch: the PyTorch + CUDA port of the GC-SLAM engine.

The JAX package ``fl_slam_tpu`` is the reference; this package imports
torch and numpy and nothing of JAX or of ``fl_slam_tpu``. The ported slice
is the chunked ``replay`` under ``GCConfig.tpu(belief_kernel=False)``: the
XLA belief branch as plain torch, and the three TPU kernels on that path as
hand-written CUDA for Hopper (``csrc/``): K3 Sinkhorn, K4 moment segment-sum
and K5 conditional slab exchange. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
