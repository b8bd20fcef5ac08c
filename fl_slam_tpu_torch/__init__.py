"""fl_slam_tpu_torch: the PyTorch + CUDA port of the GC-SLAM engine.

The JAX package ``fl_slam_tpu`` is the reference; this package imports
torch and numpy and nothing of JAX or of ``fl_slam_tpu``. The ported paths
are the chunked ``replay`` under every configuration of the reference
(``GCConfig()``: the bank of K = 4 and the per-slot view; ``small()``;
``tpu()``; real MHT), for one instance or, batched under
``torch.func.vmap``, for many independent instances on one card
(``parallel.replicas``); the evaluation entry points (``eval``); the
``select_kernel`` selection branch; the camera; and the map's render, BEV,
export and checkpoint (``render``, ``checkpoint``).
Every TPU kernel of the JAX package has a hand-written CUDA counterpart for
Hopper (``csrc/``): K1 predict + evidence and K2 the scalar belief tail
(the K=1 belief chain), K3 Sinkhorn, K4 moment segment-sum, K5 conditional
slab exchange, K6 the page gather / write-back of the dense-page insert,
their instance-batched launches (K7), K8 the splat compositing of the
tiled render, K9 the fused candidate selection, and K10, the row-major
exchange beside K5. ``GCConfig.tpu(belief_kernel=False)`` runs the belief
chain op by op instead. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where each kernel's plain version runs.
"""

__version__ = "0.4.0"
