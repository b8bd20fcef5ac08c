"""The benchmark of the PyTorch/CUDA port ``fl_slam_tpu_torch`` on one H100.

``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything a
cell needs is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<name>.json``) and traffic
(``traffic/<name>.json``); the traffic names its generator
(``traffic/<kind>.py``) and the drive that runs the window
(``drives/<kind>.py``); ``BENCHMARK.json`` names the metrics of each cell,
and each per-layer metric is read by ``metrics/<name>.py``.
"""
