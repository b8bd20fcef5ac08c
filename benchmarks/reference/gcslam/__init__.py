"""GC-SLAM's per-scan step and chunked replay in plain PyTorch, frozen from
the port's plain path."""
