"""The plain reference of the benchmark's check: ``gcslam`` is a frozen
copy of the port's plain path (no kernel, no custom op, nothing of the
program imported) and ``replay`` drives it over the benchmark's own
inputs."""
