"""Workloads that drive the port's whole composition at real shapes, the
counterparts of the JAX package's scripts/: `flagship_workload` (the
reference's full experiment) and `scale_check` (larger scenes and band
counts).  Each runs as `python -m lbdrn_msic_tpu_torch.scripts.<name>` on a
CUDA card, or on the CPU with `--device cpu`."""
