"""Workloads and studies that drive the port's whole composition, the
counterparts of the JAX package's bench.py and scripts/: `bench` (the
headline benchmark's JSON line), `flagship_workload` (the reference's full
experiment), `scale_check` (larger scenes and band counts), the
validation studies `rd_validation`, `substitute_anchors`, `recipe_study`
and `ablations` (what they share is in `suite`), the runner of them all
`repro_all`, and `make_goldens` / `make_sample`.  Each runs as `python -m
lbdrn_msic_tpu_torch.scripts.<name>` on a CUDA card, or on the CPU with
`--device cpu`."""
