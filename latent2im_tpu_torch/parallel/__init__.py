"""Data and spatial parallelism over torch.distributed (parallel/mesh.py,
parallel/spatial.py), the launcher that starts one process per rank
(parallel/launch.py) and the multi-rank dry run (parallel/dryrun.py)."""
