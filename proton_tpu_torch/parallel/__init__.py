"""Multi-process solves on torch.distributed (JAX counterpart:
proton_tpu/parallel/): the cell-sharded global system (sharding.py) and
the row-halo face-grid solve (halo.py)."""
