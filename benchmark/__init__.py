"""The benchmark of proton_tpu_torch: ``python3 benchmark/run.py``."""
