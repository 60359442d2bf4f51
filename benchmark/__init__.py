"""The benchmark of spray_tpu_torch on the card: `python benchmark/run.py`."""
