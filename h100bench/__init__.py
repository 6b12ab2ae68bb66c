"""The benchmark of tikejax_torch on one NVIDIA H100: see ``run.py``."""
