"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

`run.py` runs one cell (`workloads/<cell>.json`) of a configuration
(`configs/<config>.json`) under a traffic mix (`traffic/<mix>.json`)
with its driver (`drivers/<driver>.py`), checks what the timed path
produced against a plain float32 reference (`reference/<family>.py`) and
prints one JSON line.  Nothing here imports JAX or the JAX package.
"""
