"""The benchmark of ``repro_torch``, the PyTorch/CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix, per-layer metric, kernel count or model family lives in a
file of its own, found by name (``manifest.py``).  Nothing here imports
``jax`` or the JAX package; the plain reference (``reference/``) imports
nothing of the port either.
"""
