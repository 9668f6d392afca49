"""The benchmark of the PyTorch port (``msid_tpu_torch``) on one H100.

``BENCHMARK.json`` at the repository's root names the cells; ``run.py`` runs
one; ``registry.py`` says where a cell's files are. ``reference/`` is the
plain reference that decides ``correct`` and imports nothing of the port.
"""
