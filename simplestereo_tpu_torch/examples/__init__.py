"""
examples
========

The JAX package's ``examples/`` scripts on the port's API: the same file
names, command lines and output files, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch paths). Run one from the
root of the checkout, e.g.::

    PYTHONPATH=. python3 simplestereo_tpu_torch/examples/202_streaming_pipeline.py

Scripts that read the reference's resources keep the JAX scripts'
defaults (``_cli.REFERENCE_RES``); those files are not part of the
repository. ``201_multichip_tiled_matching.py`` waits for the
port's ``parallel`` package.
"""
